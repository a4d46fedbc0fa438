"""Live recognition frontend (run_live, reference RunLive srec.cpp:1438-1490
+ live_callback output formats phnrec.cpp:71-110)."""

import numpy as np
import pytest

from tests.conftest import seeded_audio, seeded_package
from phnrec_tpu.io.labels import Label
from phnrec_tpu.live import format_live, run_live
from phnrec_tpu.pipeline import SpeechRec


def test_format_live_variants():
    lab = Label(69, 75, "spk", -71.17)
    assert format_live(lab, "str") == " spk"
    assert format_live(lab, "strlen") == " spk(7)"
    assert format_live(lab, "lab").startswith("6900000 7500000 spk")
    with pytest.raises(ValueError):
        format_live(lab, "bogus")


def test_run_live_file_replay(tmp_path):
    """Replay a raw file through the live path; the emitted stream must
    equal the final labels, and those must equal the offline decode.
    Uses a seeded package without sentence norm, so the online and
    offline paths are comparable (with sent_mean_norm the reference's two
    paths legitimately differ: online norm vs sentence norm,
    srec.cpp:793-849 vs 1492-1592)."""
    raw = seeded_audio(3.0)
    src = tmp_path / "live.raw"
    src.write_bytes(raw)
    sr = SpeechRec(seeded_package(tmp_path / "pkg"))
    out = []
    labels = run_live(sr, out_format="str", source=str(src),
                      emit=out.append)
    assert labels, "live decode produced no labels"
    text = "".join(out).split()
    names = [l.name for l in labels]
    # emitted stream matches the returned labels
    assert text == names

    from phnrec_tpu.io import audio
    res = sr.process_offline(
        "wf", "str", audio.load_waveform_bytes(str(src)))
    offline = [l.name for l in res.labels]
    assert names == offline


def test_threaded_capture_ring():
    """Capture thread + ring (LWFSource semantics): bytes arrive intact
    and in order through the cond-var handoff; a pipe source streams."""
    import os as _os
    import threading
    import time

    from phnrec_tpu.live import ThreadedCapture

    rfd, wfd = _os.pipe()
    payload = bytes(range(256)) * 40          # 10240 bytes

    def writer():
        with _os.fdopen(wfd, "wb") as w:
            for i in range(0, len(payload), 800):
                w.write(payload[i : i + 800])
                w.flush()
                time.sleep(0.002)

    t = threading.Thread(target=writer)
    t.start()
    cap = ThreadedCapture(_os.fdopen(rfd, "rb"), bytes_per_second=16000)
    got = b""
    while True:
        b = cap.read(1000)
        if not b:
            break
        got += b
    t.join()
    assert got == payload


def test_threaded_capture_overflow_stops_recording():
    """Reference quirk kept: when the ring cannot fit another frame the
    capture thread stops permanently (lwfsource.cpp:160-176); buffered
    bytes still drain."""
    import io
    import time

    from phnrec_tpu.live import ThreadedCapture

    class Endless:
        def read(self, n):
            return b"x" * n

    cap = ThreadedCapture(Endless(), bytes_per_second=1000)
    # 2 s ring at 1000 B/s = 2000 bytes capacity; let it fill + stop
    time.sleep(0.2)
    got = b""
    while True:
        b = cap.read(500)
        if not b:
            break
        got += b
    assert len(got) <= cap.capacity
    assert len(got) >= cap.capacity - cap.frame_len


def test_run_live_pipe_is_lossless(tmp_path):
    """Pipes/stdin read directly (backpressure, no ring): a faster-than-
    realtime pipe must not be truncated by the device ring's
    stop-on-overflow semantics."""
    import os as _os
    import threading

    from phnrec_tpu.live import run_live
    from phnrec_tpu.pipeline import SpeechRec

    raw = seeded_audio(3.0)
    rfd, wfd = _os.pipe()

    def writer():
        with _os.fdopen(wfd, "wb") as w:
            w.write(raw)    # all at once — way faster than realtime

    t = threading.Thread(target=writer)
    t.start()
    sr = SpeechRec(seeded_package(tmp_path / "pkg"))
    # replay the same bytes through a file for the expected labels
    f = tmp_path / "ref.raw"
    f.write_bytes(raw)
    want = run_live(sr, out_format="str", source=str(f), emit=lambda s: None)
    stream = _os.fdopen(rfd, "rb")
    import phnrec_tpu.live as live_mod
    import sys as _sys
    old = _sys.stdin
    try:
        class FakeStdin:
            buffer = stream
        _sys.stdin = FakeStdin()
        got = run_live(sr, out_format="str", source="-",
                       emit=lambda s: None)
    finally:
        _sys.stdin = old
        t.join()
    assert [l.name for l in got] == [l.name for l in want]
