"""Device-carried online normalization in multi-stream serving: each
stream's running mean/var estimation (accumulate estim_interval frames,
freeze, apply — norm.cpp:92-234) rides in the fused dispatch carry and
must reproduce the single-stream StreamingRecognizer (whose estimator is
the host state machine) label-for-label."""

import numpy as np
import pytest

from phnrec_tpu.multistream import MultiStreamRecognizer
from phnrec_tpu.pipeline import SpeechRec
from phnrec_tpu.streaming import StreamingRecognizer

from conftest import seeded_audio, seeded_package


def _onorm_package(tmp_path, extra=""):
    return seeded_package(
        tmp_path / "pkg",
        extra_cfg="[onlinenorm]\nestim_interval=50\nmean_norm=true\n"
                  "var_norm=true\n" + extra)


@pytest.fixture(scope="module")
def raw_bytes():
    return seeded_audio(3.0)


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def _single(sr, stream, block=32):
    rec = StreamingRecognizer(sr, block_frames=block)
    rec.process(stream)
    return rec.finish()


def test_multistream_online_norm_matches_single(tmp_path, raw_bytes):
    sr = SpeechRec(_onorm_package(tmp_path))
    assert sr.cfg.get_int("onlinenorm", "estim_interval") == 50
    streams = [raw_bytes, raw_bytes[: len(raw_bytes) // 2 // 2 * 2],
               raw_bytes[2 * 1600:]]
    ms = MultiStreamRecognizer(sr, n_streams=3, block_frames=32)
    assert ms.online_norm.enabled and ms._onorm_state
    offsets = [0] * 3
    chunk = 6000
    while any(o < len(s) for o, s in zip(offsets, streams)):
        for i, s in enumerate(streams):
            if offsets[i] < len(s):
                ms.process(i, s[offsets[i] : offsets[i] + chunk])
                offsets[i] += chunk
    for i in range(3):
        ms.end_stream(i)
    got = ms.finish()
    for i, s in enumerate(streams):
        # fresh recognizer per stream: the host estimator is per-instance
        want = _single(SpeechRec(_onorm_package(tmp_path / f"s{i}")), s)
        assert _key(got[i]) == _key(want), f"stream {i} diverged"


def test_multistream_online_norm_device_buffer(tmp_path, raw_bytes):
    """The scanned device-buffer path threads the estimation state
    through the in-scan carry."""
    import jax.numpy as jnp

    sr = SpeechRec(_onorm_package(tmp_path))
    n, block = 2, 32
    spec = sr.frontend.spec
    spb = block * spec.step
    wave = np.frombuffer(raw_bytes, dtype="<i2")
    n_blocks = (wave.shape[0] - (spec.vector_size - spec.step)) // spb
    ms = MultiStreamRecognizer(sr, n_streams=n, block_frames=block)
    dev = jnp.asarray(np.stack([wave] * n))
    ms.decode_device_buffer(dev, n_blocks)
    consumed = n_blocks * spb
    tail = wave[consumed:].tobytes()
    for i in range(n):
        if tail:
            ms.process(i, tail)
    got = ms.finish()
    want = _single(SpeechRec(_onorm_package(tmp_path / "ref")), raw_bytes,
                   block)
    for i in range(n):
        assert _key(got[i]) == _key(want), f"stream {i} diverged"


def test_multistream_online_norm_persists_xml(tmp_path, raw_bytes):
    """finish() persists each stream's frozen estimate to the configured
    XML file, channel id = stream index (norm.cpp:230,309-364)."""
    from phnrec_tpu.io.normfile import load_norm_file

    norm_file = tmp_path / "norms.xml"
    sr = SpeechRec(_onorm_package(tmp_path,
                                  extra=f"file={norm_file}\n"))
    ms = MultiStreamRecognizer(sr, n_streams=2, block_frames=32)
    for i in range(2):
        ms.process(i, raw_bytes)
        ms.end_stream(i)
    ms.finish()
    assert norm_file.exists()
    chans = load_norm_file(str(norm_file))
    nb = sr.frontend.spec.nbanks
    assert set(chans) == {0, 1}
    for ch in chans.values():
        assert ch["mean"].shape == (nb,)
        assert np.all(np.isfinite(ch["inv_std"]))
    # both streams saw the same audio: identical estimates
    np.testing.assert_allclose(chans[0]["mean"], chans[1]["mean"])
