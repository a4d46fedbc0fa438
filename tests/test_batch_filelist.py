"""File-list processing through the bucketed batch pipeline must produce
the serial per-file path's outputs (reference loop: ProcessFileList,
srec.cpp:1246-1291), for lin16 and alaw corpora, MLF and per-file .rec
targets, including sub-frame-length files (MB_VECTORSIZE zero-pad,
srec.cpp:731-740)."""

import os

import numpy as np
import pytest

from phnrec_tpu.io.labels import MLFWriter, read_mlf, read_rec
from phnrec_tpu.pipeline import SpeechRec

from conftest import seeded_audio, seeded_package, small_spec


def _cz_package(tmp_path, fmt: str = "lin16"):
    """A seeded package at the CZ widths (small hidden layer) with the CZ
    package's sentence mean norm; ``fmt`` sets source/format."""
    pkg = seeded_package(tmp_path / f"pkg_{fmt}",
                         spec=small_spec(sent_mean_norm=True))
    cfg = os.path.join(pkg, "config")
    text = open(cfg).read().replace("format=lin16", f"format={fmt}")
    open(cfg, "w").write(text)
    return pkg


def _mk_corpus(tmp_path, fmt: str):
    """Mixed-length corpus; alaw content is arbitrary bytes (both paths
    decode the SAME bytes, which is what the equivalence tests)."""
    rng = np.random.default_rng(7)
    src = np.frombuffer(seeded_audio(4.0), np.int16)
    durations = [1.0, 7.49, 0.4, 2.2, 0.015, 0.6]   # incl. sub-frame
    paths = []
    for i, d in enumerate(durations):
        n = int(d * 8000)
        p = tmp_path / f"u{i}.{fmt}"
        if fmt == "lin16":
            reps = -(-n // len(src))
            sig = np.tile(src, reps)[:n]
            p.write_bytes(sig.astype("<i2").tobytes())
        else:
            p.write_bytes(rng.integers(0, 256, n, np.uint8).tobytes())
        paths.append(str(p))
    return paths


def _serial_mlf(sr, paths, mlf_path):
    with MLFWriter(mlf_path) as mlf:
        for p in paths:
            target = sr.compose_target_name(p, "str", for_mlf=True)
            sr.process_file("wf", "str", p, target, mlf)


@pytest.mark.parametrize("fmt", ["lin16", "alaw"])
def test_batched_filelist_matches_serial_mlf(tmp_path, fmt):
    sr = SpeechRec(_cz_package(tmp_path, fmt))
    assert sr._can_batch_list("wf", "str")
    paths = _mk_corpus(tmp_path, fmt)
    lst = tmp_path / "list"
    lst.write_text("\n".join(paths) + "\n")

    _serial_mlf(sr, paths, str(tmp_path / "serial.mlf"))
    sr.process_file_list("wf", "str", str(lst),
                         mlf_path=str(tmp_path / "batched.mlf"))

    want = read_mlf(str(tmp_path / "serial.mlf"))
    got = read_mlf(str(tmp_path / "batched.mlf"))
    assert list(got) == list(want), "MLF entry order must be list order"
    for name in want:
        w, g = want[name], got[name]
        assert [(l.start_frames, l.end_frames, l.name) for l in g] == \
            [(l.start_frames, l.end_frames, l.name) for l in w], name
        np.testing.assert_allclose([l.score for l in g],
                                   [l.score for l in w], atol=1e-2)


def test_batched_filelist_rec_files(tmp_path):
    sr = SpeechRec(_cz_package(tmp_path))
    paths = _mk_corpus(tmp_path, "lin16")
    lst = tmp_path / "list"
    lst.write_text("\n".join(paths) + "\n")
    sr.process_file_list("wf", "str", str(lst))
    for p in paths:
        rec = os.path.splitext(p)[0] + ".rec"
        assert os.path.exists(rec)
        serial = sr.process_offline("wf", "str",
                                    open(p, "rb").read()).labels
        got = read_rec(rec)
        assert [(l.start_frames, l.end_frames, l.name) for l in got] == \
            [(l.start_frames, l.end_frames, l.name) for l in serial]


def test_stkint_list_batched_matches_serial(tmp_path, monkeypatch):
    """stkint wf->str lists route through the batched posterior stack +
    NetworkDecoder.decode_batch; the MLF must be
    byte-for-byte the serial per-file loop's."""
    from tests.test_stk_streaming import _stkint_package

    pkg = _stkint_package(tmp_path)
    sr = SpeechRec(pkg)
    assert sr.stk_decoder is not None and sr._can_batch_list("wf", "str")
    paths = _mk_corpus(tmp_path, "lin16")
    lst = tmp_path / "list"
    lst.write_text("\n".join(paths) + "\n")
    sr.process_file_list("wf", "str", str(lst),
                         mlf_path=str(tmp_path / "batched.mlf"))
    monkeypatch.setattr(SpeechRec, "_can_batch_list",
                        lambda self, i, o: False)
    sr.process_file_list("wf", "str", str(lst),
                         mlf_path=str(tmp_path / "serial.mlf"))
    assert (tmp_path / "batched.mlf").read_bytes() == \
        (tmp_path / "serial.mlf").read_bytes()


def test_serial_stages_bucket_compiles(tmp_path):
    """The serial per-file stages pad T to a 256-frame quantum: many
    distinct utterance lengths inside one bucket share ONE compiled
    program per stage (no per-length recompiles)."""
    sr = SpeechRec(_cz_package(tmp_path))
    src = np.frombuffer(seeded_audio(3.0), dtype="<i2")
    before = (SpeechRec._wave2par._cache_size(),
              SpeechRec._par2post._cache_size(),
              SpeechRec._post2segs._cache_size())
    for n in (4000, 4801, 5602, 7003, 9000, 12345, 15999, 20000):
        raw = src[:n].astype("<i2").tobytes()
        sr.process_offline("wf", "str", raw)
    after = (SpeechRec._wave2par._cache_size(),
             SpeechRec._par2post._cache_size(),
             SpeechRec._post2segs._cache_size())
    # lengths span 50..250 frames -> ONE bucket (256) per stage
    assert all(a - b <= 1 for a, b in zip(after, before)), (before, after)
