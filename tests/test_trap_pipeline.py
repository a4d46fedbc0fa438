"""Non-LCRC posterior systems through the FULL pipeline: a synthetic 1BT
model package (band nets + merger written as .nbin, generated config +
phoneme list) drives SpeechRec offline decode, the batch pipeline, and
chunked streaming — all three must agree.  Proves pipeline.py's system
dispatch, the estimator file loaders, posteriors_batched, and the
streaming trap block fn end to end, not just the estimator unit."""

import os

import numpy as np
import pytest

from phnrec_tpu.io.weights import MLPParams, save_nbin

from conftest import seeded_audio

TRAP_LEN = 31
NBANKS = 5
PHONEMES = ["aa", "bb", "cc"]           # +1 implicit garbage class
N_OUT = (len(PHONEMES) + 1) * 3


def _net(seed, n_inp, n_hid, n_out):
    rng = np.random.default_rng(seed)
    return MLPParams(
        w1=rng.standard_normal((n_hid, n_inp)).astype(np.float32) * 0.3,
        b1=rng.standard_normal(n_hid).astype(np.float32) * 0.1,
        w2=rng.standard_normal((n_out, n_hid)).astype(np.float32) * 0.3,
        b2=rng.standard_normal(n_out).astype(np.float32) * 0.1,
        mean=rng.standard_normal(n_inp).astype(np.float32),
        dev=(rng.random(n_inp).astype(np.float32) + 0.5))


CONFIG = f"""\
[source]
sample_freq=8000
[melbanks]
nbanks={NBANKS}
lower_freq=64
higher_freq=4000
vector_size=200
vector_step=80
[posteriors]
enabled=true
system=1BT
length={TRAP_LEN}
hamming=true
add_c0=false
softening_func=none 0 0 0
[decoder]
type=phndec
num_states_per_phn=3
wpenalty=-2.0
time_pruning=40
softening_func=log 0 0 0
[dicts]
phoneme_list=$C/phonemes
"""


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    root = tmp_path_factory.mktemp("pkg_1bt")
    (root / "weights").mkdir()
    (root / "norms").mkdir()
    (root / "config").write_text(CONFIG)
    (root / "phonemes").write_text("".join(p + "\n" for p in PHONEMES))
    n_band_out = 6
    for i in range(NBANKS):
        save_nbin(str(root / "weights" / f"band{i}.nbin"),
                  _net(10 + i, TRAP_LEN, 8, n_band_out))
    save_nbin(str(root / "weights" / "merger.nbin"),
              _net(99, NBANKS * n_band_out, 16, N_OUT))
    return str(root)


@pytest.fixture(scope="module")
def wave_bytes():
    return seeded_audio(4.0)


def test_offline_batch_streaming_agree(pkg, wave_bytes):
    from phnrec_tpu.parallel.batch import BatchPipeline
    from phnrec_tpu.pipeline import SpeechRec
    from phnrec_tpu.streaming import StreamingRecognizer
    from phnrec_tpu.io.audio import convert_waveform

    sr = SpeechRec(pkg)
    from phnrec_tpu.posteriors.estimator import TrapsEstimator
    assert isinstance(sr.estimator, TrapsEstimator)

    offline = sr.process_offline("wf", "str", wave_bytes).labels
    assert offline, "synthetic 1BT package decoded nothing"
    key = [(l.start_frames, l.end_frames, l.name) for l in offline]

    # batch pipeline (posteriors_batched vmap path), 2 identical rows
    bp = BatchPipeline(sr)
    wave, _ = convert_waveform(wave_bytes, "lin16")
    res = bp.run([wave, wave])
    for b in range(2):
        assert [(l.start_frames, l.end_frames, l.name)
                for l in res.labels[b]] == key

    # chunked streaming (generic trap block fn + carried Viterbi)
    rec = StreamingRecognizer(sr, block_frames=64)
    for s in range(0, len(wave_bytes), 3001):
        rec.process(wave_bytes[s : s + 3001])
    got = rec.finish()
    assert [(l.start_frames, l.end_frames, l.name) for l in got] == key


def test_multistream_on_1bt_package(pkg, wave_bytes):
    """The multi-stream server works for non-LCRC trap systems too (the
    generic trap block fn feeds the same fused dispatch)."""
    from phnrec_tpu.multistream import MultiStreamRecognizer
    from phnrec_tpu.pipeline import SpeechRec

    sr = SpeechRec(pkg)
    offline = sr.process_offline("wf", "str", wave_bytes).labels
    key = [(l.start_frames, l.end_frames, l.name) for l in offline]

    ms = MultiStreamRecognizer(sr, n_streams=3, block_frames=64)
    for i in range(3):
        ms.process(i, wave_bytes)
    got = ms.finish()
    for i in range(3):
        assert [(l.start_frames, l.end_frames, l.name)
                for l in got[i]] == key, f"stream {i}"
