"""Streaming (chunked, carried-state) decode through the STK-network
decoder, incl. live KWS — the StkInterface::ProcessFrame semantics
(stkinterface.cpp:214-289): per-frame network steps with fixed-lag word
emission in decode mode and LRTrace candidate streaming in KWS mode.

Runs on a seeded stkint package (phnrec_tpu.synth) at the CZ package's
widths with a small hidden layer and no sentence norm.
"""

import numpy as np
import pytest

from tests.conftest import seeded_audio, seeded_package
from phnrec_tpu.live import run_live
from phnrec_tpu.pipeline import SpeechRec
from phnrec_tpu.streaming import StreamingRecognizer


def _stkint_package(tmp_path, extra_cfg="", decoder="stkint"):
    return seeded_package(tmp_path / "pkg", decoder=decoder,
                          extra_cfg=extra_cfg)


@pytest.fixture(scope="module")
def wave_bytes():
    return seeded_audio(3.0)


def test_streaming_stkint_matches_offline(tmp_path, wave_bytes):
    pkg = _stkint_package(tmp_path)
    sr = SpeechRec(pkg)
    assert sr.stk_decoder is not None

    # offline: whole utterance through the batch decode path
    from phnrec_tpu.io import audio
    par = sr.params_from_waveform(wave_bytes)
    post = sr.posteriors_from_params(par)
    import jax.numpy as jnp
    want = sr.stk_decoder.decode(np.asarray(sr.dec_soft(jnp.asarray(post))))

    rec = StreamingRecognizer(sr)
    for s in range(0, len(wave_bytes), 3001):
        rec.process(wave_bytes[s : s + 3001])
    got = rec.finish()
    assert [(l.start_frames, l.end_frames, l.name) for l in got] == \
        [(w.start_frames, w.end_frames, w.name) for w in want]

    # fixed-lag partials are a prefix of the final labels
    rec2 = StreamingRecognizer(sr)
    rec2.process(wave_bytes)
    part = rec2.results(settled_only=True)
    names = [(l.start_frames, l.end_frames, l.name) for l in got]
    assert [(l.start_frames, l.end_frames, l.name) for l in part] == \
        names[: len(part)]


def test_streaming_stkint_delayed_input_xform(tmp_path, wave_bytes):
    """A model set with a DELAYED global <InputXform> (stacking node):
    the streaming path must carry the delay lines across chunks
    (UpdateStacks per ViterbiStep, Viterbi.cc:2068) and equal the
    whole-utterance offline decode."""
    import jax.numpy as jnp

    from phnrec_tpu.io.xform import Xform, XformInstance

    pkg = _stkint_package(tmp_path)
    sr = SpeechRec(pkg)
    par = sr.params_from_waveform(wave_bytes)
    post = sr.posteriors_from_params(par)
    D = post.shape[1]   # decoder observation width (NN outputs)
    # mix 0.8*current + 0.2*previous frame: stacking 2 (oldest first)
    # followed by a [D, 2D] linear
    M = np.concatenate([0.2 * np.eye(D), 0.8 * np.eye(D)],
                       axis=1).astype(np.float32)
    base = XformInstance("s", Xform("stacking", D, 2 * D, delay=1,
                                    stack_size=2), out_size=2 * D)
    top = XformInstance("t", Xform("linear", 2 * D, D, matrix=M),
                        input=base, out_size=D)
    sr.stk_decoder.model_set.input_xform = top
    want = sr.stk_decoder.decode(np.asarray(sr.dec_soft(jnp.asarray(post))))
    assert want

    rec = StreamingRecognizer(sr, block_frames=32)
    assert rec._stk_xform is not None
    for s in range(0, len(wave_bytes), 3001):
        rec.process(wave_bytes[s : s + 3001])
    got = rec.finish()
    assert [(l.start_frames, l.end_frames, l.name) for l in got] == \
        [(w.start_frames, w.end_frames, w.name) for w in want]


def test_streaming_stkint_commit_bounds_memory(tmp_path, wave_bytes):
    """Long-session fixed-lag commit: with a small horizon the recognizer
    must repeatedly commit the settled prefix and DROP its record rows
    (the reference's TimePruning ring, Viterbi.cc:65-125) while still
    producing the offline decode's labels."""
    import jax.numpy as jnp

    pkg = _stkint_package(tmp_path)
    sr = SpeechRec(pkg)
    par = sr.params_from_waveform(wave_bytes)
    post = sr.posteriors_from_params(par)
    want = sr.stk_decoder.decode(
        np.asarray(sr.dec_soft(jnp.asarray(post))))

    rec = StreamingRecognizer(sr, block_frames=32)
    rec._stk_horizon = 64          # force frequent commits
    for s in range(0, len(wave_bytes), 4096):
        rec.process(wave_bytes[s : s + 4096])
        rec.results(settled_only=True)       # live-style polling
        if rec._stk_tail is not None:
            # retained window stays bounded (horizon + in-flight blocks)
            assert rec._stk_tail["in_am"].shape[0] <= 64 + 3 * 32
    got = rec.finish()
    assert rec._stk_frame0 > 0, "no commit ever happened"
    assert len(rec._stk_committed) > 0
    assert [(l.start_frames, l.end_frames, l.name) for l in got] == \
        [(w.start_frames, w.end_frames, w.name) for w in want]
    np.testing.assert_allclose([l.score for l in got],
                               [w.score for w in want], atol=5e-3)


def test_live_kws_matches_offline(tmp_path, wave_bytes):
    """Live-mode KWS chunks must yield the same hits as offline
    kws_scan."""
    pkg = _stkint_package(tmp_path, decoder="kws")
    sr = SpeechRec(pkg)
    assert sr.stk_decoder is not None and sr.stk_decoder.mode == "kws"

    # offline hits
    par = sr.params_from_waveform(wave_bytes)
    post = sr.posteriors_from_params(par)
    import jax.numpy as jnp
    want = sr.stk_decoder.decode(np.asarray(sr.dec_soft(jnp.asarray(post))))
    assert want, "offline KWS produced no candidates"

    # live replay through run_live (chunked)
    srcf = tmp_path / "live.raw"
    srcf.write_bytes(wave_bytes)
    out = []
    got = run_live(sr, out_format="lab", source=str(srcf), emit=out.append)
    key = lambda ls: sorted(  # noqa: E731
        (l.start_frames, l.end_frames, l.name, l.score) for l in ls)
    g, w = key(got), key(want)
    assert [x[:3] for x in g] == [x[:3] for x in w]
    # scores match to chunked-vs-whole f32 summation noise
    np.testing.assert_allclose([x[3] for x in g], [x[3] for x in w],
                               atol=5e-3)
