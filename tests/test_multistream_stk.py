"""Multi-stream stkint DECODE-mode serving: N concurrent word-network
streams through one fused dispatch must produce, per stream, exactly the
labels of a single-stream StreamingRecognizer on the same package (the
StkInterface::ProcessFrame decode branch with fixed-lag emission,
stkinterface.cpp:214-238, batched over streams)."""

import numpy as np
import pytest

from phnrec_tpu.multistream import MultiStreamStkDecode
from phnrec_tpu.pipeline import SpeechRec
from phnrec_tpu.streaming import StreamingRecognizer

from tests.conftest import seeded_audio
from tests.test_stk_streaming import _stkint_package


@pytest.fixture(scope="module")
def stk_sr(tmp_path_factory):
    pkg = _stkint_package(tmp_path_factory.mktemp("stkpkg"))
    sr = SpeechRec(pkg)
    assert sr.stk_decoder is not None and sr.stk_decoder.mode == "decode"
    return sr


@pytest.fixture(scope="module")
def raw_bytes():
    return seeded_audio(3.0)


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def _single(sr, stream, block=32):
    rec = StreamingRecognizer(sr, block_frames=block)
    rec.process(stream)
    return rec.finish()


def test_multistream_stk_matches_single(stk_sr, raw_bytes):
    # full, half-length (sample-aligned), and offset streams
    streams = [raw_bytes, raw_bytes[: len(raw_bytes) // 2 // 2 * 2],
               raw_bytes[2 * 1600:]]
    ms = MultiStreamStkDecode(stk_sr, n_streams=3, block_frames=32)
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
        want = _single(stk_sr, s)
        assert _key(got[i]) == _key(want), f"stream {i} diverged"
        np.testing.assert_allclose([l.score for l in got[i]],
                                   [w.score for w in want], atol=5e-3)


def test_multistream_stk_settled_is_prefix(stk_sr, raw_bytes):
    """results(settled_only=True) mid-stream is a prefix of the final
    labels — the fixed-lag emission guarantee (stkinterface.cpp:222-238:
    a settled word cannot be rewritten)."""
    ms = MultiStreamStkDecode(stk_sr, n_streams=2, block_frames=32)
    half = len(raw_bytes) // 2 // 2 * 2
    for i in range(2):
        ms.process(i, raw_bytes[:half])
    part = ms.results(settled_only=True)
    for i in range(2):
        ms.process(i, raw_bytes[half:])
        ms.end_stream(i)
    got = ms.finish()
    for i in range(2):
        final = _key(got[i])
        assert _key(part[i]) == final[: len(part[i])]


def test_multistream_stk_commit_bounds_memory(stk_sr, raw_bytes):
    """With a small record horizon the server must repeatedly commit the
    settled prefix and DROP its record rows (the reference's TimePruning
    ring, Viterbi.cc:65-125) while producing the exact labels."""
    ms = MultiStreamStkDecode(stk_sr, n_streams=2, block_frames=32,
                              record_horizon=64)
    for s in range(0, len(raw_bytes), 4096):
        for i in range(2):
            ms.process(i, raw_bytes[s : s + 4096])
        ms.results(settled_only=True)            # live-style polling
        # retained record rows (device blocks) stay bounded
        assert int((ms._n_dec - ms._row_offset).max()) <= 64 + 3 * 32
    for i in range(2):
        ms.end_stream(i)
    got = ms.finish()
    assert all(len(c) > 0 for c in ms._stk_committed), "no commit happened"
    want = _single(stk_sr, raw_bytes)
    for i in range(2):
        assert _key(got[i]) == _key(want)
        np.testing.assert_allclose([l.score for l in got[i]],
                                   [w.score for w in want], atol=5e-3)


def test_multistream_stk_device_buffer(stk_sr, raw_bytes):
    """decode_device_buffer (the pre-staged HBM scan path) must equal the
    byte-fed path — exercises the record compaction of the scanned
    multi-block dispatch."""
    import jax.numpy as jnp

    n, block = 2, 32
    spec = stk_sr.frontend.spec
    spb = block * spec.step
    wave = np.frombuffer(raw_bytes, dtype="<i2")
    n_blocks = (wave.shape[0] - (spec.vector_size - spec.step)) // spb
    ms = MultiStreamStkDecode(stk_sr, n_streams=n, block_frames=block)
    dev = jnp.asarray(np.stack([wave] * n))
    half = n_blocks // 2
    ms.decode_device_buffer(dev, half)
    for k in range(half, n_blocks):
        ms.dispatch_from_device_buffer(dev, k * spb)
    consumed = n_blocks * spb
    tail = wave[consumed:].tobytes()
    for i in range(n):
        if tail:
            ms.process(i, tail)
    got = ms.finish()
    want = _single(stk_sr, raw_bytes, block)
    for i in range(n):
        assert _key(got[i]) == _key(want), f"stream {i} diverged"


def test_multistream_stk_delayed_input_xform(stk_sr, raw_bytes):
    """A model set with a DELAYED global <InputXform> (stacking node):
    the multi-stream carry must advance each stream's delay lines by its
    valid frames only (UpdateStacks semantics, Viterbi.cc:2068) and
    equal the single-stream StreamingRecognizer."""
    from phnrec_tpu.io.xform import Xform, XformInstance

    D = stk_sr.estimator.merger.n_out
    M = np.concatenate([0.2 * np.eye(D), 0.8 * np.eye(D)],
                       axis=1).astype(np.float32)
    base = XformInstance("s", Xform("stacking", D, 2 * D, delay=1,
                                    stack_size=2), out_size=2 * D)
    top = XformInstance("t", Xform("linear", 2 * D, D, matrix=M),
                        input=base, out_size=D)
    old = stk_sr.stk_decoder.model_set.input_xform
    stk_sr.stk_decoder.model_set.input_xform = top
    try:
        streams = [raw_bytes, raw_bytes[: len(raw_bytes) // 2 // 2 * 2]]
        ms = MultiStreamStkDecode(stk_sr, n_streams=2, block_frames=32)
        assert ms._xform_inst is not None
        for i, s in enumerate(streams):
            ms.process(i, s)
            ms.end_stream(i)
        got = ms.finish()
        for i, s in enumerate(streams):
            want = _single(stk_sr, s)
            assert _key(got[i]) == _key(want), f"stream {i} diverged"
    finally:
        stk_sr.stk_decoder.model_set.input_xform = old


def test_multistream_kws_delayed_input_xform(tmp_path, raw_bytes):
    """MultiStreamKWS with a delayed <InputXform>: per-stream hits must
    equal the single-stream KWS recognizer."""
    from phnrec_tpu.io.xform import Xform, XformInstance
    from phnrec_tpu.multistream import MultiStreamKWS

    sr = SpeechRec(_stkint_package(tmp_path, decoder="kws"))
    D = sr.estimator.merger.n_out
    M = np.concatenate([0.2 * np.eye(D), 0.8 * np.eye(D)],
                       axis=1).astype(np.float32)
    base = XformInstance("s", Xform("stacking", D, 2 * D, delay=1,
                                    stack_size=2), out_size=2 * D)
    top = XformInstance("t", Xform("linear", 2 * D, D, matrix=M),
                        input=base, out_size=D)
    sr.stk_decoder.model_set.input_xform = top

    streams = [raw_bytes, raw_bytes[2 * 1600:]]
    ms = MultiStreamKWS(sr, n_streams=2, block_frames=32)
    assert ms._xform_inst is not None
    for i, s in enumerate(streams):
        ms.process(i, s)
        ms.end_stream(i)
    got = ms.finish()
    any_hits = False
    for i, s in enumerate(streams):
        want = _single(sr, s)
        key = lambda ls: sorted(  # noqa: E731
            (l.start_frames, l.end_frames, l.name) for l in ls)
        assert key(got[i]) == key(want), f"stream {i} diverged"
        any_hits |= bool(want)
    assert any_hits, "fixture produced no KWS hits at all"


def test_multistream_stk_dense_matches_edge_list(stk_sr, raw_bytes,
                                                 monkeypatch):
    """PHNREC_TPU_DENSE_STK=0 forces the vmapped edge-list scan; its
    outputs must equal the dense decode step's (identical records by
    construction — DenseKWSScan.step_decode)."""
    streams = [raw_bytes, raw_bytes[2 * 1600:]]

    def run(ms):
        for i, s in enumerate(streams):
            ms.process(i, s)
            ms.end_stream(i)
        return ms.finish()

    dense = MultiStreamStkDecode(stk_sr, n_streams=2, block_frames=32)
    assert dense._dense is not None
    monkeypatch.setenv("PHNREC_TPU_DENSE_STK", "0")
    edge = MultiStreamStkDecode(stk_sr, n_streams=2, block_frames=32)
    assert edge._dense is None
    a, b = run(dense), run(edge)
    for i in range(2):
        assert _key(a[i]) == _key(b[i]), f"stream {i} diverged"
        np.testing.assert_allclose([l.score for l in a[i]],
                                   [l.score for l in b[i]], atol=1e-4)


def test_multistream_stk_mesh(stk_sr, raw_bytes):
    """stkint decode streams shard over an 8-device mesh (stream axis =
    'data'), outputs unchanged."""
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("data",))
    ms = MultiStreamStkDecode(stk_sr, n_streams=8, block_frames=32,
                              mesh=mesh)
    ref = MultiStreamStkDecode(stk_sr, n_streams=8, block_frames=32)
    for m in (ms, ref):
        for i in range(8):
            m.process(i, raw_bytes)
            m.end_stream(i)
    got, want = ms.finish(), ref.finish()
    for i in range(8):
        assert _key(got[i]) == _key(want[i]), f"stream {i}"
        np.testing.assert_allclose([l.score for l in got[i]],
                                   [l.score for l in want[i]], atol=5e-3)


def test_stk_commit_backoff_when_nothing_settles(stk_sr, raw_bytes):
    """When no label settles, commit attempts must back off
    geometrically (each attempt on a grown window compiles a fresh walk
    program and fetches a longer edge row) instead of re-walking every
    dispatch; outputs stay exact once walking resumes."""
    ms = MultiStreamStkDecode(stk_sr, n_streams=2, block_frames=32,
                              record_horizon=64)
    calls = [0]
    orig = ms._window_walk

    def stub():
        calls[0] += 1
        return [[] for _ in range(ms.n)]

    ms._window_walk = stub
    for s in range(0, len(raw_bytes), 4096):
        for i in range(2):
            ms.process(i, raw_bytes[s : s + 4096])
    # ~90 blocks dispatched; without back-off every retained>horizon
    # dispatch walks (dozens); geometric back-off bounds it
    assert 1 <= calls[0] <= 6, calls[0]
    ms._window_walk = orig
    for i in range(2):
        ms.end_stream(i)
    got = ms.finish()
    want = _single(stk_sr, raw_bytes)
    for i in range(2):
        assert _key(got[i]) == _key(want)
