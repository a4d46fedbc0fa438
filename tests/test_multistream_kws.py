"""Multi-stream KWS serving: N concurrent keyword-spotting streams
through one fused dispatch must produce, per stream, exactly the hits of
a single-stream StreamingRecognizer in KWS mode (the LRTrace callback
semantics of stkinterface.cpp:240-289 batched over streams)."""

import numpy as np
import pytest

from phnrec_tpu.multistream import MultiStreamKWS, MultiStreamRecognizer
from phnrec_tpu.pipeline import SpeechRec
from phnrec_tpu.streaming import StreamingRecognizer

from tests.conftest import seeded_audio, seeded_package
from tests.test_stk_streaming import _stkint_package


@pytest.fixture(scope="module")
def kws_sr(tmp_path_factory):
    pkg = _stkint_package(tmp_path_factory.mktemp("kwspkg"), decoder="kws")
    sr = SpeechRec(pkg)
    assert sr.stk_decoder is not None and sr.stk_decoder.mode == "kws"
    return sr


@pytest.fixture(scope="module")
def raw_bytes():
    return seeded_audio(3.0)


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name, round(l.score, 3))
            for l in labels]


def _assert_hits_equal(got, want, tag=""):
    """Times + names exact; scores to cross-path f32 summation noise
    (the conv-based STC assembly reorders sums vs the gather path)."""
    assert [(l.start_frames, l.end_frames, l.name) for l in got] == \
        [(l.start_frames, l.end_frames, l.name) for l in want], tag
    np.testing.assert_allclose([l.score for l in got],
                               [l.score for l in want], atol=5e-3)


def _single_hits(sr, stream, block):
    rec = StreamingRecognizer(sr, block_frames=block)
    rec.process(stream)
    return rec.finish()


def test_multistream_kws_matches_single(kws_sr, raw_bytes):
    # full, HALF-length (sample-aligned), and offset streams
    streams = [raw_bytes, raw_bytes[: len(raw_bytes) // 2 // 2 * 2],
               raw_bytes[2 * 1600:]]
    ms = MultiStreamKWS(kws_sr, n_streams=3, block_frames=32)
    offsets = [0] * 3
    chunk = 6000
    while any(o < len(s) for o, s in zip(offsets, streams)):
        for i, s in enumerate(streams):
            if offsets[i] < len(s):
                ms.process(i, s[offsets[i] : offsets[i] + chunk])
                offsets[i] += chunk
            else:
                ms.end_stream(i)
    got = ms.finish()
    assert any(got), "no hits on any stream"
    for i, s in enumerate(streams):
        want = _single_hits(kws_sr, s, 32)
        _assert_hits_equal(got[i], want, f"stream {i} diverged")


def test_multistream_kws_live_polling(kws_sr, raw_bytes):
    """hits_so_far streams new flushes per chunk; union == finish()."""
    ms = MultiStreamKWS(kws_sr, n_streams=2, block_frames=32)
    seen = [[], []]
    for off in range(0, len(raw_bytes), 8000):
        for i in range(2):
            ms.process(i, raw_bytes[off : off + 8000])
        for i in range(2):
            seen[i].extend(ms.hits_so_far(i))
    final = ms.finish()
    for i in range(2):
        seen[i].extend(ms.hits_so_far(i))
        assert _key(seen[i]) == _key(final[i])


def test_multistream_kws_rejects_wrong_mode(kws_sr, tmp_path):
    with pytest.raises(ValueError):
        MultiStreamRecognizer(kws_sr, n_streams=2)
    sr_plain = SpeechRec(seeded_package(tmp_path / "plain"))
    with pytest.raises(ValueError):
        MultiStreamKWS(sr_plain, n_streams=2)


def test_multistream_kws_mesh(kws_sr, raw_bytes):
    """KWS streams shard over an 8-device mesh, hits unchanged."""
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("data",))
    ms = MultiStreamKWS(kws_sr, n_streams=8, block_frames=32, mesh=mesh)
    ref = MultiStreamKWS(kws_sr, n_streams=8, block_frames=32)
    for m in (ms, ref):
        for i in range(8):
            m.process(i, raw_bytes)
    got, want = ms.finish(), ref.finish()
    for i in range(8):
        _assert_hits_equal(got[i], want[i], f"stream {i}")


def test_kws_selects_xla_dense_step(kws_sr):
    """KWS serving runs the XLA dense network step (DenseKWSScan) on
    every backend, and only PHNREC_TPU_DENSE_KWS=0 or a large network
    selects the edge-list scan."""
    from phnrec_tpu.decoder.stknet import DenseKWSScan

    ms = MultiStreamKWS(kws_sr, n_streams=2, block_frames=32)
    assert isinstance(ms._dense, DenseKWSScan)
    assert not hasattr(ms, "_pallas_net")


def test_dense_scan_matches_edge_list(kws_sr, raw_bytes, monkeypatch):
    """The dense max-plus network step must be hit-for-hit identical to
    the gather-based edge-list scan (incl. tie-breaking and word start
    times)."""
    ms_dense = MultiStreamKWS(kws_sr, n_streams=2, block_frames=32)
    assert ms_dense._dense is not None
    monkeypatch.setenv("PHNREC_TPU_DENSE_KWS", "0")
    ms_edge = MultiStreamKWS(kws_sr, n_streams=2, block_frames=32)
    assert ms_edge._dense is None
    streams = [raw_bytes, raw_bytes[2 * 800:]]
    for m in (ms_dense, ms_edge):
        for i, s in enumerate(streams):
            m.process(i, s)
    got, want = ms_dense.finish(), ms_edge.finish()
    for i in range(2):
        assert want[i], f"edge-list produced no hits on stream {i}"
        assert _key(got[i]) == _key(want[i]), f"stream {i} diverged"


def test_event_blocks_dropped_after_sync(kws_sr, raw_bytes):
    """Decoded event blocks must not accumulate (a 24/7 serving session
    would otherwise leak HBM/host memory); polling stays incremental."""
    ms = MultiStreamKWS(kws_sr, n_streams=2, block_frames=32)
    for i in range(2):
        ms.process(i, raw_bytes)
    assert ms._hist, "expected pending event blocks"
    first = ms.results()
    assert ms._hist == []
    again = ms.results()
    assert [_key(a) for a in again] == [_key(a) for a in first]
    final = ms.finish()
    assert ms._hist == []
    for i in range(2):
        assert _key(final[i])[: len(_key(first[i]))] == _key(first[i])


def test_set_beam_pruning_is_live(kws_sr, raw_bytes):
    """The beam rides in the decode carry: changing it after
    construction affects subsequent dispatches (stkinterface.h:108's
    SetBeamPruning semantics), without recompiling."""
    wide = MultiStreamKWS(kws_sr, n_streams=1, block_frames=32)
    wide.set_beam_pruning(1e9)         # effectively off
    narrow = MultiStreamKWS(kws_sr, n_streams=1, block_frames=32)
    narrow.set_beam_pruning(1.0)       # very tight
    base = MultiStreamKWS(kws_sr, n_streams=1, block_frames=32)
    for m in (wide, narrow, base):
        m.process(0, raw_bytes)
    w, n, b = wide.finish()[0], narrow.finish()[0], base.finish()[0]
    assert _key(w) == _key(b), "huge beam must change nothing"
    assert _key(n) != _key(b), "tight beam must change the LR stream"
