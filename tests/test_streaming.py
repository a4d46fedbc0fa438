"""Streaming/offline equivalence: the reference maintains dual paths
(ProcessOnline srec.cpp:793 vs ProcessOffline srec.cpp:929) that must
agree; here one code path is driven both ways and must match exactly."""

import numpy as np
import pytest

from phnrec_tpu.io.normfile import load_norm_file, save_norm_file
from phnrec_tpu.normalization import OnlineNorm
from phnrec_tpu.pipeline import SpeechRec
from phnrec_tpu.streaming import StreamingRecognizer

from conftest import seeded_audio, seeded_package


@pytest.fixture(scope="module")
def sr(tmp_path_factory):
    # a seeded package without sentence norm, so streaming and offline
    # are comparable
    return SpeechRec(seeded_package(tmp_path_factory.mktemp("pkg")))


@pytest.fixture(scope="module")
def raw():
    return seeded_audio(5.0)


@pytest.fixture(scope="module")
def offline_labels(sr, raw):
    return sr.process_offline("wf", "str", raw).labels


@pytest.mark.parametrize("chunk_bytes", [4096, 1000, 37])
def test_streaming_matches_offline(sr, raw, offline_labels, chunk_bytes):
    rec = StreamingRecognizer(sr, block_frames=64)
    for i in range(0, len(raw), chunk_bytes):
        rec.process(raw[i : i + chunk_bytes])
    labels = rec.finish()
    assert [(l.start_frames, l.end_frames, l.name) for l in labels] == \
        [(l.start_frames, l.end_frames, l.name) for l in offline_labels]
    # scores wobble ~1e-5 with chunking (GEMM tiling differs per shape)
    for a, b in zip(labels, offline_labels):
        assert a.score == pytest.approx(b.score, abs=1e-3)


def test_partial_results_are_prefix(sr, raw, offline_labels):
    rec = StreamingRecognizer(sr, block_frames=64)
    half = len(raw) // 2
    rec.process(raw[:half])
    part = rec.results(settled_only=True)
    rec.process(raw[half:])
    final = rec.finish()
    key = lambda ls: [(l.start_frames, l.end_frames, l.name) for l in ls]
    assert key(final)[: len(part)] == key(part)
    assert key(final) == key(offline_labels)


def test_online_norm_estimation_and_persistence(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.normal(3.0, 2.0, size=(300, 5)).astype(np.float32)
    f = str(tmp_path / "norm.xml")
    on = OnlineNorm(5, estim_interval=100, mean_norm=True, var_norm=True,
                    file=f)
    out = on.process_block(data)
    # frames 0..98 identity, 99.. normalized with stats of frames 0..99
    np.testing.assert_array_equal(out[:99], data[:99])
    mean = data[:100].mean(0)
    inv = 1.0 / np.sqrt((data[:100] ** 2).mean(0) - mean ** 2)
    np.testing.assert_allclose(out[99], (data[99] - mean) * inv, rtol=1e-5)
    np.testing.assert_allclose(out[150], (data[150] - mean) * inv, rtol=1e-5)

    # persisted file loads back (estim_interval=0 -> use loaded params)
    ch = load_norm_file(f)[0]
    np.testing.assert_allclose(ch["mean"], mean, rtol=1e-5)
    on2 = OnlineNorm(5, estim_interval=0, mean_norm=True, var_norm=True,
                     file=f)
    out2 = on2.process_block(data[:10])
    np.testing.assert_allclose(out2, (data[:10] - mean) * inv, rtol=1e-4)


def test_online_norm_block_boundaries_equal_frame_at_a_time():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(57, 3)).astype(np.float32)
    a = OnlineNorm(3, estim_interval=20, mean_norm=True, var_norm=True)
    whole = a.process_block(data)
    b = OnlineNorm(3, estim_interval=20, mean_norm=True, var_norm=True)
    parts = [b.process_block(data[i : i + 7]) for i in range(0, 57, 7)]
    np.testing.assert_allclose(whole, np.concatenate(parts), rtol=1e-6)


def test_norm_file_roundtrip(tmp_path):
    f = str(tmp_path / "n.xml")
    means = np.array([1.0, -2.0], np.float32)
    inv = np.array([0.5, 4.0], np.float32)
    save_norm_file(f, {0: (means, inv), 3: (means * 2, inv)})
    back = load_norm_file(f)
    assert set(back) == {0, 3}
    np.testing.assert_allclose(back[0]["mean"], means)
    np.testing.assert_allclose(back[0]["inv_std"], inv, rtol=1e-5)
    np.testing.assert_allclose(back[3]["mean"], means * 2)


def test_online_norm_multi_channel_independent():
    """Channels estimate and normalize independently (per-channel
    ChannelNormParams, norm.cpp:92-148; SetChannel norm.cpp:202)."""
    rng = np.random.default_rng(9)
    a = rng.normal(5.0, 1.0, (120, 4)).astype(np.float32)
    b = rng.normal(-3.0, 4.0, (120, 4)).astype(np.float32)
    on = OnlineNorm(4, estim_interval=50, mean_norm=True, var_norm=True)
    on.set_channel(0)
    out_a1 = on.process_block(a[:60])
    on.set_channel(1)
    out_b = on.process_block(b)
    on.set_channel(0)
    out_a2 = on.process_block(a[60:])

    ref_a = OnlineNorm(4, estim_interval=50, mean_norm=True, var_norm=True)
    ref_b = OnlineNorm(4, estim_interval=50, mean_norm=True, var_norm=True)
    np.testing.assert_array_equal(
        np.concatenate([out_a1, out_a2]), ref_a.process_block(a))
    np.testing.assert_array_equal(out_b, ref_b.process_block(b))


def test_streaming_channel_config_and_switch(sr):
    """The onlinenorm/channel extension key selects the initial channel
    and StreamingRecognizer.set_channel switches mid-stream."""
    rec = StreamingRecognizer(sr)
    assert rec.online_norm.cur == \
        sr.cfg.get_int("onlinenorm", "channel") == 0
    rec.set_channel(3)
    assert rec.online_norm.cur == 3 and 3 in rec.online_norm.channels


def test_commit_horizon_single_stream(sr, raw, offline_labels):
    """Opt-in fixed-lag commit: history blocks drop as labels settle and
    the stitched result equals the full decode."""
    rec = StreamingRecognizer(sr, block_frames=32, commit_horizon=60)
    max_blocks = 0
    for i in range(0, len(raw), 4096):
        rec.process(raw[i : i + 4096])
        max_blocks = max(max_blocks, len(rec._hist[0]))
        rec.results(settled_only=True)    # live polling mid-commit
    labels = rec.finish()
    assert rec._frame0 > 0, "no commit ever happened"
    full = StreamingRecognizer(sr, block_frames=32)
    full.process(raw)
    full.finish()
    assert max_blocks < len(full._hist[0]), "history did not stay bounded"
    key = lambda ls: [(l.start_frames, l.end_frames, l.name)  # noqa: E731
                      for l in ls]
    assert key(labels) == key(offline_labels)


def test_commit_horizon_forced_split(sr):
    """A segment spanning the whole horizon (constant audio -> one long
    phone) must FORCE a boundary (the reference's ring cannot hold a
    longer segment either): history stays bounded, coverage stays
    contiguous, and merging adjacent same-name splits reproduces the
    full decode with telescoped likes."""
    rng = np.random.default_rng(2)
    # low-level constant-ish noise: the loop settles into long segments
    raw = (rng.normal(0, 40, 16000 * 6).astype("<i2")).tobytes()
    com = StreamingRecognizer(sr, block_frames=32, commit_horizon=40)
    max_blocks = 0
    for i in range(0, len(raw), 4096):
        com.process(raw[i : i + 4096])
        max_blocks = max(max_blocks, len(com._hist[0]))
    got = com.finish()
    full = StreamingRecognizer(sr, block_frames=32)
    full.process(raw)
    want = full.finish()
    assert com._frame0 > 0
    assert max_blocks <= (2 * 40 + 32) // 32 + 3, "window not bounded"
    # contiguous coverage
    assert got[0].start_frames == want[0].start_frames
    assert got[-1].end_frames == want[-1].end_frames
    for a, b in zip(got, got[1:]):
        assert a.end_frames == b.start_frames

    def merged(ls):
        out = []
        for l in ls:
            if out and out[-1].name == l.name and \
                    out[-1].end_frames == l.start_frames:
                prev = out.pop()
                out.append(type(l)(prev.start_frames, l.end_frames,
                                   l.name, prev.score + l.score))
            else:
                out.append(l)
        return out
    gm, wm = merged(got), merged(want)
    assert [(l.start_frames, l.end_frames, l.name) for l in gm] == \
        [(l.start_frames, l.end_frames, l.name) for l in wm]
    np.testing.assert_allclose([l.score for l in gm],
                               [l.score for l in wm], atol=2e-2)
