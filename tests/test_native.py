"""Parity tests: native C++ runtime kernels vs. the pure-Python oracles.

The native library (phnrec_tpu/native/src/phnrec_native.cpp) implements the
host-side runtime hot spots; every function here must produce results
identical to the Python reference implementations, which themselves are
validated against the C++ reference's semantics (srec.cpp:709-791,
phndec.cpp:236-302, STKLib/labels.C:525-527, myrand.cpp:17-28).
"""

import numpy as np
import pytest

from phnrec_tpu import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library did not build")


def test_convert_waveform_lin16_parity():
    from tests.conftest import seeded_audio

    raw = seeded_audio(3.0)
    w_n, n_n = native.convert_waveform(raw, "lin16", scale=0.5, dc_shift=2.0)
    # bypass the native dispatch inside convert_waveform via monkey state
    sig = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    ref = np.zeros(max(len(sig), 200), np.float32)
    ref[: len(sig)] = sig
    ref = (ref + 2.0) * 0.5
    assert n_n == len(sig)
    np.testing.assert_array_equal(w_n, ref)


def test_convert_waveform_alaw_parity():
    from phnrec_tpu.io.audio import ALAW_TABLE_D5
    raw = bytes(range(256)) * 3 + b"\x11"
    w_n, n_n = native.convert_waveform(raw, "alaw")
    codes = np.frombuffer(raw, np.uint8)
    ref = 8.0 * ALAW_TABLE_D5[codes].astype(np.float32)
    assert n_n == len(raw)
    np.testing.assert_array_equal(w_n[: len(raw)], ref)


def test_convert_short_signal_pads_to_200():
    w, n = native.convert_waveform(b"\x01\x00" * 5, "lin16")
    assert n == 5 and w.shape[0] == 200
    assert np.all(w[5:] == 0.0) and np.all(w[:5] == 1.0)


def test_swap4_roundtrip():
    a = np.arange(17, dtype=np.float32)
    b = a.copy()
    native.swap4_inplace(b)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(b, a.astype(">f4").view(np.uint8)
                                  .view(np.float32))
    native.swap4_inplace(b)
    np.testing.assert_array_equal(a, b)


def test_align_matches_python():
    from phnrec_tpu import score
    rng = np.random.default_rng(7)
    for _ in range(25):
        ref = [f"p{i}" for i in rng.integers(0, 8, rng.integers(0, 30))]
        hyp = [f"p{i}" for i in rng.integers(0, 8, rng.integers(0, 30))]
        counts, _ = score.align(ref, hyp)
        c_native = score.align_counts(ref, hyp)
        assert (counts.hits, counts.dels, counts.subs, counts.ins) == (
            c_native.hits, c_native.dels, c_native.subs, c_native.ins)


def test_backtrack_batch_matches_python(monkeypatch):
    """Random well-formed histories: native batch == per-row Python."""
    from phnrec_tpu.decoder import phnloop

    rng = np.random.default_rng(3)
    B, T, P = 4, 50, 6
    n_frames = np.array([50, 1, 17, 33], np.int32)
    # build self-consistent histories the way the scan would: lengths grow
    # by 1 within a segment and reset across; prev chains to older phonemes
    max_phn = rng.integers(0, P, (B, T)).astype(np.int32)
    length = np.zeros((B, T), np.int32)
    prev_phn = np.full((B, T), -1, np.int32)
    for b in range(B):
        t = 0
        prev = -1
        while t < T:
            seg = int(rng.integers(1, 8))
            seg = min(seg, T - t)
            phn = int(max_phn[b, t])
            for k in range(seg):
                max_phn[b, t + k] = phn
                length[b, t + k] = k + 1
                prev_phn[b, t + k] = prev
            prev = phn
            t += seg
    alpha = np.cumsum(rng.standard_normal((B, T)).astype(np.float32), axis=1)
    # History stores entry frames; ent = t - length + 1, time-major [T, B]
    ent = (np.arange(T)[None, :] - length + 1).astype(np.int32)
    hist = phnloop.History(max_phn.T, ent.T, alpha.T)
    phonemes = [f"p{i}" for i in range(P)]

    got = phnloop.backtrack_batch(hist, n_frames, phonemes)
    for b in range(B):
        want = phnloop.backtrack(
            phnloop.History(*(np.asarray(a)[: n_frames[b], b]
                              for a in hist)), phonemes)
        assert got[b] == want


def test_myrand_parity_first_values():
    """LCG must match the reference recurrence (myrand.cpp:17-28)."""
    seq = native.myrand_sequence(1, 5)
    state = 1
    want = []
    for _ in range(5):
        state = (state * 1103515245 + 12345) & 0xFFFFFFFF
        want.append((state >> 16) & 0x7FFFFFFF)
    assert list(seq) == want
