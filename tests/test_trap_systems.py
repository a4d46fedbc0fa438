"""3BT / 1BT / 1BT_DCT posterior systems vs a NumPy oracle that mirrors
traps.cpp loop-for-loop (AddVectorToBEMatrix replicate-init + shift,
CalcInputFeaturesForBandNets traps.cpp:221-344, the MINUS-ln merger input
negate traps.cpp:426-427, and the no-ln 1BT_DCT path traps.cpp:260-281,
429-431).  No shipped weights exist for these systems, so the nets are
synthetic; the oracle uses exact exp and the estimators run with
fast_exp=False.

Also covers: LCRCAssembler.batched == vmap of __call__ over
ragged n_valid, including rows shorter than half_context.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from phnrec_tpu.io.weights import MLPParams
from phnrec_tpu.posteriors.estimator import (DCTEstimator, TrapsEstimator,
                                             build_estimator,
                                             hamming_window)

TRAP_LEN = 31


def _net(seed, n_inp, n_hid, n_out):
    rng = np.random.default_rng(seed)
    return MLPParams(
        w1=rng.standard_normal((n_hid, n_inp)).astype(np.float32) * 0.2,
        b1=rng.standard_normal(n_hid).astype(np.float32) * 0.1,
        w2=rng.standard_normal((n_out, n_hid)).astype(np.float32) * 0.2,
        b2=rng.standard_normal(n_out).astype(np.float32) * 0.1,
        mean=rng.standard_normal(n_inp).astype(np.float32) * 0.3,
        dev=(rng.random(n_inp).astype(np.float32) + 0.5))


def _nn_fwd(p: MLPParams, x: np.ndarray) -> np.ndarray:
    xn = (x - p.mean) * p.dev
    h = 1.0 / (1.0 + np.exp(-(xn @ p.w1.T + p.b1)))
    o = h @ p.w2.T + p.b2
    e = np.exp(o - o.max())
    return e / e.sum()


def _dct_row(x: np.ndarray, n_out: int) -> np.ndarray:
    """sDCT (dspc.h:206-221): bases k=1..n_out, sqrt(2/n) norm."""
    n = x.shape[0]
    j = np.arange(n)
    return np.array([np.sqrt(2.0 / n) *
                     np.sum(x * np.cos(np.pi / n * (k + 1) * (j + 0.5)))
                     for k in range(n_out)])


def _oracle(params, system, band_nets, merger, use_hamming, add_c0):
    T, nb = params.shape
    shift = (TRAP_LEN - 1) // 2
    ham = (hamming_window(TRAP_LEN).astype(np.float64) if use_hamming
           else np.ones(TRAP_LEN))
    out = []
    for t in range(T):
        # replicate-init sliding window + 3-phase edges == clip gather
        ctx = params[np.clip(np.arange(t - shift, t + shift + 1), 0, T - 1)]
        bemat = ctx.T.astype(np.float64)          # [nb, trap_len]
        if system in ("3BT", "1BT"):
            beh = bemat * ham[None, :]
            n_bands = nb - 2 if system == "3BT" else nb
            m = np.concatenate([_nn_fwd(band_nets[i], beh[i])
                                for i in range(n_bands)])
            m = -np.where(m > 0, np.log(np.maximum(m, 1e-300)), 0.0)
        else:                                     # 1BT_DCT
            beh = bemat * ham[None, :]
            n_coefs = merger.n_inp // nb
            feats = []
            for i in range(nb):
                if add_c0:
                    feats.append(np.sqrt(2.0 / TRAP_LEN) * beh[i].sum())
                    feats.extend(_dct_row(beh[i], n_coefs - 1))
                else:
                    feats.extend(_dct_row(beh[i], n_coefs))
            m = np.asarray(feats)
        out.append(_nn_fwd(merger, m))
    return np.stack(out)


NB, HID, OUT = 5, 16, 7


def _bands(n):
    return [_net(10 + i, TRAP_LEN, HID, OUT) for i in range(n)]


@pytest.mark.parametrize("system,use_hamming", [
    ("1BT", True), ("1BT", False), ("3BT", True)])
def test_trap_nets_match_oracle(system, use_hamming):
    rng = np.random.default_rng(0)
    params = rng.standard_normal((24, NB)).astype(np.float32)
    n_bands = NB - 2 if system == "3BT" else NB
    bands = _bands(n_bands)
    merger = _net(99, n_bands * OUT, HID, 9)
    est = TrapsEstimator("", nbanks=NB, system=system, trap_len=TRAP_LEN,
                         use_hamming=use_hamming, fast_exp=False,
                         band_nets=bands, merger=merger)
    got = np.asarray(est.posteriors(jnp.asarray(params)))
    want = _oracle(params, system, bands, merger, use_hamming, False)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("add_c0", [True, False])
def test_1bt_dct_matches_oracle(add_c0):
    rng = np.random.default_rng(1)
    params = rng.standard_normal((24, NB)).astype(np.float32)
    n_coefs = 6
    merger = _net(7, NB * n_coefs, HID, 9)
    est = DCTEstimator("", nbanks=NB, trap_len=TRAP_LEN, add_c0=add_c0,
                       use_hamming=True, fast_exp=False, merger=merger)
    got = np.asarray(est.posteriors(jnp.asarray(params)))
    want = _oracle(params, "1BT_DCT", [], merger, True, add_c0)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_batched_matches_per_row():
    """posteriors_batched with ragged n_frames == per-row posteriors of
    the truncated sequences (rows past n_frames are ignored)."""
    rng = np.random.default_rng(2)
    B, T = 3, 20
    params = rng.standard_normal((B, T, NB)).astype(np.float32)
    n_frames = np.array([20, 5, 13], np.int32)
    bands = _bands(NB)
    merger = _net(99, NB * OUT, HID, 9)
    est = TrapsEstimator("", nbanks=NB, system="1BT", trap_len=TRAP_LEN,
                         use_hamming=True, fast_exp=False,
                         band_nets=bands, merger=merger)
    got = np.asarray(est.posteriors_batched(jnp.asarray(params),
                                            jnp.asarray(n_frames)))
    for b in range(B):
        n = n_frames[b]
        want = np.asarray(est.posteriors(jnp.asarray(params[b, :n])))
        np.testing.assert_allclose(got[b, :n], want, atol=1e-6)


def test_build_estimator_rejects_unknown():
    with pytest.raises(ValueError):
        build_estimator("2BT", "", nbanks=NB)


def test_lcrc_batched_matches_vmap_ragged():
    """LCRCAssembler.batched vs jax.vmap of __call__ over
    ragged n_valid, including rows shorter than half_context."""
    from phnrec_tpu.posteriors.stc import LCRCAssembler, LCRCSpec

    rng = np.random.default_rng(3)
    B, T, nb = 4, 40, 5
    spec = LCRCSpec(nbanks=nb, trap_len=31, n_coefs=11, add_c0=True)
    wl = rng.random(16).astype(np.float32)
    wr = rng.random(16).astype(np.float32)
    asm = LCRCAssembler(spec, wl, wr)
    params = jnp.asarray(rng.standard_normal((B, T, nb)).astype(np.float32))
    n_valid = jnp.asarray(np.array([40, 3, 16, 29], np.int32))  # 3 < 16

    got_l, got_r = asm.batched(params, n_valid)
    want_l, want_r = jax.vmap(lambda p, n: asm(p, n_valid=n))(params,
                                                              n_valid)
    np.testing.assert_allclose(np.asarray(got_l), np.asarray(want_l),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want_r),
                               atol=2e-5)
