"""The plain float32 reference (phnrec_tpu/reference.py) against the
production posterior path, and its pieces against the production
assembly: independent implementations of the same semantics."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from phnrec_tpu import reference
from tests.conftest import seeded_package, small_spec


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    return seeded_package(tmp_path_factory.mktemp("ref"),
                          spec=small_spec(sent_mean_norm=True))


def test_reference_matches_batch_post_core(pkg):
    from phnrec_tpu import normalization, synth
    from phnrec_tpu.parallel.batch import BatchPipeline
    from phnrec_tpu.pipeline import SpeechRec

    sr = SpeechRec(pkg)
    bp = BatchPipeline(sr)
    waves = [synth.waveform([5, i], 1.2) for i in range(2)]
    wave, n_samples = bp.pad_batch(waves)
    nf = bp.frame_counts(n_samples)
    T = int(sr.frontend.frame_count(wave.shape[1]))
    got = np.asarray(bp._post_core(jnp.asarray(wave.astype(np.int16)),
                                   jnp.asarray(nf), T))
    model = reference.load_model(pkg)
    fe = sr.frontend
    for b, w in enumerate(waves):
        par = normalization.frame_norm(
            fe(jnp.asarray(w, jnp.float32), fe.frame_count(w.size)),
            sr.frame_shift, sr.frame_floor)
        want = np.asarray(reference.log_posteriors(model, par))
        np.testing.assert_allclose(np.exp(got[b]), np.exp(want), atol=1e-5)
        m = np.exp(want) >= 1e-6
        np.testing.assert_allclose(got[b][m], want[m], atol=1e-4)


def test_dct_basis_matches_production_matrix():
    from phnrec_tpu.posteriors.stc import dct_c0_matrix

    for add_c0 in (True, False):
        np.testing.assert_allclose(reference.dct_basis(16, 11, add_c0),
                                   dct_c0_matrix(16, 11, add_c0), atol=1e-12)


def test_lcrc_features_match_assembler(pkg):
    from phnrec_tpu.posteriors.stc import LCRCAssembler, LCRCSpec

    model = reference.load_model(pkg)
    rng = np.random.default_rng(0)
    params = rng.standard_normal((40, 15)).astype(np.float32)
    asm = LCRCAssembler(LCRCSpec(15, 31, 11, True), model.win_left,
                        model.win_right)
    want_l, want_r = asm(jnp.asarray(params))
    with jax.default_matmul_precision("highest"):
        got_l, got_r = reference.lcrc_features(jnp.asarray(params), model, 11)
    np.testing.assert_allclose(got_l, want_l, atol=2e-5)
    np.testing.assert_allclose(got_r, want_r, atol=2e-5)


@pytest.mark.parametrize("n_rows", [1, 7, 33])
def test_mlp_to_device_padding_is_exact(pkg, n_rows):
    """mlp.to_device pads every axis to a multiple of 8 with zeros; the
    padded forward equals the unpadded reference MLP."""
    from phnrec_tpu.posteriors import mlp

    p = reference.load_model(pkg).merger
    dev = mlp.to_device(p)
    assert dev.w1.shape == (280, 64) and dev.w2.shape == (64, 144)
    x = np.random.default_rng(n_rows).standard_normal(
        (n_rows, p.n_inp)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(reference.mlp_posteriors(p, jnp.asarray(x)))
    got = np.asarray(mlp.forward(dev, jnp.asarray(x)))
    assert got.shape == (n_rows, 138)
    np.testing.assert_allclose(got, want, atol=1e-6)
