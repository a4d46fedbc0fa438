"""The seeded model package generator (phnrec_tpu/synth.py): a package at
exactly the CZ SpeechDat N1500 widths that SpeechRec loads, seeded and
deterministic, plus the seeded audio and KWS resources."""

import os

import numpy as np
import pytest

from phnrec_tpu import synth
from phnrec_tpu.io.weights import load_nbin


@pytest.fixture(scope="module")
def cz_pkg(tmp_path_factory):
    return synth.write_package(str(tmp_path_factory.mktemp("cz")), seed=0)


def test_cz_package_loads_at_published_widths(cz_pkg):
    from phnrec_tpu.pipeline import SpeechRec

    sr = SpeechRec(cz_pkg)
    cfg = sr.cfg
    assert cfg.get_int("source", "sample_freq") == 8000
    assert sr.frontend.spec.nbanks == 15
    assert (sr.frontend.spec.lo_freq, sr.frontend.spec.hi_freq) == (64, 4000)
    assert (sr.frontend.spec.vector_size, sr.frontend.spec.step) == (200, 80)
    assert cfg.get_str("posteriors", "system") == "LCRC"
    assert cfg.get_int("posteriors", "length") == 31
    assert cfg.get_bool("posteriors", "add_c0")
    assert not cfg.get_bool("posteriors", "hamming")
    est = sr.estimator
    for band in est.band:
        assert (band.n_inp, band.n_hid, band.n_out) == (165, 1500, 138)
    assert (est.merger.n_inp, est.merger.n_hid, est.merger.n_out) == \
        (276, 1500, 138)
    assert len(sr.phonemes) == 45 and sr.loop_spec.n_states == 3
    assert sr.wpenalty == -4.6875
    assert cfg.get_int("decoder", "time_pruning") == 40
    assert sr.sent_norm.mean_norm
    assert cfg.get_bool("models", "gen_from_phn_list")


def test_norms_give_unit_scale_inputs(cz_pkg):
    p = load_nbin(os.path.join(cz_pkg, "weights", "band0.nbin"))
    assert np.all(p.dev > 0) and np.all(np.isfinite(p.mean))
    assert not np.allclose(p.dev, 1.0)


def test_package_is_deterministic_in_seed(cz_pkg, tmp_path):
    spec = synth.CZ_N1500
    again = synth.write_package(str(tmp_path / "a"), seed=0, spec=spec)
    other = synth.write_package(str(tmp_path / "b"), seed=1, spec=spec)
    for name in ("band0", "band1", "merger"):
        f = os.path.join("weights", f"{name}.nbin")
        a = open(os.path.join(cz_pkg, f), "rb").read()
        assert a == open(os.path.join(again, f), "rb").read()
        assert a != open(os.path.join(other, f), "rb").read()


def test_waveform_is_seeded_int16_speech_like():
    a = synth.waveform([0, 1], 2.0)
    assert a.dtype == np.int16 and a.shape == (16000,)
    assert np.array_equal(a, synth.waveform([0, 1], 2.0))
    assert not np.array_equal(a, synth.waveform([0, 2], 2.0))
    # pauses and loud segments both occur
    frames = np.abs(a[: 16000 // 80 * 80].reshape(-1, 80)).mean(axis=1)
    assert frames.max() > 20 * frames.min()


@pytest.mark.parametrize("decoder", ["stkint", "kws"])
def test_decoder_variants(tmp_path, decoder):
    from phnrec_tpu.pipeline import SpeechRec
    from tests.conftest import small_spec

    pkg = synth.write_package(str(tmp_path), seed=0, spec=small_spec(),
                              decoder=decoder)
    sr = SpeechRec(pkg)
    assert sr.stk_decoder is not None
    assert sr.stk_decoder.mode == ("kws" if decoder == "kws" else "decode")
    if decoder == "kws":
        words = open(os.path.join(pkg, "dicts", "keywords")).read().split()
        assert sr.stk_decoder.keywords() == sorted(words)


def test_cli_writes_package_and_audio(tmp_path):
    from tests.conftest import small_spec  # noqa: F401  (import check)

    synth.main([str(tmp_path), "--seed", "3", "--audio-seconds", "1"])
    assert os.path.exists(tmp_path / "config")
    assert os.path.getsize(tmp_path / "audio.raw") == 8000 * 2
