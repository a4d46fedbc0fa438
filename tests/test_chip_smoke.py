"""chip_smoke.py's phases at a tiny size (the CPU stands in for the card),
its refusal to run without a GPU, and the same phases on a card when one
is present (``gpu`` marker)."""

import numpy as np
import pytest

import chip_smoke
from tests.conftest import small_spec


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    log = chip_smoke.Log("cpu test")
    inp = chip_smoke.phase_package(work, log, spec=small_spec(
        sent_mean_norm=True), n_utts=3, seconds=1.5, n_ragged=2)
    return work, log, inp


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_phase_device_reports_each_precision_mode():
    errs = chip_smoke.phase_device(chip_smoke.Log("cpu test"))
    assert set(errs) == {"highest", "high", "default"}
    assert errs["highest"] < 1e-5


def test_phase_package_writes_three_variants(smoke):
    from phnrec_tpu.pipeline import SpeechRec

    _, _, inp = smoke
    assert SpeechRec(inp.pkg).sent_norm.mean_norm
    assert not SpeechRec(inp.serve_pkg).sent_norm.mean_norm
    assert SpeechRec(inp.kws_pkg).stk_decoder.mode == "kws"
    assert len(inp.waves) == 5 and inp.waves[0].dtype == np.int16
    # 3 full-length utterances, then 2 shorter ones of different lengths
    assert len({w.size for w in inp.waves}) == 3
    assert max(w.size for w in inp.waves[3:]) < inp.waves[0].size


def test_phase_cli(smoke):
    work, log, inp = smoke
    assert chip_smoke.phase_cli(inp, work, log) > 0


def test_phase_batch(smoke):
    _, log, inp = smoke
    out = chip_smoke.phase_batch(inp, log, info_modes=("high",))
    assert out["post_err"] <= chip_smoke.POST_ATOL
    assert out["labels"] > 0 and out["frames"] == 5 * 148


def test_phase_mlp(smoke):
    _, log, inp = smoke
    out = chip_smoke.phase_mlp(inp, log, n_frames=64)
    assert set(out) == {"highest", "high"} and out["highest"] > 0


def test_phase_serving(smoke):
    _, log, inp = smoke
    assert chip_smoke.phase_serving(inp, log, n_streams=2, seconds=1.5,
                                    block=32) > 0


def test_phase_kws(smoke, monkeypatch):
    _, log, inp = smoke
    # ~70 hits here, where one tie broken the other way is 1.4%; every
    # differing hit must still be a tie
    monkeypatch.setattr(chip_smoke, "KWS_MIN_MATCH", 0.95)
    out = chip_smoke.phase_kws(inp, log, n_streams=2, seconds=3.0,
                               timing_streams=4, timing_block=16)
    assert out["hits"] > 0 and out["us_per_frame_step"] > 0
    assert out["same"] >= 0.95 * out["hits"]


def test_kws_tie_margin():
    """A hit on a flat LR stretch is a tie; one on a strict peak is not."""
    from phnrec_tpu.io.labels import Label

    lr = np.array([-9.0, -5.0, -3.0, -3.0, -3.0, -4.0, -8.0], np.float32)
    own, other = chip_smoke.kws_tie(lr, Label(1, 4, "kw", -3.0))
    assert own == 0.0 and other == 0.0
    lr[3:5] = -3.5
    own, other = chip_smoke.kws_tie(lr, Label(1, 3, "kw", -3.0))
    assert own == 0.0 and other == pytest.approx(0.5)


def test_phase_mesh_four_devices():
    out = chip_smoke.phase_mesh(chip_smoke.Log("cpu test"), 4, per_device=1,
                                seconds=0.5, stream_seconds=0.5)
    assert out["batch"] == 4 and out["streams"] == 4


def test_first_divergence_names_frame_and_margin():
    from phnrec_tpu.io.labels import Label

    got = [Label(0, 3, "a", 0.0), Label(3, 6, "b", 0.0)]
    want = [Label(0, 4, "a", 0.0), Label(4, 6, "b", 0.0)]
    lp = np.log(np.full((6, 3), 1 / 3, np.float32))
    msg = chip_smoke._first_divergence(got, want, lp, lp, 6)
    assert "frame 3" in msg and "'b'" in msg and "margin" in msg


@pytest.mark.gpu
def test_phases_on_gpu(gpu_device, tmp_path):
    """The smoke phases on a card at a small size (run on a GPU machine
    with ``JAX_PLATFORMS=cuda,cpu pytest -m gpu tests/``)."""
    import jax

    log = chip_smoke.Log(chip_smoke.card_name())
    with jax.default_device(gpu_device):
        inp = chip_smoke.phase_package(str(tmp_path), log, n_utts=4,
                                       seconds=2.0, n_ragged=2)
        assert chip_smoke.phase_batch(inp, log)["labels"] > 0
        assert chip_smoke.phase_serving(inp, log, n_streams=2,
                                        seconds=2.0) > 0
