"""Test environment: the CPU backend with 8 virtual devices, so the
sharding tests run anywhere.  JAX_PLATFORMS is only defaulted, so tests
marked ``gpu`` can be pointed at a card (``JAX_PLATFORMS=cuda,cpu pytest
-m gpu tests/``); they decide in the ``gpu_device`` fixture whether one is
present and skip otherwise."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when JAX finds none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


REFERENCE = "/root/reference"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

PACKAGES = {
    "en": "PHN_EN_TIMIT_LCRC_N500",
    "cz": "PHN_CZ_SPDAT_LCRC_N1500",
    "hu": "PHN_HU_SPDAT_LCRC_N1500",
    "ru": "PHN_RU_SPDAT_LCRC_N1500",
    "es": "test/PHN_ES",
}


@pytest.fixture(scope="session")
def reference_dir():
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference tree not available")
    return REFERENCE


def package_dir(lang: str) -> str:
    return os.path.join(REFERENCE, PACKAGES[lang])


def golden(name: str) -> str:
    return os.path.join(GOLDEN, name)


def small_spec(**kw):
    """The CZ N1500 package's widths with a 64-unit hidden layer (CPU test
    speed) and, like the EN package, no sentence norm, so streaming and
    offline decodes are comparable; ``kw`` overrides fields."""
    import dataclasses

    from phnrec_tpu import synth

    return dataclasses.replace(
        synth.CZ_N1500, **{"n_hidden": 64, "sent_mean_norm": False, **kw})


def seeded_package(root, decoder: str = "phndec", extra_cfg: str = "",
                   seed: int = 0, spec=None) -> str:
    """A seeded model package (phnrec_tpu.synth) written into ``root``,
    with ``extra_cfg`` appended to its config."""
    from phnrec_tpu import synth

    root = str(root)
    synth.write_package(root, seed=seed, spec=spec or small_spec(),
                        decoder=decoder)
    if extra_cfg:
        with open(os.path.join(root, "config"), "a") as f:
            f.write(extra_cfg)
    return root


@pytest.fixture(scope="session")
def seeded_phonemes(tmp_path_factory) -> str:
    """Path of the seeded CZ-width package's phoneme list (45 phonemes,
    x 3 states = the 135 HMM observation columns of the CZ package)."""
    from phnrec_tpu import synth

    path = tmp_path_factory.mktemp("phonemes") / "phonemes"
    path.write_text("".join(
        p + "\n" for p in synth.phonemes(synth.CZ_N1500.n_phonemes)))
    return str(path)


def seeded_audio(seconds: float, seed: int = 3) -> bytes:
    """Seeded 8 kHz lin16 speech-like audio as raw bytes."""
    from phnrec_tpu import synth

    return synth.waveform([0, seed], seconds).tobytes()
