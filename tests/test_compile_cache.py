"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set, else
a fixed, git-ignored directory inside the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    import phnrec_tpu

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert phnrec_tpu.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert phnrec_tpu.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_default_cache_dir_is_git_ignored():
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("env_dir", [True, False])
def test_import_configures_jax_cache(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "PHNREC_TPU_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, phnrec_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip().splitlines()[-1] == want
