"""Distributed training statistics: accumulator psum over a data mesh
(8 virtual CPU devices, conftest) must equal the serial sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phnrec_tpu.io.mmf import parse_mmf
from phnrec_tpu.train import (accumulate_utterance, compile_transcription,
                              make_accumulators, merge_accumulators,
                              psum_accumulators)
from phnrec_tpu.train.graph import build_model_index
from tests.test_train import MMF_GMM


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    p = tmp_path_factory.mktemp("dist") / "m.mmf"
    p.write_text(MMF_GMM)
    return parse_mmf(str(p))


def test_psum_accumulators_over_mesh(models):
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs multiple devices")
    n_dev = 4
    mesh = jax.sharding.Mesh(np.array(devices[:n_dev]), ("data",))
    index = build_model_index(models)
    g = compile_transcription(models, ["a", "b"], index)

    rng = np.random.default_rng(0)
    T = 8
    xs = rng.normal(size=(n_dev, T, 2)).astype(np.float32)

    # serial reference: sum of per-utterance accumulators
    ref = make_accumulators(index)
    for i in range(n_dev):
        ref = accumulate_utterance(g, ref, xs[i], T)

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def shard_fn(x):
        acc = accumulate_utterance(g, make_accumulators(index), x[0], T)
        return psum_accumulators(acc, "data")

    f = shard_map(shard_fn, mesh=mesh, in_specs=P("data"),
                  out_specs=P())          # replicated result
    got = f(jnp.asarray(xs))

    for name, a, b in zip(ref._fields, got, ref):
        if a is None:
            assert b is None
            continue
        assert np.allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                           atol=1e-5), name
    assert float(np.asarray(got.n_utts)) == n_dev
