"""Closure-compilation robustness: the instantaneous-node walk must be
iterative + memoized (deep null chains, diamond null lattices compile in
O(V*E), zero-score null cycles converge) and must pass through TEE models
(direct entry->exit transition, STKLib/Net.h:33-43, Viterbi.cc tee
handling in TokenPropagationInNetwork)."""

import numpy as np
import pytest

from phnrec_tpu.decoder.stknet import (NetworkDecoder, StkNetworkDecoder,
                                       compile_network)
from phnrec_tpu.io.mmf import parse_mmf
from phnrec_tpu.io.stknet import parse_stk_network
from phnrec_tpu.netgen import phn_list_to_hmm_defs


@pytest.fixture(scope="module")
def cz_models(tmp_path_factory, seeded_phonemes):
    d = tmp_path_factory.mktemp("mmf")
    phn_list_to_hmm_defs(seeded_phonemes, str(d / "models"), 3)
    return parse_mmf(str(d / "models"))


def _rand_logpost(T: int, D: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.random((T, D)).astype(np.float32) + 1e-3
    p /= p.sum(axis=1, keepdims=True)
    return np.log(p)


def test_deep_null_chain_compiles_and_decodes(cz_models):
    """A 10k-deep chain of null nodes between two models (a = p00,
    b = p01 of the seeded phoneme list): the old
    recursive walk would blow the Python recursion limit."""
    depth = 10_000
    lines = ["I=0 W=!NULL E=1", "I=1 M=p00 E=2"]
    for i in range(depth):
        nid = 2 + i
        w = "W=!NULL" if i % 500 else "W=chain"
        lines.append(f"I={nid} {w} E={nid + 1}")
    last_null = 2 + depth
    lines.append(f"I={last_null} M=p01 E={last_null + 1}")
    lines.append(f"I={last_null + 1} W=!NULL")
    net = parse_stk_network("\n".join(lines), is_text=True)
    dec = StkNetworkDecoder(cz_models, net, wpenalty=-1.0, lm_scale=1.0)
    # exactly one a->b closure edge survives the chain, carrying the
    # 'chain' words crossed along it
    ab = [e for e in dec.compiled.closure if e.src == 0 and e.dst == 1]
    assert len(ab) == 1
    assert ab[0].words.count("chain") == 20
    labels = dec.decode(_rand_logpost(40, cz_models.vec_size))
    assert labels, "decode through the chain produced nothing"


def test_diamond_null_lattice_compiles(cz_models):
    """A 2-wide x 24-deep fully-connected null lattice has 2^24 distinct
    paths; memoized relaxation must compile it in O(V*E) with one edge
    per (src, dst) pair."""
    layers = 24
    decl = {0: "W=!NULL", 1: "M=p00"}
    arcs = {0: ["E=1"], 1: []}
    nid = 2
    prev = [1]
    for _ in range(layers):
        cur = [nid, nid + 1]
        nid += 2
        for c in cur:
            decl[c] = "W=!NULL"
            arcs[c] = []
        for p in prev:
            arcs[p].extend(f"E={c} l={-0.1 * (c % 3):g}" for c in cur)
        prev = cur
    decl[nid] = "M=p01"
    arcs[nid] = [f"E={nid + 1}"]
    decl[nid + 1] = "W=!NULL"
    arcs[nid + 1] = []
    for p in prev:
        arcs[p].append(f"E={nid}")
    lines = [f"I={i} {decl[i]} " + " ".join(arcs[i]) for i in sorted(decl)]
    net = parse_stk_network("\n".join(lines), is_text=True)
    c = compile_network(net, cz_models, wpenalty=-1.0, lm_scale=1.0)
    ab = [e for e in c.closure if e.src == 0 and e.dst == 1]
    assert len(ab) == 1          # memoized: one best edge, not 2^24
    # best path takes the max-score (least-negative) arc at every layer
    want = sum(max(-0.1 * ((2 + 2 * li) % 3),
                   -0.1 * ((3 + 2 * li) % 3)) for li in range(layers))
    assert ab[0].score == pytest.approx(want, abs=1e-6)


def test_null_cycle_converges_and_positive_cycle_raises(cz_models):
    base = """\
I=0 W=!NULL E=1
I=1 M=p00 E=2
I=2 W=!NULL E=3
I=3 W=!NULL E=2 {cyc} E=4
I=4 M=p01 E=5
I=5 W=!NULL
"""
    # zero-score cycle 2->3->2: converges (strict-improvement relaxation)
    net = parse_stk_network(base.format(cyc=""), is_text=True)
    c = compile_network(net, cz_models, wpenalty=-1.0, lm_scale=1.0)
    assert [e for e in c.closure if e.src == 0 and e.dst == 1]
    # positive-score cycle: a token would gain like within one frame
    netp = parse_stk_network(base.format(cyc="l=2.5"), is_text=True)
    with pytest.raises(ValueError, match="cycle"):
        compile_network(netp, cz_models, wpenalty=-1.0, lm_scale=1.0)


def _gmm_mmf(rng, n_models: int, dim: int) -> str:
    """DiagC MMF with varied mixture counts (1/2/4) so stacked scoring
    exercises multiple shape groups."""
    out = [f"~o <VecSize> {dim} <DIAGC>"]
    for i in range(n_models):
        n_mix = [1, 2, 4][i % 3]
        out.append(f'~h "m{i}"\n<BEGINHMM>\n<NUMSTATES> 4')
        for s in (2, 3):
            out.append(f"<STATE> {s} <NUMMIXES> {n_mix}")
            w = rng.random(n_mix) + 0.1
            w /= w.sum()
            for m in range(1, n_mix + 1):
                out.append(f"<MIXTURE> {m} {w[m - 1]:.6f}")
                mu = rng.normal(0, 2, dim)
                var = rng.random(dim) + 0.2
                out.append("<MEAN> %d\n %s" % (
                    dim, " ".join(f"{x:.6f}" for x in mu)))
                out.append("<VARIANCE> %d\n %s" % (
                    dim, " ".join(f"{x:.6f}" for x in var)))
        out.append("<TRANSP> 4\n 0.0 1.0 0.0 0.0\n 0.0 0.5 0.5 0.0\n"
                   " 0.0 0.0 0.5 0.5\n 0.0 0.0 0.0 0.0\n<ENDHMM>")
    return "\n".join(out) + "\n"


def test_stacked_gmm_large_offset_precision(tmp_path):
    """Features with a big common DC offset (e.g. raw log energies):
    the expanded quadratic form must stay accurate — the group-mean
    centering in _gmm_groups removes the cancellation that a naive
    o2-2om+mm evaluation would suffer in f32."""
    rng = np.random.default_rng(13)
    dim, n_models, off = 4, 6, 1000.0
    out = [f"~o <VecSize> {dim} <DIAGC>"]
    for i in range(n_models):
        out.append(f'~h "m{i}"\n<BEGINHMM>\n<NUMSTATES> 3')
        out.append("<STATE> 2 <NUMMIXES> 1\n<MIXTURE> 1 1.0")
        mu = off + rng.normal(0, 2, dim)
        var = rng.random(dim) + 0.2
        out.append("<MEAN> %d\n %s" % (dim,
                   " ".join(f"{x:.6f}" for x in mu)))
        out.append("<VARIANCE> %d\n %s" % (dim,
                   " ".join(f"{x:.6f}" for x in var)))
        out.append("<TRANSP> 3\n 0.0 1.0 0.0\n 0.0 0.5 0.5\n"
                   " 0.0 0.0 0.0\n<ENDHMM>")
    mp = tmp_path / "gmmoff.mmf"
    mp.write_text("\n".join(out) + "\n")
    ms = parse_mmf(str(mp))
    lines = ["I=0 W=!NULL " + " ".join(f"E={i + 1}"
                                       for i in range(n_models))]
    for i in range(n_models):
        lines.append(f"I={i + 1} M=m{i} E={n_models + 1}")
    lines.append(f"I={n_models + 1} W=!NULL")
    net = parse_stk_network("\n".join(lines), is_text=True)
    c = compile_network(net, ms, wpenalty=0.0, lm_scale=1.0)
    dec = NetworkDecoder(c)
    obs = (off + rng.normal(0, 2, (11, dim))).astype(np.float32)
    got = np.asarray(dec.state_observations(obs))
    for e in range(c.n_states):
        g = c.gmm_states[int(c.gmm_index[e])]
        q = (((obs.astype(np.float64)[:, None, :]
               - g.means.astype(np.float64)[None]) ** 2)
             / g.variances[None]).sum(-1)
        want = (np.log(g.weights)[None]
                - 0.5 * (g.gconsts[None] + q))[:, 0]
        np.testing.assert_allclose(got[:, e], want, rtol=1e-4, atol=1e-3)


def test_stacked_gmm_scoring_matches_per_state(tmp_path):
    """state_observations stacks same-shape GMM states into [G, M, D]
    einsums; values must match the direct per-state density
    (DiagCGaussianMixtureDensity, Viterbi.cc:719-755)."""
    rng = np.random.default_rng(11)
    dim, n_models = 5, 12
    mp = tmp_path / "gmm.mmf"
    mp.write_text(_gmm_mmf(rng, n_models, dim))
    ms = parse_mmf(str(mp))
    lines = ["I=0 W=!NULL " + " ".join(f"E={i + 1}"
                                       for i in range(n_models))]
    for i in range(n_models):
        lines.append(f"I={i + 1} M=m{i} E={n_models + 1}")
    lines.append(f"I={n_models + 1} W=!NULL")
    net = parse_stk_network("\n".join(lines), is_text=True)
    c = compile_network(net, ms, wpenalty=0.0, lm_scale=1.0)
    assert len(c.gmm_states) == n_models * 2
    assert len({g.means.shape for g in c.gmm_states}) == 3
    dec = NetworkDecoder(c)
    obs = rng.normal(0, 2, (17, dim)).astype(np.float32)
    got = np.asarray(dec.state_observations(obs))
    # direct per-state reference
    for e in range(c.n_states):
        gi = int(c.gmm_index[e])
        assert gi >= 0
        g = c.gmm_states[gi]
        q = (((obs[:, None, :] - g.means[None]) ** 2)
             / g.variances[None]).sum(-1)
        comp = np.log(g.weights)[None] - 0.5 * (g.gconsts[None] + q)
        m = comp.max(axis=1, keepdims=True)
        want = (m + np.log(np.exp(comp - m).sum(axis=1, keepdims=True)))[:, 0]
        np.testing.assert_allclose(got[:, e], want, rtol=2e-4, atol=2e-4)


TEE_MMF = """\
~o <VecSize> 6 <PDFObsVec>
~h "x"
<BEGINHMM>
<NUMSTATES> 4
<STATE> 2 <ObsCoef> 1
<STATE> 3 <ObsCoef> 2
<TRANSP> 4
 0.0 0.6 0.0 0.4
 0.0 0.5 0.5 0.0
 0.0 0.0 0.5 0.5
 0.0 0.0 0.0 0.0
<ENDHMM>
~h "y"
<BEGINHMM>
<NUMSTATES> 4
<STATE> 2 <ObsCoef> 3
<STATE> 3 <ObsCoef> 4
<TRANSP> 4
 0.0 1.0 0.0 0.0
 0.0 0.5 0.5 0.0
 0.0 0.0 0.5 0.5
 0.0 0.0 0.0 0.0
<ENDHMM>
~h "z"
<BEGINHMM>
<NUMSTATES> 4
<STATE> 2 <ObsCoef> 5
<STATE> 3 <ObsCoef> 6
<TRANSP> 4
 0.0 1.0 0.0 0.0
 0.0 0.5 0.5 0.0
 0.0 0.0 0.5 0.5
 0.0 0.0 0.0 0.0
<ENDHMM>
"""


def test_tee_model_passthrough(tmp_path, cz_models):
    """Model 'x' is a TEE (entry->exit prob 0.4): a y -> x -> z chain
    must compile a y -> z closure edge carrying ln(0.4), so a token can
    cross x within one frame as STK's tee handling allows."""
    mp = tmp_path / "tee.mmf"
    mp.write_text(TEE_MMF)
    ms = parse_mmf(str(mp))
    net_text = """\
I=0 W=!NULL E=1
I=1 M=y E=2
I=2 W=!NULL E=3
I=3 M=x E=4
I=4 W=!NULL E=5
I=5 M=z E=6
I=6 W=!NULL
"""
    net = parse_stk_network(net_text, is_text=True)
    c = compile_network(net, ms, wpenalty=-1.0, lm_scale=1.0)
    names = c.model_names
    yi, xi, zi = names.index("y"), names.index("x"), names.index("z")
    yz = [e for e in c.closure if e.src == yi and e.dst == zi]
    assert len(yz) == 1
    assert yz[0].score == pytest.approx(float(np.log(0.4)), abs=1e-6)
    # the normal entry edge into the tee also exists
    assert [e for e in c.closure if e.src == yi and e.dst == xi]
    # and the decoder runs end-to-end over the network
    dec = NetworkDecoder(c)
    labels = dec.decode(_rand_logpost(30, 6, seed=3))
    assert isinstance(labels, list)
