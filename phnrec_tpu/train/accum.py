"""Fixed-shape re-estimation accumulators + utterance accumulation.

Device equivalent of STK's per-mixture/per-transition accumulators
(allocated by ModelSet::AllocateAccumulatorsForXformStats and filled by
ReestState / the FWBWRet machinery in STKLib/Viterbi.cc:1124-1240): one
pytree of dense arrays shaped by the ModelIndex, identical for every
utterance, so they vmap over a batch and `psum` across a data mesh.

Statistics (per model state j, mixture m — Models.h accumulator layout:
occupancy, first- and second-order sums):

  occ[j, m]     = sum_t gamma_jm(t)
  sum_x[j, m]   = sum_t gamma_jm(t) x_t
  sum_xx[j, m]  = sum_t gamma_jm(t) x_t^2
  trans[h, i, k] = expected transition counts routed through the graph's
                   COO edge table (cross-HMM arcs count toward both the
                   exit and entry cells, mirroring how STK splits network
                   arc occupancy between transition matrices).

The transition xi sums use the matmul identity
  xi_sum[i, j] = exp(log_A[i, j]) * sum_t a~_t[i] * b~_{t+1}[j]
with per-frame renormalized a~/b~ (both bounded by construction), so the
whole T-frame xi accumulation is ONE [S, T] x [T, S] GEMM instead of a
T-step loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu.train.fb import (AlignResult, FBResult, ObsTables,
                                 forward_backward, log_obs, make_obs_tables,
                                 viterbi_align)
from phnrec_tpu.train.graph import ModelIndex, TrainGraph


class Accumulators(NamedTuple):
    occ: jnp.ndarray                   # [NS, M] mixture occupancies
    sum_x: Optional[jnp.ndarray]       # [NS, M, D] (None without GMMs)
    sum_xx: Optional[jnp.ndarray]      # [NS, M, D]
    trans: jnp.ndarray                 # [H, N, N] transition counts
    n_frames: jnp.ndarray              # [] weighted frame count
    total_log_like: jnp.ndarray        # [] sum of utterance log-likes
    n_utts: jnp.ndarray                # [] utterance count


def make_accumulators(index: ModelIndex) -> Accumulators:
    NS = index.n_model_states
    M = index.gmm_weights.shape[1] if index.gmm_weights is not None else 1
    has_gmm = index.gmm_weights is not None
    D = index.gmm_means.shape[2] if has_gmm else 0
    z = jnp.zeros
    return Accumulators(
        occ=z((NS, M), jnp.float32),
        sum_x=z((NS, M, D), jnp.float32) if has_gmm else None,
        sum_xx=z((NS, M, D), jnp.float32) if has_gmm else None,
        trans=z((index.n_hmms, index.max_states, index.max_states),
                jnp.float32),
        n_frames=z((), jnp.float32),
        total_log_like=z((), jnp.float32),
        n_utts=z((), jnp.float32))


def merge_accumulators(a: Accumulators, b: Accumulators) -> Accumulators:
    return jax.tree_util.tree_map(jnp.add, a, b)


def psum_accumulators(acc: Accumulators, axis_name: str) -> Accumulators:
    """All-reduce accumulators over a mesh axis (inside shard_map/pmap)."""
    return jax.tree_util.tree_map(
        lambda x: jax.lax.psum(x, axis_name), acc)


def _gamma_stats(graph: TrainGraph, tables: ObsTables, x: jnp.ndarray,
                 log_gamma: jnp.ndarray, log_bm: Optional[jnp.ndarray],
                 log_b: jnp.ndarray, valid: jnp.ndarray, weight):
    """Shared ML statistics from state-level log occupancies [T, S]."""
    idx = graph.index
    sm = jnp.asarray(graph.state_model)
    gamma = jnp.where(valid[:, None], jnp.exp(log_gamma), 0.0) * weight

    if log_bm is not None:
        # mixture responsibilities within each state: softmax of log_bm
        resp = jnp.exp(log_bm - log_b[:, :, None])       # [T, S, M]
        resp = jnp.where(jnp.isfinite(resp), resp, 0.0)
        is_gmm = tables.is_gmm[None, :, None]
        gm = gamma[:, :, None] * jnp.where(is_gmm, resp, 0.0)
        occ_g = gm.sum(0)                                 # [S, M]
        sx_g = jnp.einsum("tsm,td->smd", gm, x)
        sxx_g = jnp.einsum("tsm,td->smd", gm, x * x)
        # PDFObsVec states keep their state-level occupancy in column 0
        occ_g = occ_g.at[:, 0].add(
            jnp.where(tables.is_gmm, 0.0, gamma.sum(0)))
    else:
        occ_g = gamma.sum(0)[:, None]
        sx_g = sxx_g = None

    NS = idx.n_model_states
    M = occ_g.shape[1]
    occ = jnp.zeros((NS, M), jnp.float32).at[sm].add(occ_g)
    sum_x = sum_xx = None
    if sx_g is not None:
        D = x.shape[1]
        sum_x = jnp.zeros((NS, M, D), jnp.float32).at[sm].add(sx_g)
        sum_xx = jnp.zeros((NS, M, D), jnp.float32).at[sm].add(sxx_g)
    return occ, sum_x, sum_xx, gamma


def _route_trans(graph: TrainGraph, xi: jnp.ndarray, gamma0: jnp.ndarray,
                 gammaN: jnp.ndarray) -> jnp.ndarray:
    """COO-scatter xi/entry/exit counts onto [H, N, N] accumulators."""
    idx = graph.index
    tr = jnp.zeros((idx.n_hmms, idx.max_states, idx.max_states), jnp.float32)
    e_src = jnp.asarray(graph.e_src)
    tr = tr.at[jnp.asarray(graph.e_hmm), jnp.asarray(graph.e_row),
               jnp.asarray(graph.e_col)].add(
        xi[e_src, jnp.asarray(graph.e_dst)])
    tr = tr.at[jnp.asarray(graph.en_hmm), jnp.asarray(graph.en_row),
               jnp.asarray(graph.en_col)].add(
        gamma0[jnp.asarray(graph.en_state)])
    tr = tr.at[jnp.asarray(graph.ex_hmm), jnp.asarray(graph.ex_row),
               jnp.asarray(graph.ex_col)].add(
        gammaN[jnp.asarray(graph.ex_state)])
    return tr


def accumulate_utterance(graph: TrainGraph, acc: Accumulators,
                         x: jnp.ndarray, n_frames, weight=1.0,
                         mode: str = "baum_welch") -> Accumulators:
    """One utterance of Baum-Welch ('baum_welch', BaumWelchReest
    Viterbi.h:259) or hard-alignment ('viterbi', ViterbiReest
    Viterbi.h:256) statistics.  ``x`` is [T, D] features (log-posteriors
    for <PDFObsVec> model sets); ``weight`` scales every statistic (the
    utterance weight argument of the Reest entry points, also how MCE
    weighting is applied — see update.mce_weight)."""
    tables = make_obs_tables(graph)
    log_A = jnp.asarray(graph.log_A)
    log_entry = jnp.asarray(graph.log_entry)
    log_exit = jnp.asarray(graph.log_exit)
    T = x.shape[0]
    n = jnp.asarray(n_frames, jnp.int32)
    valid = jnp.arange(T) < n
    log_b, log_bm = log_obs(tables, x)
    log_b = jnp.where(valid[:, None], log_b, 0.0)
    weight = jnp.float32(weight)

    if mode == "viterbi":
        al: AlignResult = viterbi_align(log_A, log_entry, log_exit,
                                        log_b, n)
        one_hot = jax.nn.one_hot(al.states, log_b.shape[1],
                                 dtype=jnp.float32)
        log_gamma = jnp.where(one_hot > 0, 0.0, -jnp.inf)
        log_like = al.log_like
        # hard transition counts: consecutive (s_t, s_{t+1}) pairs
        nxt = jnp.concatenate([al.states[1:], al.states[-1:]], axis=0)
        pair_valid = (jnp.arange(T) < n - 1)
        xi = jnp.zeros_like(log_A).at[
            jnp.maximum(al.states, 0), jnp.maximum(nxt, 0)].add(
            jnp.where(pair_valid, weight, 0.0))
        gamma0 = one_hot[0] * weight
        gammaN = one_hot[jnp.maximum(n - 1, 0)] * weight
    elif mode == "baum_welch":
        fb: FBResult = forward_backward(log_A, log_entry, log_exit,
                                        log_b, n)
        log_like = fb.log_like
        log_gamma = fb.log_alpha + fb.log_beta - log_like
        # xi via one GEMM with per-frame renormalization (see module doc)
        c = jax.scipy.special.logsumexp(fb.log_alpha, axis=1,
                                        keepdims=True)       # [T, 1]
        a_n = jnp.where(valid[:, None], jnp.exp(fb.log_alpha - c), 0.0)
        # pair t -> t+1: a~_t rows 0..T-2 against b~_{t+1}; b~ carries the
        # matching c_t (c[:-1]) so the product is exactly exp(xi - A)
        a_shift = a_n[:-1]                                   # a~_t
        b_shift = jnp.exp(
            jnp.where((jnp.arange(1, T) < n)[:, None],
                      fb.log_beta[1:] + log_b[1:] + c[:-1] - log_like,
                      -jnp.inf))
        xi = jnp.exp(jnp.asarray(graph.log_A)) * (
            a_shift.T @ b_shift) * weight
        gamma = jnp.exp(log_gamma)
        gamma0 = jnp.where(valid[0], gamma[0], 0.0) * weight
        gammaN = gamma[jnp.maximum(n - 1, 0)] * weight
    else:
        raise ValueError(f"unknown accumulation mode {mode!r}")

    occ, sum_x, sum_xx, _ = _gamma_stats(
        graph, tables, x, log_gamma, log_bm, log_b, valid, weight)
    trans = _route_trans(graph, xi, gamma0, gammaN)

    upd = Accumulators(
        occ=occ, sum_x=sum_x, sum_xx=sum_xx, trans=trans,
        n_frames=weight * n.astype(jnp.float32),
        total_log_like=log_like, n_utts=jnp.float32(1.0))
    return merge_accumulators(acc, upd)


def save_accumulators(acc: Accumulators, path: str) -> None:
    """Persist accumulators for parallel/distributed training (STK dumps
    per-job accumulator files consumed by UpdateFromAccums(pOutputDir),
    Models.h:473); merge shards with merge_accumulators after loading."""
    arrs = {}
    for name, a in zip(Accumulators._fields, acc):
        if a is not None:
            arrs[name] = np.asarray(a)
    np.savez(path, **arrs)


def load_accumulators(path: str) -> Accumulators:
    z = np.load(path)
    return Accumulators(*(jnp.asarray(z[name]) if name in z else None
                          for name in Accumulators._fields))
