"""Batched forward-backward / Viterbi alignment over dense training graphs.

Device equivalent of Network::ForwardBackward (STKLib/Viterbi.cc:2115+)
with PassTokenSum (Viterbi.cc:603-646) and the Viterbi alignment pass with
PassTokenMax (Viterbi.cc:543-567): the per-node token loops become one
[S, S] log-matmul per frame inside `lax.scan`.  Observation log-probs are
either posterior lookups (<PDFObsVec>/<ObsCoef> states, Viterbi.cc:760-768)
or DiagC GMM densities (DiagCGaussianMixtureDensity, Viterbi.cc:719-755),
both precomputed for all frames as one quadratic-form GEMM.

Padded-frame handling: all functions take ``n_frames``; scan steps at
t >= n_frames leave the carry untouched and emit NEG_INF rows, so one
compiled program serves a whole bucket of utterance lengths.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu.train.graph import ModelIndex, TrainGraph

NEG_INF = jnp.float32(-1e30)


class ObsTables(NamedTuple):
    """Device-side per-graph-state observation parameters."""

    obs_coef: jnp.ndarray            # [S] posterior column (-1 = GMM)
    is_gmm: jnp.ndarray              # [S] bool
    # stacked quadratic-form coefficients for log N(x; mu, var):
    #   logN_m(x) = -0.5*(gconst + x^2 . iv - 2 x . miv + mu^2 . iv)
    log_w: Optional[jnp.ndarray]     # [S, M] (NEG_INF pad)
    iv: Optional[jnp.ndarray]        # [S, M, D] 1/var
    miv: Optional[jnp.ndarray]       # [S, M, D] mu/var
    c: Optional[jnp.ndarray]         # [S, M] gconst + sum mu^2/var


def make_obs_tables(graph: TrainGraph) -> ObsTables:
    idx: ModelIndex = graph.index
    sm = graph.state_model
    obs_coef = idx.state_obs_coef[sm]
    if idx.gmm_weights is None:
        return ObsTables(jnp.asarray(obs_coef),
                         jnp.asarray(obs_coef < 0), None, None, None, None)
    w = idx.gmm_weights[sm]                       # [S, M]
    mu = idx.gmm_means[sm]
    var = idx.gmm_vars[sm]
    gc = idx.gmm_gconsts[sm]
    nm = idx.gmm_nmix[sm]
    M = w.shape[1]
    valid = np.arange(M)[None, :] < nm[:, None]
    log_w = np.where(valid & (w > 0), np.log(np.maximum(w, 1e-37)),
                     float(NEG_INF)).astype(np.float32)
    iv = (1.0 / var).astype(np.float32)
    miv = (mu / var).astype(np.float32)
    c = np.where(valid, gc + (mu * mu / var).sum(-1), 0.0).astype(np.float32)
    return ObsTables(jnp.asarray(obs_coef), jnp.asarray(obs_coef < 0),
                     jnp.asarray(log_w), jnp.asarray(iv), jnp.asarray(miv),
                     jnp.asarray(c))


def log_obs(tables: ObsTables, x: jnp.ndarray
            ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """[T, D] features (or log-posteriors for <PDFObsVec> states) ->
    (log_b [T, S], per-mixture log_bm [T, S, M] or None)."""
    lookup = x[:, jnp.maximum(tables.obs_coef, 0)]          # [T, S]
    if tables.log_w is None:
        return lookup, None
    S, M, D = tables.iv.shape
    # quadratic form via two GEMMs: x^2 @ iv^T and x @ miv^T
    iv2 = tables.iv.reshape(S * M, D)
    miv2 = tables.miv.reshape(S * M, D)
    q = (jnp.dot(x * x, iv2.T) - 2.0 * jnp.dot(x, miv2.T)
         ).reshape(-1, S, M) + tables.c
    log_bm = tables.log_w - 0.5 * q                          # [T, S, M]
    gmm_b = jax.scipy.special.logsumexp(log_bm, axis=-1)
    log_b = jnp.where(tables.is_gmm, gmm_b, lookup)
    return log_b, log_bm


class FBResult(NamedTuple):
    log_alpha: jnp.ndarray   # [T, S] (NEG_INF beyond n_frames)
    log_beta: jnp.ndarray    # [T, S] (includes the frame's own log_b? NO:
    #                          standard beta — log_b excluded at t itself)
    log_like: jnp.ndarray    # [] total log-likelihood


def forward_backward(log_A: jnp.ndarray, log_entry: jnp.ndarray,
                     log_exit: jnp.ndarray, log_b: jnp.ndarray,
                     n_frames: jnp.ndarray) -> FBResult:
    """Dense-graph forward-backward; all shapes static, length dynamic."""
    T, S = log_b.shape
    n = jnp.asarray(n_frames, jnp.int32)
    ts = jnp.arange(T)

    def fwd_step(alpha, inp):
        t, b_t = inp
        prop = jax.scipy.special.logsumexp(
            alpha[:, None] + log_A, axis=0)
        new = jnp.where(t == 0, log_entry, prop) + b_t
        new = jnp.where(t < n, new, alpha)
        return new, jnp.where(t < n, new, jnp.full((S,), NEG_INF, jnp.float32))

    # init derived from the data so its sharding/varying type matches the
    # scan outputs under shard_map (scan carries must type-match exactly)
    init = jnp.full_like(log_b[0], NEG_INF)
    alpha_last, log_alpha = jax.lax.scan(fwd_step, init, (ts, log_b))
    log_like = jax.scipy.special.logsumexp(alpha_last + log_exit)

    def bwd_step(beta_next, inp):
        t, b_next = inp            # b_next = log_b[t + 1] (junk at t=T-1)
        prop = jax.scipy.special.logsumexp(
            log_A + (b_next + beta_next)[None, :], axis=1)
        new = jnp.where(t == n - 1, log_exit,
                        jnp.where(t < n - 1, prop, beta_next))
        return new, jnp.where(t < n, new, jnp.full((S,), NEG_INF, jnp.float32))

    b_shift = jnp.concatenate([log_b[1:], log_b[-1:]], axis=0)
    _, log_beta_rev = jax.lax.scan(
        bwd_step, jnp.full_like(log_b[0], NEG_INF),
        (ts[::-1], b_shift[::-1]))
    log_beta = log_beta_rev[::-1]
    return FBResult(log_alpha, log_beta, log_like)


class AlignResult(NamedTuple):
    states: jnp.ndarray      # [T] best graph state per frame (-1 padded)
    log_like: jnp.ndarray    # [] Viterbi path score


def viterbi_align(log_A: jnp.ndarray, log_entry: jnp.ndarray,
                  log_exit: jnp.ndarray, log_b: jnp.ndarray,
                  n_frames: jnp.ndarray) -> AlignResult:
    """Max-plus alignment (PassTokenMax, Viterbi.cc:543-567) + traceback."""
    T, S = log_b.shape
    n = jnp.asarray(n_frames, jnp.int32)
    ts = jnp.arange(T)

    def fwd_step(alpha, inp):
        t, b_t = inp
        scores = alpha[:, None] + log_A            # [S_from, S_to]
        bp = jnp.argmax(scores, axis=0)
        prop = jnp.max(scores, axis=0)
        new = jnp.where(t == 0, log_entry, prop) + b_t
        new = jnp.where(t < n, new, alpha)
        return new, (jnp.where(t < n, bp, 0).astype(jnp.int32),
                     jnp.where(t < n, new, jnp.full((S,), NEG_INF, jnp.float32)))

    alpha_last, (bps, _) = jax.lax.scan(
        fwd_step, jnp.full_like(log_b[0], NEG_INF), (ts, log_b))
    final = alpha_last + log_exit
    last_state = jnp.argmax(final).astype(jnp.int32)
    log_like = final[last_state]

    # traceback: walk bps from t = n-1 down to 0.  Seed the carry with the
    # final state; padded steps (t >= n) pass it through unchanged.
    def back(carry, inp):
        t, bp_t = inp
        cur = jnp.where(t == n - 1, last_state, carry)
        out = jnp.where(t < n, cur, -1)
        nxt = jnp.where(t <= n - 1, bp_t[cur], cur)
        return nxt, out

    _, states_rev = jax.lax.scan(
        back, last_state, (ts[::-1], bps[::-1]))
    return AlignResult(states_rev[::-1], log_like)
