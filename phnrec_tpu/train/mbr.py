"""MPE / state-level minimum-Bayes-risk discriminative statistics.

The AT_MPE accumulation type of STK (Viterbi.h:67; the PhoneAccuracy
annotation machinery in Net.cc feeds it) weights denominator-lattice
occupancies by how much each path's local accuracy deviates from the
lattice average.  The tensor formulation here is the frame-state-level
variant (sMBR): over a denominator graph (typically the phoneme loop),

    kappa_t(s) = gamma_t(s) * (A(s, t) - Abar(t))
    A(s, t)    = 1 if state s belongs to the reference phone at frame t
    Abar(t)    = sum_s gamma_t(s) A(s, t)     (expected accuracy)

Positive kappa mass accumulates into the numerator-side statistics and
negative mass (absolute value) into the denominator side; the pair then
feeds the same extended-Baum-Welch update as MMI (train.update.update_mmi)
— the standard MPE/sMBR implementation shape.

Transition statistics are not MBR-weighted (HTK/STK practice: transitions
are re-estimated from the ML/numerator pass).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu.train.accum import Accumulators, _gamma_stats, \
    merge_accumulators
from phnrec_tpu.train.fb import forward_backward, log_obs, make_obs_tables
from phnrec_tpu.train.graph import TrainGraph


def accumulate_utterance_mbr(graph: TrainGraph, acc_num: Accumulators,
                             acc_den: Accumulators, x: jnp.ndarray,
                             ref_hmm_ids: jnp.ndarray, n_frames,
                             weight: float = 1.0
                             ) -> Tuple[Accumulators, Accumulators]:
    """One utterance of sMBR statistics over the denominator ``graph``.

    ``ref_hmm_ids``: [T] hmm id (row into graph.index.names) of the
    reference phone at each frame — produced by a forced alignment of the
    numerator transcription (train.fb.viterbi_align + graph.state_model).
    Returns updated (numerator, denominator) accumulator pytrees for the
    EBW update.
    """
    tables = make_obs_tables(graph)
    T = x.shape[0]
    n = jnp.asarray(n_frames, jnp.int32)
    valid = jnp.arange(T) < n
    log_b, log_bm = log_obs(tables, x)
    log_b = jnp.where(valid[:, None], log_b, 0.0)
    fb = forward_backward(jnp.asarray(graph.log_A),
                          jnp.asarray(graph.log_entry),
                          jnp.asarray(graph.log_exit), log_b, n)
    log_gamma = fb.log_alpha + fb.log_beta - fb.log_like
    gamma = jnp.where(valid[:, None], jnp.exp(log_gamma), 0.0)   # [T, S]

    state_hmm = jnp.asarray(
        graph.index.state_hmm[graph.state_model])                # [S]
    A = (state_hmm[None, :] == jnp.asarray(ref_hmm_ids)[:, None]
         ).astype(jnp.float32)                                   # [T, S]
    abar = jnp.sum(gamma * A, axis=1, keepdims=True)
    kappa = gamma * (A - abar) * jnp.float32(weight)             # signed

    pos = jnp.maximum(kappa, 0.0)
    neg = jnp.maximum(-kappa, 0.0)

    def stats(g):
        lg = jnp.log(jnp.maximum(g, 1e-37))
        lg = jnp.where(g > 0, lg, -jnp.inf)
        occ, sx, sxx, _ = _gamma_stats(graph, tables, x, lg, log_bm,
                                       log_b, valid, jnp.float32(1.0))
        return occ, sx, sxx

    occ_p, sx_p, sxx_p = stats(pos)
    occ_n, sx_n, sxx_n = stats(neg)
    zero_tr = jnp.zeros_like(acc_num.trans)
    upd_num = Accumulators(occ=occ_p, sum_x=sx_p, sum_xx=sxx_p,
                           trans=zero_tr,
                           n_frames=jnp.float32(weight) * n.astype(
                               jnp.float32),
                           total_log_like=fb.log_like,
                           n_utts=jnp.float32(1.0))
    upd_den = Accumulators(occ=occ_n, sum_x=sx_n, sum_xx=sxx_n,
                           trans=zero_tr,
                           n_frames=jnp.zeros(()),
                           total_log_like=jnp.zeros(()),
                           n_utts=jnp.zeros(()))
    return (merge_accumulators(acc_num, upd_num),
            merge_accumulators(acc_den, upd_den))


def reference_hmm_ids(graph: TrainGraph, states: jnp.ndarray) -> np.ndarray:
    """[T] aligned graph states (train.fb.viterbi_align on the NUMERATOR
    graph) -> [T] hmm ids for accumulate_utterance_mbr (padded -1 -> -1)."""
    st = np.asarray(states)
    hmm_of_state = graph.index.state_hmm[graph.state_model]
    out = np.where(st >= 0, hmm_of_state[np.maximum(st, 0)], -1)
    return out.astype(np.int32)
