"""Forward-backward over the phoneme loop (sum semiring).

The bundled STK toolkit carries full forward-backward / Baum-Welch
machinery that phnrec itself never calls (Network::ForwardBackward,
STKLib/Viterbi.cc:2115+; the sum-semiring token pass PassTokenSum,
Viterbi.cc:603-646).  This module provides the device equivalent for
the phoneme-loop topology: exact log-domain forward/backward as `lax.scan`s
over frames with log-sum-exp combination (LogAdd, STKLib/common.C:237-250),
yielding per-frame state occupancies gamma — the statistic Baum-Welch /
MPE re-estimation consumes, and a soft alternative to the Viterbi
one-best (useful for confidence scoring and posterior re-estimation).

Topology identical to decoder/phnloop.py: P phonemes x S states,
self-loop/advance log-probs (default log 0.5 each, phndec.cpp:9), loop
re-entry from every exit state to every entry state with the insertion
penalty added (phndec.cpp:121-144), entry seeded with the penalty at t=0
(the reference quirk, phndec.cpp:81-88).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu.decoder.phnloop import NEG_INF, PhnLoopSpec


class FBResult(NamedTuple):
    log_alpha: jnp.ndarray   # [T, P, S] forward scores
    log_beta: jnp.ndarray    # [T, P, S] backward scores
    log_gamma: jnp.ndarray   # [T, P, S] normalized occupancies
    log_like: jnp.ndarray    # [] total log-likelihood of the loop


def _lse(a, b):
    return jnp.logaddexp(a, b)


@partial(jax.jit, static_argnums=(0,))
def forward_backward(spec: PhnLoopSpec, log_post: jnp.ndarray) -> FBResult:
    """[T, >=P*S] log-posteriors -> exact loop occupancies.

    Forward recurrence (sum analogue of PropagateInModels/Network,
    phndec.cpp:96-144 with max -> logaddexp):
      a_t[p,0]   = lse(a_{t-1}[p,0]+tr_c, entry_{t-1}) + obs_t[p,0]
      a_t[p,s]   = lse(a_{t-1}[p,s]+tr_c, a_{t-1}[p,s-1]+tr_n) + obs_t[p,s]
      entry_t    = lse_p(a_t[p,S-1] + tr_n) + w_penalty
    (exit->entry uses the advance probability, matching the Viterbi path
    structure where leaving the last emitting state costs tr_next).
    """
    P, S = spec.n_phonemes, spec.n_states
    T = log_post.shape[0]
    obs = log_post[:, : P * S].reshape(T, P, S)
    tr_c = jnp.float32(spec.log_tr_curr)
    tr_n = jnp.float32(spec.log_tr_next)
    w_pen = jnp.float32(spec.w_penalty)

    def fwd_step(carry, obs_t):
        alpha, entry = carry  # alpha [P,S], entry scalar (pre-obs, at t-1)
        stay = alpha + tr_c
        adv = jnp.concatenate(
            [jnp.full((P, 1), NEG_INF, jnp.float32), alpha[:, :-1] + tr_n],
            axis=1)
        inc = jnp.concatenate(
            [jnp.full((P, 1), entry, jnp.float32),
             jnp.full((P, S - 1), NEG_INF, jnp.float32)], axis=1)
        new_alpha = _lse(_lse(stay, adv), inc) + obs_t
        new_entry = jax.scipy.special.logsumexp(
            new_alpha[:, -1] + tr_n) + w_pen
        return (new_alpha, new_entry), new_alpha

    alpha0 = jnp.full((P, S), NEG_INF, jnp.float32)
    # reference quirk: the entry node already holds w_penalty at t=0
    (alpha_T, entry_T), log_alpha = jax.lax.scan(
        fwd_step, (alpha0, w_pen), obs)

    # total likelihood: sum over exit states at T (tokens that would leave)
    log_like = jax.scipy.special.logsumexp(alpha_T[:, -1])

    def bwd_step(carry, obs_t):
        beta = carry  # [P,S], beta_t (excludes obs_t)
        # transitions out of (p,s) at time t: stay, advance, exit->re-entry
        b_obs = beta + obs_t                       # beta_t * obs_t
        stay = b_obs + tr_c
        adv = jnp.concatenate(
            [b_obs[:, 1:] + tr_n,
             jnp.full((P, 1), NEG_INF, jnp.float32)], axis=1)
        # exit states additionally feed every entry state via the loop node
        reentry = jax.scipy.special.logsumexp(b_obs[:, 0]) + w_pen
        exit_extra = jnp.concatenate(
            [jnp.full((P, S - 1), NEG_INF, jnp.float32),
             jnp.full((P, 1), tr_n + reentry, jnp.float32)], axis=1)
        prev_beta = _lse(_lse(stay, adv), exit_extra)
        return prev_beta, beta

    # at T: only exit states terminate (match the forward termination)
    beta_T = jnp.concatenate(
        [jnp.full((P, S - 1), NEG_INF, jnp.float32),
         jnp.zeros((P, 1), jnp.float32)], axis=1)
    _, log_beta_rev = jax.lax.scan(bwd_step, beta_T, obs[::-1])
    log_beta = log_beta_rev[::-1]

    log_gamma = log_alpha + log_beta - log_like
    return FBResult(log_alpha=log_alpha, log_beta=log_beta,
                    log_gamma=log_gamma, log_like=log_like)


def occupancies(spec: PhnLoopSpec, log_post, per_phoneme: bool = True
                ) -> np.ndarray:
    """Per-frame posterior state occupancies (linear domain, rows sum to 1).

    per_phoneme=True marginalizes over states -> [T, P]."""
    r = forward_backward(spec, jnp.asarray(log_post))
    g = np.exp(np.asarray(r.log_gamma, np.float64))
    return g.sum(axis=2) if per_phoneme else g
