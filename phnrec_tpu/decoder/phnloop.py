"""Phoneme-loop Viterbi decoder as a vectorized lattice scan.

Reference: PhnDec (phndec.cpp) — a streaming Viterbi over a loop of
left-to-right phoneme HMMs with S states each (shipped configs: 3),
self-loop/advance log-probs both log(0.5) (phndec.cpp:9), word-insertion
penalty on loop re-entry, and — a reference quirk kept for parity — the
insertion penalty already applied at t=0 (phndec.cpp:81-88).

Redesign: the per-phoneme C loops become [P, S, B] tensor ops (batch in
the minor axis) inside one `lax.scan` over frames.  The
scan carries (alphas, entry frames) and emits one history record per frame
— the information PropagateInNetwork pushes into its ring buffer
(phndec.cpp:136): the winning exit token's (phoneme, entry frame, score);
predecessor phoneme and length are derived from the entry frame.  The
fixed-lag ring buffer (TimePruning, phndec.cpp:191-234) exists only to
bound latency/memory in the streaming C++; emitted segments equal a full
backtrack whenever the lag exceeds segment settling time, and `Done`
(phndec.cpp:236-302) is literally a history replay — so batch decode keeps
the whole [T] history and backtracks once on the host.

Tie-breaking parity:
  * within-model: `tok_cur > tok_prev` strictly — ties go to the advancing
    token (phndec.cpp:106),
  * loop argmax: first index wins ties (`tok > max`, phndec.cpp:129) —
    matches jnp.argmax.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu.io.labels import Label

LOG_0_5 = np.float32(-0.69314718055994530941723212145818)
NEG_INF = np.float32(-np.finfo(np.float32).max)  # -FLT_MAX, phndec.cpp:63


class PhnLoopSpec(NamedTuple):
    n_phonemes: int
    n_states: int            # states per phoneme (decoder/num_states_per_phn)
    w_penalty: float
    log_tr_curr: float = float(LOG_0_5)
    log_tr_next: float = float(LOG_0_5)


class History(NamedTuple):
    """Per-frame loop-node records, TIME-MAJOR: arrays of shape [T] for a
    single utterance, [T, B] for a batch.  The winning exit token each
    frame is fully described by (its phoneme, the frame it entered that
    phoneme, its path score); predecessor phoneme and segment length are
    derived: prev_phn[t] = max_phn[ent[t]-1] (-1 when ent == 0) and
    length[t] = t - ent[t] + 1."""

    max_phn: jnp.ndarray    # int8  argmax exit phoneme this frame
    ent: jnp.ndarray        # int32 frame at which that token entered
    alpha: jnp.ndarray      # f32   winning exit score


def init_carry(spec: PhnLoopSpec, batch: int):
    """PhnDec::Init state (phndec.cpp:62-88): -inf alphas, entry column
    seeded with the insertion penalty (the reference's t=0 quirk).

    Layout: [P, S+1, B] — the BATCH is the minor axis, so the step's
    vector work runs along B rather than along the 4-wide state axis."""
    P, S = spec.n_phonemes, spec.n_states
    alphas0 = jnp.full((P, S + 1, batch), NEG_INF,
                       jnp.float32).at[:, 0, :].set(jnp.float32(spec.w_penalty))
    ent0 = jnp.zeros((P, S + 1, batch), jnp.int32)
    return (alphas0, ent0)


@partial(jax.jit, static_argnums=(0, 4))
def viterbi_block(spec: PhnLoopSpec, carry, log_post: jnp.ndarray,
                  t0: jnp.ndarray | int = 0, unroll: int = 1):
    """Scan a block of frames from an explicit carry (streaming chunk or
    whole utterance): [B, T, >=P*S] -> (carry', History [T, B]).

    PDF layout: phoneme p state s (0-based) reads log_post[..., p*S + s]
    (CreatePdfIndexes, phndec.cpp:352-368).

    ``t0`` is the global index of the block's first frame (streaming
    chunks pass their running offset so History.ent stays global); it is
    traced, so chunked calls compile once.

    The batch lives INSIDE the scan step as the minor axis (see
    init_carry): each of the T sequential steps does [P, S, B] vector
    work with B in the minor dimension, and the loop-node argmax is a
    plain axis-0 reduction — no per-row gathers anywhere in the step.
    """
    P, S = spec.n_phonemes, spec.n_states
    B, T = log_post.shape[0], log_post.shape[1]
    w_pen = jnp.float32(spec.w_penalty)
    tr_curr = jnp.float32(spec.log_tr_curr)
    tr_next = jnp.float32(spec.log_tr_next)

    # [B, T, P*S] -> [T, P, S, B]: one transpose outside the scan
    obs = jnp.transpose(log_post[:, :, : P * S].reshape(B, T, P, S),
                        (1, 2, 3, 0))
    tt = jnp.int32(t0) + jnp.arange(T, dtype=jnp.int32)
    p_iota = jnp.arange(P, dtype=jnp.int32)[:, None]

    def step(carry, xs):
        alphas, ent = carry
        obs_t, t = xs

        # PropagateInModels (phndec.cpp:96-119): states update high-to-low,
        # each reading the PREVIOUS frame's value of state j-1 — equivalent
        # to updating all states simultaneously from the old carry.
        tok_cur = alphas[:, 1:, :] + tr_curr          # self-loop
        tok_prev = alphas[:, :-1, :] + tr_next        # advance from j-1
        take_cur = tok_cur > tok_prev
        new_a = jnp.where(take_cur, tok_cur, tok_prev) + obs_t
        new_ent = jnp.where(take_cur, ent[:, 1:, :], ent[:, :-1, :])

        # PropagateInNetwork (phndec.cpp:121-144); argmax keeps the first
        # maximal index, matching the strict `tok > max` loop.
        exit_a = new_a[:, -1, :]                      # [P, B]
        maxi = jnp.argmax(exit_a, axis=0)             # [B]
        max_a = jnp.max(exit_a, axis=0)
        is_max = p_iota == maxi[None, :]
        ent_win = jnp.sum(jnp.where(is_max, new_ent[:, -1, :], 0), axis=0)
        rec = (maxi.astype(jnp.int8), ent_win, max_a)

        entry_a = jnp.broadcast_to((max_a + w_pen)[None, None, :], (P, 1, B))
        entry_e = jnp.broadcast_to((t + 1)[None, None, None], (P, 1, B))
        alphas = jnp.concatenate([entry_a, new_a], axis=1)
        ent = jnp.concatenate([entry_e, new_ent], axis=1)
        return (alphas, ent), rec

    carry, recs = jax.lax.scan(step, carry, (obs, tt), unroll=unroll)
    return carry, History(*recs)


@partial(jax.jit, static_argnums=(0, 5))
def viterbi_block_ragged(spec: PhnLoopSpec, carry, log_post: jnp.ndarray,
                         t0: jnp.ndarray, n_valid: jnp.ndarray,
                         unroll: int = 8):
    """Per-row masked block scan for MULTI-STREAM serving: each batch row
    is an independent stream at its own global frame offset, and only the
    first ``n_valid[b]`` rows of ``log_post[b]`` are real frames this
    block — rows past that pass the carry through untouched, so streams
    can advance unevenly (a stalled stream just idles).

    log_post: [B, T, >=P*S];  t0: [B] global index of each row's first
    frame this block;  n_valid: [B] frames consumed per row (<= T).
    Returns (carry', History [T, B]) — history rows >= n_valid[b] in
    column b are garbage; the caller tracks validity.

    Semantics per row match viterbi_block (PhnDec, phndec.cpp:96-158);
    masking only gates the carry update, mirroring how the reference's
    per-stream decoder objects simply do not get called for idle streams
    (srec.cpp:793-849 drives one decoder per source).
    """
    P, S = spec.n_phonemes, spec.n_states
    B, T = log_post.shape[0], log_post.shape[1]
    w_pen = jnp.float32(spec.w_penalty)
    tr_curr = jnp.float32(spec.log_tr_curr)
    tr_next = jnp.float32(spec.log_tr_next)

    obs = jnp.transpose(log_post[:, :, : P * S].reshape(B, T, P, S),
                        (1, 2, 3, 0))
    i_blk = jnp.arange(T, dtype=jnp.int32)
    # [T, B] per-row global frame index + liveness
    tt = t0[None, :].astype(jnp.int32) + i_blk[:, None]
    live = i_blk[:, None] < n_valid[None, :].astype(jnp.int32)
    p_iota = jnp.arange(P, dtype=jnp.int32)[:, None]

    def step(carry, xs):
        alphas, ent = carry
        obs_t, t, lv = xs                       # t, lv: [B]

        tok_cur = alphas[:, 1:, :] + tr_curr
        tok_prev = alphas[:, :-1, :] + tr_next
        take_cur = tok_cur > tok_prev
        new_a = jnp.where(take_cur, tok_cur, tok_prev) + obs_t
        new_ent = jnp.where(take_cur, ent[:, 1:, :], ent[:, :-1, :])

        exit_a = new_a[:, -1, :]
        maxi = jnp.argmax(exit_a, axis=0)
        max_a = jnp.max(exit_a, axis=0)
        is_max = p_iota == maxi[None, :]
        ent_win = jnp.sum(jnp.where(is_max, new_ent[:, -1, :], 0), axis=0)
        rec = (maxi.astype(jnp.int8), ent_win, max_a)

        entry_a = jnp.broadcast_to((max_a + w_pen)[None, None, :],
                                   (P, 1, B))
        entry_e = jnp.broadcast_to((t + 1)[None, None, :], (P, 1, B))
        na = jnp.concatenate([entry_a, new_a], axis=1)
        ne = jnp.concatenate([entry_e, new_ent], axis=1)
        # dead rows keep their carry (B is the minor axis, so this
        # broadcast-where is elementwise)
        alphas = jnp.where(lv[None, None, :], na, alphas)
        ent = jnp.where(lv[None, None, :], ne, ent)
        return (alphas, ent), rec

    # the step is a handful of [P, S, B] vector ops — latency-, not
    # width-bound — so loop-iteration overhead dominates long streams;
    # unrolling amortizes it (multi-stream serving runs ~100 frames of
    # scan per audio-second regardless of stream count)
    carry, recs = jax.lax.scan(step, carry, (obs, tt, live),
                               unroll=unroll)
    return carry, History(*recs)


def viterbi_scan_batch(spec: PhnLoopSpec, log_post: jnp.ndarray) -> History:
    """Whole-utterance batch decode: [B, T, >=P*S] -> History [T, B]."""
    _, hist = viterbi_block(spec, init_carry(spec, log_post.shape[0]),
                            log_post)
    return hist


def viterbi_scan(spec: PhnLoopSpec, log_post: jnp.ndarray) -> History:
    """Single-utterance wrapper: [T, >=P*S] -> History arrays [T]."""
    hist = viterbi_scan_batch(spec, log_post[None])
    return History(*(a[:, 0] for a in hist))


def backtrack(hist: History, phonemes: List[str]) -> List[Label]:
    """Full-history replay of PhnDec::Done (phndec.cpp:236-302).

    Segment likes are alpha deltas between consecutive phoneme ends
    (initial mPrevAlpha = 0, phndec.cpp:91).  Each hop lands on the
    winning record at the segment's end frame; its entry frame is the
    next (earlier) segment's end, and the predecessor phoneme is that
    frame's argmax — the chain always passes through per-frame winners.
    (The degenerate window parameters make backtrack_committed exactly
    this replay — one walk implementation to maintain.)
    """
    return backtrack_committed(hist, 0, 0, 0.0, phonemes)


def backtrack_committed(hist: History, row_offset: int, frame0: int,
                        alpha0: float, phonemes: List[str]) -> List[Label]:
    """backtrack() over a RETAINED history window: row i holds the
    record of global frame ``row_offset + i``; the walk stops at the
    committed boundary ``frame0`` (the fixed-lag forced-commit point,
    TimePruning semantics phndec.cpp:191-234), clamping the earliest
    label's start to it, and uses ``alpha0`` (the committed path's
    cumulative like at frame0) for the boundary segment's delta.  With
    row_offset == frame0 == 0 and alpha0 == 0 this is exactly
    backtrack()."""
    max_phn = np.asarray(hist.max_phn)
    ent = np.asarray(hist.ent)
    alpha = np.asarray(hist.alpha)
    T = max_phn.shape[0]
    end = row_offset + T
    labels: List[Label] = []
    while end > frame0:
        i = end - 1 - row_offset
        phn = int(max_phn[i])
        if phn < 0:
            break
        start = max(int(ent[i]), frame0)     # forced-commit clamp
        prev_alpha = (alpha0 if start <= frame0
                      else float(alpha[start - 1 - row_offset]))
        labels.append(Label(start, end, phonemes[phn],
                            float(alpha[i]) - prev_alpha))
        end = start
    labels.reverse()
    return labels


def backtrack_batch(hist: History, n_frames: np.ndarray,
                    phonemes: List[str]) -> List[List[Label]]:
    """Batched backtrack over [T, B] history arrays (columns valid up to
    n_frames[b]).  Uses the native C++ kernel when built (one call for
    the whole batch instead of B Python loops); falls back to the
    per-row Python replay."""
    from phnrec_tpu import native

    max_phn = np.asarray(hist.max_phn)
    if max_phn.ndim != 2:
        raise ValueError("backtrack_batch expects [T, B] histories")
    T = max_phn.shape[0]
    if native.available() and T > 0:
        # the native kernel consumes the (prev_phn, length) form in [B, T]
        ent = np.asarray(hist.ent)
        length = np.arange(T, dtype=np.int64)[:, None] - ent + 1
        prev_phn = np.where(ent > 0,
                            np.take_along_axis(
                                max_phn.astype(np.int32),
                                np.maximum(ent - 1, 0), axis=0), -1)
        segs = native.backtrack_batch(
            max_phn.T.astype(np.int32), prev_phn.T.astype(np.int32),
            length.T.astype(np.int32), np.asarray(hist.alpha).T,
            np.asarray(n_frames))
        return [
            [Label(int(s), int(e), phonemes[p], float(lk))
             for s, e, p, lk in zip(*row)]
            for row in segs
        ]
    return [
        backtrack(History(*(np.asarray(a)[: int(n_frames[b]), b]
                            for a in hist)), phonemes)
        for b in range(max_phn.shape[1])
    ]


def decode(spec: PhnLoopSpec, log_post: jnp.ndarray,
           phonemes: List[str]) -> List[Label]:
    return backtrack(viterbi_scan(spec, log_post), phonemes)


class Segments(NamedTuple):
    """Compacted device-side backtrack output, segments in REVERSE time
    order (segment 0 ends at n_frames).  Shapes [B] / [B, Smax]."""

    count: jnp.ndarray      # [B] number of valid segments
    phn: jnp.ndarray        # [B, Smax] int8 phoneme id
    start: jnp.ndarray      # [B, Smax] start frame
    alpha_end: jnp.ndarray  # [B, Smax] path score at the segment's last frame


def max_segments(spec: PhnLoopSpec, max_frames: int) -> int:
    """A settled phoneme must traverse all S emitting states, one frame
    each minimum, so an utterance of T frames has at most ceil(T/S)
    segments (plus 1 slack for the t=0 entry quirk)."""
    return max_frames // spec.n_states + 1


def backtrack_device_committed(spec: PhnLoopSpec, hist: History,
                               n_frames: jnp.ndarray,
                               frame0: jnp.ndarray,
                               row_offset: jnp.ndarray,
                               unroll: int = 4) -> Segments:
    """backtrack_device over a RETAINED window: row i of ``hist`` holds
    global frame ``row_offset[b] + i`` of stream b; the walk stops at the
    committed boundary ``frame0[b]`` (global), clamping the earliest
    segment's start to it (the forced-commit clamp of
    backtrack_committed).  History.ent values are GLOBAL; they are
    rebased to window rows on device (clipped at the boundary), so the
    packing headroom constrains only the WINDOW length, not the session.
    Emitted Segments carry window-relative starts; callers add
    row_offset back when formatting."""
    f0r = jnp.maximum(frame0 - row_offset, 0).astype(jnp.int32)  # [B]
    ent_rel = jnp.maximum(
        hist.ent - row_offset[None, :].astype(hist.ent.dtype),
        f0r[None, :]).astype(jnp.int32)
    return _backtrack_device_impl(
        spec, History(hist.max_phn, ent_rel, hist.alpha), n_frames, f0r,
        unroll)


def backtrack_device(spec: PhnLoopSpec, hist: History,
                     n_frames: jnp.ndarray, unroll: int = 4) -> Segments:
    """PhnDec::Done (phndec.cpp:236-302) as an on-device reverse scan.

    The host replay chases (prev_phn, length) pointers backward with
    data-dependent hops.  On the device that becomes a scan over SEGMENT slots
    (at most T/S of them — a settled phoneme occupies all S states for a
    frame each), not frames: each step gathers the boundary record at the
    carried end-1, emits it, and hops the carry to (start, prev_phn).
    Active rows emit exactly one record per step, so the emission index
    IS the step index — the stacked scan outputs are already compact and
    no scatter is needed.  Only ~7 bytes/segment then leave the chip
    instead of the full 8 bytes/frame history — the D2H transfer, not
    compute, dominates batch decode round trips.

    Each hop reads the record at the carried end-1: (phoneme, entry) are
    packed into one int32 word up front, so a step is exactly two
    gathers ([T, B] ids and alphas at per-row frames).
    """
    return _backtrack_device_impl(
        spec, hist, n_frames,
        jnp.zeros(hist.max_phn.shape[1], jnp.int32), unroll)


def _backtrack_device_impl(spec: PhnLoopSpec, hist: History,
                           n_frames: jnp.ndarray, f0: jnp.ndarray,
                           unroll: int) -> Segments:
    T, B = hist.max_phn.shape
    Smax = max_segments(spec, T)
    start_dtype = jnp.int16 if T < 2 ** 15 else jnp.int32
    if T >= 1 << 20:
        raise ValueError("backtrack_device packs entry frames in 20 bits")
    # ids[t, b] = phn << 20 | ent  (both non-negative)
    ids = (hist.max_phn.astype(jnp.int32) << 20) | hist.ent
    end0 = n_frames.astype(jnp.int32)

    def step(end, _):
        t = jnp.maximum(end - 1, 0)[None, :]
        active = end > f0
        w = jnp.take_along_axis(ids, t, axis=0)[0]
        a = jnp.take_along_axis(hist.alpha, t, axis=0)[0]
        start = jnp.where(active,
                          jnp.maximum(w & ((1 << 20) - 1), f0), end)
        out = (active, (w >> 20).astype(jnp.int8),
               start.astype(start_dtype), a)
        return start, out

    _, (active, phn, start, alpha_end) = jax.lax.scan(
        step, end0, None, length=Smax, unroll=unroll)

    count = jnp.sum(active.astype(jnp.int32), axis=0)
    # zero out slots past each row's count (active is a prefix mask per
    # row): labels_from_segments relies on alpha_end[count]-and-beyond
    # being exactly 0 for the initial mPrevAlpha = 0 semantics
    return Segments(
        count=count,
        phn=jnp.where(active, phn, 0).T,
        start=jnp.where(active, start, 0).T,
        alpha_end=jnp.where(active, alpha_end, 0.0).T,
    )


@partial(jax.jit, static_argnums=(1,))
def _slice_segments(segs: Segments, k: int) -> Segments:
    return Segments(segs.count, segs.phn[:, :k], segs.start[:, :k],
                    segs.alpha_end[:, :k])


def fetch_segments_start(segs: Segments, cap: int = 128):
    """Begin the device -> host transfer of a Segments batch (one round
    trip).  The static Smax bound (T/S) is ~5x larger than real speech
    ever needs, so the arrays are device-sliced to ``cap`` slots and ALL
    leaves (counts included) are shipped in one batched async transfer —
    the host-link round-trip latency is paid once and can overlap
    device compute of the next batch.  ``fetch_segments_finish`` falls
    back to a full-capacity refetch in the rare case a row overflows
    ``cap``."""
    if segs.phn.shape[1] == 0 or not isinstance(segs.phn, jnp.ndarray):
        return (segs, segs)
    k = min(segs.phn.shape[1], cap)
    small = _slice_segments(segs, k)
    for a in small:
        a.copy_to_host_async()
    return (segs, small)


def fetch_segments_finish(pending) -> Segments:
    segs, small = pending
    count = np.asarray(small.count)
    out = Segments(count, *(np.asarray(a) for a in small[1:]))
    k = out.phn.shape[1] if out.phn.ndim == 2 else 0
    cmax = int(count.max(initial=0))
    if cmax > k and isinstance(segs.phn, jnp.ndarray):
        out = Segments(count, *(np.asarray(a) for a in segs[1:]))
    # a legitimate full chain has count <= T//S < Smax; count reaching the
    # Smax capacity means backtrack_device truncated the earliest segments
    # (it cannot happen with n_states >= 1, but fail loudly, not silently)
    if segs.phn.shape[1] and cmax >= segs.phn.shape[1]:
        raise AssertionError(
            f"backtrack capacity overflow: count {cmax} reached Smax "
            f"{segs.phn.shape[1]}")
    return out


def fetch_segments(segs: Segments, cap: int = 128) -> Segments:
    """Device -> host transfer of a Segments batch (see
    fetch_segments_start): slice to ``cap`` slots, one batched transfer,
    full refetch only on overflow."""
    return fetch_segments_finish(fetch_segments_start(segs, cap))


def labels_from_segments(segs: Segments, n_frames: np.ndarray,
                         phonemes: List[str],
                         row_offset: "np.ndarray | None" = None
                         ) -> List[List[Label]]:
    """Host-side formatting of device-backtracked segments (reverse time
    order) into per-utterance Label lists.  Segment j's end frame is
    segment j-1's start (j=0 ends at n_frames); its like is the alpha
    delta to the previous-in-time segment (initial mPrevAlpha = 0).

    ``row_offset`` (per row): segments came from a retained WINDOW whose
    row 0 is that global frame — starts shift by it, and ``n_frames``
    is then the GLOBAL end frame per row."""
    counts = np.asarray(segs.count)
    start = np.asarray(segs.start, dtype=np.int64)
    if row_offset is not None:
        start = start + np.asarray(row_offset, np.int64)[:, None]
    alpha_end = np.asarray(segs.alpha_end, dtype=np.float64)
    B = counts.shape[0]
    # all four Label fields vectorized in numpy, then flipped to time
    # order; the Python loop only slices + zips (emission order is
    # reverse time, so [k-1::-1] is the time-ordered view of row b).
    # like[j] = alpha_end[j] - alpha_end[j+1] in emission order; slots past
    # count are zero-filled by the active-mask in backtrack_device, so
    # j = count-1 (first in time) correctly subtracts the reference's
    # initial mPrevAlpha = 0.  end[j] = start[j-1] (j=0 ends at n_frames).
    likes = alpha_end - np.concatenate(
        [alpha_end[:, 1:], np.zeros((B, 1))], 1)
    ends = np.concatenate(
        [np.asarray(n_frames, dtype=np.int64)[:, None], start[:, :-1]], 1)
    names = np.asarray(phonemes, dtype=object)[np.asarray(segs.phn)]
    return [
        list(map(Label, start[b, k - 1 :: -1].tolist(),
                 ends[b, k - 1 :: -1].tolist(),
                 names[b, k - 1 :: -1].tolist(),
                 likes[b, k - 1 :: -1].tolist())) if k else []
        for b, k in enumerate(counts.tolist())
    ]
