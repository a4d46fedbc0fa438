"""Streaming (online) recognition with carried state.

The device equivalent of ProcessOnline/ProcessTail (srec.cpp:793-927): audio
arrives in arbitrary-size chunks; mel frames are assembled from a carried
sample remainder; the STC context is a carried 30-frame mel tail (the
equivalent of Traps' sliding be_mat); the Viterbi carry and history extend
across chunks.  Frames run through the SAME jitted block functions as the
batch path, in fixed-size frame blocks so jit compiles once.

Semantics vs. the reference:
  * posterior rows start at mel frame trap_shift (=15), exactly like the
    reference's delay gate (srec.cpp:829).  The reference checks the gate
    once per bunch, which feeds the decoder up to bunch_size-1 unprimed
    rows when trap_shift is not a bunch multiple; shipped configs
    (bunch 5, shift 15) are exact multiples, where both behaviors agree.
    We gate per frame.
  * finish() repeats the last mel frame trap_shift times (ProcessTail,
    srec.cpp:877-927) and backtracks the full history (PhnDec::Done).
  * online (estim-interval) normalization applies; sentence norm does not
    (it needs the whole utterance — reference offline-only, srec.cpp:999).

Fixed-lag partial results: results(settled_only=True) replays the history
through the same backtrack and returns only segments that end at least
`time_pruning` frames before the newest frame — the information the
reference's TimePruning callback would have emitted (phndec.cpp:191-234).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu import precision

from phnrec_tpu import normalization
from phnrec_tpu.decoder import phnloop
from phnrec_tpu.io import audio
from phnrec_tpu.io.labels import Label
from phnrec_tpu.pipeline import SpeechRec


class StreamingRecognizer:
    def __init__(self, sr: SpeechRec, block_frames: int = 128,
                 commit_horizon: "int | None" = None):
        """``commit_horizon`` (phnloop decode only): opt-in fixed-lag
        commit for UNBOUNDED live sessions — labels ending at least that
        many frames behind the newest frame are committed and their
        history blocks dropped (the reference's TimePruning ring,
        phndec.cpp:191-234; the stkint path already commits via its
        record horizon).  None keeps the whole history."""
        if sr.estimator is None:
            raise ValueError("streaming requires an enabled estimator")
        self.sr = sr
        self.block = block_frames
        self.commit_horizon = commit_horizon
        # fixed-lag commit state: committed labels, boundary frame,
        # cumulative like at the boundary, first retained history row
        self._committed: List[Label] = []
        self._frame0 = 0
        self._alpha0 = 0.0
        self._row_offset = 0
        spec = sr.frontend.spec
        self.vs, self.step = spec.vector_size, spec.step
        self.trap_shift = sr.estimator.trap_shift
        self.online_norm = normalization.OnlineNorm.from_config(
            sr.cfg, spec.nbanks)
        self.online_norm.set_channel(
            sr.cfg.get_int("onlinenorm", "channel"))

        # lin16 without dither ships int16 to the device; dither needs the
        # host LCG (srec.cpp:771-785), A-law converts via the host table
        self._i16 = (sr.wave_format == "lin16" and sr.wave_noise == 0.0)
        self._frame_quantum = 256
        self._sample_buf = np.zeros(
            0, np.int16 if self._i16 else np.float32)
        self._byte_rem = b""
        self._first_frame_done = False
        self._mel_tail = None                        # [trap_len-1, nbanks]
        self._mel_pending = jnp.zeros((0, spec.nbanks), jnp.float32)
        self._last_mel = None

        fe = sr.frontend
        dc, scale = np.float32(sr.wave_dc_shift), np.float32(sr.wave_scale)

        i16 = self._i16

        @jax.jit
        def _front(span):
            w = span.astype(jnp.float32)
            # host _convert_chunk already applied dc/scale on the float
            # path; the int16 path defers them to the device
            if i16 and float(dc) != 0.0:
                w = w + dc
            if i16 and float(scale) != 1.0:
                w = w * scale
            n_pad = (span.shape[0] - spec.vector_size) // spec.step + 1
            par = fe.log_mel_from_frames(fe.frames_from_wave(w, n_pad))
            return normalization.frame_norm(par, sr.frame_shift,
                                            sr.frame_floor)

        self._front_fn = _front
        self._n_mel = 0          # mel frames fed to the STC window so far
        self._carry = phnloop.init_carry(sr.loop_spec, 1)
        self._hist: List[np.ndarray] = [[], [], []]
        self._n_decoded = 0
        self._post_fn = _make_posterior_block_fn(sr)

        # fused steady-state block program: span -> mel -> STC -> MLPs ->
        # Viterbi in ONE jit dispatch instead of one dispatch per op.  The
        # multi-op path still serves the first block (delay-gate
        # slicing), online-norm (host state), stkint, and finish().
        post_fn = self._post_fn
        loop_spec = sr.loop_spec
        ts2 = 2 * self.trap_shift

        @jax.jit
        def _fused_block(span, mel_tail, carry, t0):
            par = _front(span)                       # [block, nb]
            ctx = jnp.concatenate([mel_tail, par])   # [2*shift+block, nb]
            new_tail = ctx[-ts2:]
            lp = post_fn(ctx)                        # [block, n_out]
            carry, hist = phnloop.viterbi_block(loop_spec, carry,
                                                lp[None], t0)
            return par[-1], new_tail, carry, \
                tuple(a[:, 0] for a in hist)

        self._fused_block = _fused_block

        @jax.jit
        def _fused_finish(span, n, mel_tail, carry, t0):
            """One-dispatch ProcessTail: frame the leftover span (rows
            past n are garbage), replicate the last valid mel frame as
            the trap_shift tail flush (repeat-last == clip-gather), run
            posteriors + Viterbi over the fixed-size block.  Only rows
            < n + trap_shift are valid; the caller counts those."""
            par = _front(span)                        # [cap, nb]
            cap = par.shape[0]
            # row -1 (= mel_tail's last row) serves the n == 0 case
            par2 = jnp.concatenate([mel_tail[-1:], par])
            mel = par2[jnp.clip(jnp.arange(cap) + 1, 0, n)]
            ctx = jnp.concatenate([mel_tail, mel])
            lp = post_fn(ctx)
            carry, hist = phnloop.viterbi_block(loop_spec, carry,
                                                lp[None], t0)
            return carry, tuple(a[:, 0] for a in hist)

        self._fused_finish = _fused_finish

        # stkint decoder path (StkInterface::ProcessFrame streaming,
        # stkinterface.cpp:214-289): carried network state + per-block
        # records; KWS mode feeds sink values through the LRTrace state
        # machine per block
        self._stk = sr.stk_decoder
        self._stk_recs: List = []
        self._stk_tail = None          # host dict of retained record rows
        self._stk_frame0 = 0           # absolute frame of retained row 0
        self._stk_committed: List[Label] = []
        self._stk_like0 = 0.0          # cumulative like at the commit pt
        self._kws_tracker = None
        self._kws_hits_emitted = 0
        if self._stk is not None:
            self._stk_carry = self._stk.decoder.init_carry()
            # retain at most this many record rows before committing the
            # settled prefix and dropping it — the reference keeps a
            # fixed-lag ring of time_pruning entries (Viterbi.cc:65-125);
            # unbounded retention would be O(T) memory and O(T) work per
            # results() call on a long live session
            self._stk_horizon = max(4 * self._stk.time_pruning,
                                    4 * block_frames, 512)
            if self._stk.mode == "kws":
                # LRTrace candidate state rides INSIDE the device scan
                # (DeviceKWSTracker): no blocking per-block sink fetch
                # through the link; flush events are collected lazily
                from phnrec_tpu.decoder.stknet import DeviceKWSTracker
                c = self._stk.compiled
                self._kws_tracker = DeviceKWSTracker(
                    self._stk.keywords(), self._stk.time_pruning,
                    self._stk.kws_score_pruning,
                    word_sinks=c.kws_word_sinks,
                    filler_sink=c.kws_filler_sink)
            # global <InputXform> with delay (stacking) nodes: carry the
            # delay lines across chunks (the per-frame UpdateStacks
            # semantics, Viterbi.cc:2068/Models.h:891-1028) so chunked
            # equals whole-utterance at block boundaries
            self._stk_xform = None
            if self._stk.model_set.input_xform is not None:
                from phnrec_tpu.io.xform import StreamingXform
                self._stk_xform = StreamingXform(
                    self._stk.model_set.input_xform)

    @property
    def committed_count(self) -> int:
        """Leading labels of results() that are COMMITTED (immutable):
        live emitters can skip re-scanning them on every poll."""
        return len(self._stk_committed if self._stk is not None
                   else self._committed)

    def set_channel(self, cid: int) -> None:
        """Switch the online-normalization channel for subsequent audio
        (multi-channel sources: each channel carries its own running
        mean/variance estimate, Normalization::SetChannel norm.cpp:202).
        Pending full mel blocks are drained under the OLD channel first;
        samples not yet forming a full block normalize under the new one,
        so switch at segment boundaries (as a multi-channel source
        naturally does)."""
        if self.online_norm.enabled:
            self._drain()
        self.online_norm.set_channel(cid)

    # -- waveform -> mel frames -----------------------------------------
    def process(self, raw: bytes) -> None:
        """Push a chunk of raw audio bytes (any size, including odd).

        The sample buffer lives on the HOST (bytes arrive there anyway),
        but everything after it is device-resident: lin16 samples cross
        the host->device link as int16 (half the bytes; cast + DC shift +
        scale happen in the jitted frontend) and the mel block stays a
        device array end-to-end — no per-chunk device->host fetch unless
        online normalization (host state machine) is enabled."""
        sr = self.sr
        if sr.wave_format == "lin16":
            raw = self._byte_rem + raw
            cut = len(raw) - (len(raw) % 2)
            raw, self._byte_rem = raw[:cut], raw[cut:]
            if self._i16:
                wave = np.frombuffer(raw, dtype="<i2")
            else:
                wave = _convert_chunk(raw, sr)
        else:
            wave = _convert_chunk(raw, sr)
        self._sample_buf = np.concatenate([self._sample_buf, wave])
        # consume FULL fixed-size frame blocks straight from the sample
        # buffer: every device op in steady state then has one static
        # shape (variable-shape eager ops re-lower per shape);
        # leftovers wait for the next
        # chunk or finish()
        spb = self.block * self.step
        need = (self.block - 1) * self.step + self.vs
        while self._sample_buf.shape[0] >= need:
            span = self._sample_buf[:need]
            self._sample_buf = self._sample_buf[spb:]
            self._first_frame_done = True
            if (self._stk is None and not self.online_norm.enabled
                    and self._mel_tail is not None
                    and self._n_mel >= self.trap_shift):
                # steady state: one fused dispatch for the whole block
                last, self._mel_tail, self._carry, hist = \
                    self._fused_block(jnp.asarray(span), self._mel_tail,
                                      self._carry, self._n_decoded)
                self._last_mel = last
                for i, a in enumerate(hist):
                    self._hist[i].append(a)
                self._n_mel += self.block
                self._n_decoded += self.block
                self._maybe_commit()
            else:
                self._push_mel(self._norm_host(
                    self._front_fn(jnp.asarray(span))))

    def _norm_host(self, par):
        if self.online_norm.enabled:
            par = jnp.asarray(self.online_norm.process_block(
                np.asarray(par)))
        return par

    def _flush_samples(self) -> None:
        """Frame whatever samples remain (< one block) at finish time."""
        buf = self._sample_buf
        if buf.shape[0] < self.vs:
            return
        n = (buf.shape[0] - self.vs) // self.step + 1
        self._first_frame_done = True
        # pad the span to a frame quantum to bound finish-time compiles
        n_pad = -(-n // self._frame_quantum) * self._frame_quantum
        span_len = (n_pad - 1) * self.step + self.vs
        span = np.zeros(span_len, buf.dtype)
        take = min(buf.shape[0], span_len)
        span[:take] = buf[:take]
        self._sample_buf = buf[n * self.step :]
        self._push_mel(self._norm_host(
            self._front_fn(jnp.asarray(span))[:n]))

    # -- mel frames -> posteriors -> viterbi -----------------------------
    def _push_mel(self, par) -> None:
        if par.shape[0] == 0:
            return
        self._last_mel = par[-1]
        if self._mel_tail is None:
            # replicate-first-frame window init (traps.cpp:186-199)
            self._mel_tail = jnp.repeat(par[:1], 2 * self.trap_shift,
                                        axis=0)
        self._mel_pending = jnp.concatenate([self._mel_pending, par])
        self._drain()

    def _drain(self) -> None:
        while self._mel_pending.shape[0] >= self.block:
            blk, self._mel_pending = (self._mel_pending[: self.block],
                                      self._mel_pending[self.block :])
            self._run_block(blk, blk.shape[0])

    def _run_block(self, blk, n_valid: int) -> None:
        """blk: [F, nbanks] new mel frames; computes posterior rows for
        windows centered trap_shift back, then extends the Viterbi."""
        sr = self.sr
        ctx = jnp.concatenate([self._mel_tail, blk])  # [30 + F, nbanks]
        self._mel_tail = ctx[-2 * self.trap_shift :]
        lp = self._post_fn(ctx)
        # rows correspond to window centers (n_mel - 15 .. n_mel + F - 16);
        # drop rows whose center precedes frame 0 (unprimed gate)
        first_center = self._n_mel - self.trap_shift
        self._n_mel += n_valid
        # stay on device end-to-end: the host never blocks on this block's
        # result, so consecutive blocks pipeline through dispatch (the D2H
        # happens once, at results()/finish())
        lp = lp[:n_valid]
        if first_center < 0:
            skip = min(-first_center, int(lp.shape[0]))
            lp = lp[skip:]
        if lp.shape[0] == 0:
            return
        if self._stk is not None:
            self._run_stk_block(lp)
            self._n_decoded += int(lp.shape[0])
            return
        # pass the running frame offset so History.ent stays global
        self._carry, hist = phnloop.viterbi_block(
            sr.loop_spec, self._carry, lp[None], self._n_decoded)
        for i, a in enumerate(hist):
            self._hist[i].append(a[:, 0])
        self._n_decoded += int(lp.shape[0])
        self._maybe_commit()

    def _maybe_commit(self) -> None:
        """Fixed-lag commit of the phnloop history (commit_horizon
        mode): backtrack the retained window, move labels ending behind
        the horizon into the committed prefix, and drop history blocks
        whose rows are all committed — O(horizon) memory for unbounded
        live sessions (TimePruning-ring semantics, phndec.cpp:191-234).

        The commit is FORCED, like the reference's ring: a segment
        spanning the whole horizon (long silence) is split at the
        horizon boundary (its like telescopes exactly across the split),
        so the window can never grow unboundedly.  Committed alphas are
        REBASED out of the carried scores so cumulative float32 path
        likes stay small over multi-day sessions (the recurrence is
        shift-invariant)."""
        if self.commit_horizon is None or self._stk is not None:
            return
        retained = self._n_decoded - self._row_offset
        if retained <= 2 * self.commit_horizon + self.block:
            return
        # one batched fetch; retained blocks become host arrays
        fetched = jax.device_get(self._hist)
        self._hist = [list(h) for h in fetched]
        hist = phnloop.History(*(
            np.concatenate(h)[: retained] for h in fetched))
        labels = phnloop.backtrack_committed(
            hist, self._row_offset, self._frame0, self._alpha0,
            self.sr.phonemes)
        horizon_end = self._n_decoded - self.commit_horizon
        commit = [l for l in labels if l.end_frames <= horizon_end]
        if not commit:
            # forced boundary: split the label spanning the horizon
            if not labels or labels[0].start_frames >= horizon_end:
                return
            l0 = labels[0]
            like = float(np.asarray(hist.alpha)[
                horizon_end - 1 - self._row_offset]) - self._alpha0
            commit = [Label(l0.start_frames, horizon_end, l0.name, like)]
        self._committed.extend(commit)
        e = commit[-1].end_frames
        self._alpha0 = float(np.asarray(hist.alpha)[
            e - 1 - self._row_offset])
        self._frame0 = e
        while self._hist[0]:
            blk_len = len(self._hist[0][0])
            if self._row_offset + blk_len <= self._frame0:
                for h in self._hist:
                    h.pop(0)
                self._row_offset += blk_len
            else:
                break
        self._rebase_alphas()

    def _rebase_alphas(self) -> None:
        """Subtract the committed like (alpha0) from every retained
        score — the Viterbi recurrence is shift-invariant, so this keeps
        |alpha| bounded by the window's like instead of the session's
        (float32 ULP at ~2e7 exceeds log(0.5), which would corrupt
        multi-day decodes)."""
        r = np.float32(self._alpha0)
        if r == 0.0:
            return
        alphas, ent = self._carry
        # keep the -FLT_MAX sentinel out of the shift (it would overflow
        # to -inf); every real score shifts by -alpha0
        self._carry = (jnp.where(alphas <= jnp.float32(phnloop.NEG_INF / 2),
                                 alphas, alphas - jnp.float32(r)), ent)
        self._hist[2] = [a - r for a in self._hist[2]]
        self._alpha0 = 0.0

    def _run_stk_block(self, lp) -> None:
        import jax

        dec = self._stk
        obs = self._stk_xform(lp) if self._stk_xform is not None else lp
        obs_state = dec.decoder.state_observations(obs)
        from phnrec_tpu.decoder.stknet import OFF_BEAM
        beam = jnp.float32(OFF_BEAM if dec.beam_pruning is None
                           else dec.beam_pruning)
        F = int(obs_state.shape[0])
        self._stk_carry, recs = dec.decoder.scan_block(
            self._stk_carry, obs_state, jnp.int32(self._n_decoded),
            jnp.int32(self._n_decoded + F), beam)
        if self._kws_tracker is not None:
            # sink records stay on device: the tracker scan consumes
            # them in HBM and the host fetches only flush events, later
            self._kws_tracker.feed_sinks(recs["sink_val"],
                                         recs["sink_wt"])
        else:
            self._stk_recs.append(recs)   # stays on device until pulled
            self._stk_commit()

    def _stk_pull(self) -> None:
        """Move pending device record blocks into the host tail (one
        concatenation per call; the tail stays bounded by the commit)."""
        import jax

        if not self._stk_recs:
            return
        blocks = [jax.tree_util.tree_map(np.asarray, r)
                  for r in self._stk_recs]
        self._stk_recs = []
        if self._stk_tail is not None:
            blocks.insert(0, self._stk_tail)
        self._stk_tail = (blocks[0] if len(blocks) == 1 else
                          jax.tree_util.tree_map(
                              lambda *xs: np.concatenate(xs), *blocks))

    def _stk_commit(self) -> None:
        """Fixed-lag commit (the reference's TimePruning ring,
        Viterbi.cc:65-125 / stkinterface.cpp:222-238): once the retained
        record window exceeds the horizon, traceback it, move labels
        ending at least time_pruning frames before the newest frame into
        the committed prefix, and DROP their record rows — bounding both
        memory and per-results() work for unbounded live sessions.  Like
        the reference's forced commit, a later global-best-path shift
        cannot rewrite the committed prefix."""
        retained = (0 if self._stk_tail is None
                    else self._stk_tail["in_am"].shape[0]) + \
            sum(int(r["in_am"].shape[0]) for r in self._stk_recs)
        if retained <= self._stk_horizon:
            return
        self._stk_pull()
        labels = self._stk.decoder.traceback_host(
            self._stk_tail, frame_offset=self._stk_frame0,
            boundary=self._stk_frame0 > 0, like_offset=self._stk_like0)
        horizon = self._n_decoded - self._stk.time_pruning
        commit = [l for l in labels if l.end_frames <= horizon]
        if not commit:
            return      # nothing settled yet; keep retaining
        cut_abs = commit[-1].end_frames          # absolute frame boundary
        self._stk_committed.extend(commit)
        self._stk_like0 += sum(l.score for l in commit)
        cut = cut_abs - self._stk_frame0
        self._stk_tail = {k: v[cut:] for k, v in self._stk_tail.items()}
        self._stk_frame0 = cut_abs

    def _flush_blocks(self) -> None:
        self._drain()
        if self._mel_pending.shape[0] > 0:
            blk = self._mel_pending
            self._mel_pending = jnp.zeros((0, blk.shape[1]), jnp.float32)
            pad = self.block - blk.shape[0]
            padded = jnp.concatenate(
                [blk, jnp.repeat(blk[-1:], pad, axis=0)]) \
                if pad > 0 else blk
            self._run_block(padded, blk.shape[0])

    def finish(self) -> List[Label]:
        """ProcessTail + Done: flush STC latency and backtrack."""
        if (self._stk is None and not self.online_norm.enabled
                and self._mel_tail is not None
                and self._n_mel >= self.trap_shift):
            # one fused dispatch for the whole tail (leftover frames +
            # trap_shift last-frame repeats), avoiding the per-op
            # dispatches of the generic flush path
            buf = self._sample_buf
            n = ((buf.shape[0] - self.vs) // self.step + 1
                 if buf.shape[0] >= self.vs else 0)
            cap = -(-max(n + self.trap_shift, 1) //
                    self._frame_quantum) * self._frame_quantum
            span_len = (cap - 1) * self.step + self.vs
            span = np.zeros(span_len, buf.dtype)
            take = min(buf.shape[0], span_len)
            span[:take] = buf[:take]
            self._sample_buf = buf[n * self.step :]
            self._carry, hist = self._fused_finish(
                jnp.asarray(span), jnp.int32(n), self._mel_tail,
                self._carry, self._n_decoded)
            for i, a in enumerate(hist):
                self._hist[i].append(a)
            self._n_mel += n
            self._n_decoded += n + self.trap_shift
            return self.results()
        self._flush_samples()
        if self._last_mel is None:
            return []
        # repeat the last mel frame trap_shift times (srec.cpp:889-898)
        self._mel_pending = jnp.concatenate(
            [self._mel_pending,
             jnp.repeat(jnp.asarray(self._last_mel)[None], self.trap_shift,
                        axis=0)])
        self._flush_blocks()
        return self.results()

    def results(self, settled_only: bool = False) -> List[Label]:
        if self._stk is not None:
            return self._stk_results(settled_only)
        if not self._hist[0]:
            return list(self._committed)
        # ONE batched device->host transfer for the whole history (a
        # per-array np.asarray pays a round trip each; hours of audio
        # accumulate hundreds of block arrays).  In commit_horizon mode
        # the retained window stitches onto the committed prefix.
        fetched = jax.device_get(self._hist)
        hist = phnloop.History(
            *(np.concatenate(h)[: self._n_decoded - self._row_offset]
              for h in fetched))
        labels = self._committed + phnloop.backtrack_committed(
            hist, self._row_offset, self._frame0, self._alpha0,
            self.sr.phonemes)
        if settled_only:
            tp = self.sr.cfg.get_int("decoder", "time_pruning")
            horizon = self._n_decoded - tp
            labels = [l for l in labels if l.end_frames <= horizon]
        return labels

    def _stk_results(self, settled_only: bool) -> List[Label]:
        if self._kws_tracker is not None:
            # candidates flushed so far, in FLUSH order (the live callback
            # emission order — callers slice by count, so no sorting);
            # results(False) == end-of-utterance: flush the rest.  The
            # tracker state lives on device; collect() is the single
            # fetch that materializes pending flush events.
            if settled_only:
                self._kws_tracker.collect()
            else:
                self._kws_tracker.finish()
            return [Label(h.start, h.end, h.word, h.score)
                    for h in self._kws_tracker.hits]
        # committed prefix + traceback over the bounded retained window
        # (the commit in _run_stk_block keeps the window near the
        # horizon, so this is O(window), not O(session))
        self._stk_pull()
        if self._stk_tail is None:
            return list(self._stk_committed)
        labels = self._stk_committed + self._stk.decoder.traceback_host(
            self._stk_tail, frame_offset=self._stk_frame0,
            boundary=self._stk_frame0 > 0, like_offset=self._stk_like0)
        if settled_only:
            tp = self._stk.time_pruning
            horizon = self._n_decoded - tp
            labels = [l for l in labels if l.end_frames <= horizon]
        return labels

    def kws_hits_so_far(self) -> List[Label]:
        """Newly flushed KWS candidates since the last call — the live
        callback stream (DECMSG_WORD per PutKWSCandidateToLabels)."""
        if self._kws_tracker is None:
            return []
        self._kws_tracker.collect()
        new = self._kws_tracker.hits[self._kws_hits_emitted :]
        self._kws_hits_emitted = len(self._kws_tracker.hits)
        return [Label(h.start, h.end, h.word, h.score) for h in new]


def _convert_chunk(raw: bytes, sr: SpeechRec) -> np.ndarray:
    """Chunk-safe waveform conversion (no 200-sample min padding — that is
    a whole-file concern handled by io.audio.convert_waveform)."""
    if sr.wave_format == "lin16":
        wave = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    else:
        wave = 8.0 * audio.ALAW_TABLE_D5[
            np.frombuffer(raw, dtype=np.uint8)].astype(np.float32)
    if sr.wave_dc_shift != 0.0:
        wave = wave + np.float32(sr.wave_dc_shift)
    if sr.wave_scale != 1.0:
        wave = wave * np.float32(sr.wave_scale)
    return wave


def _make_posterior_block_fn(sr: SpeechRec):
    """Build the jitted [30+F, nbanks] -> [F, n_out] log-posterior block
    function once per recognizer (compiled per distinct F)."""
    import jax

    est = sr.estimator

    if not hasattr(est, "assembler"):
        # 3BT/1BT/1BT_DCT: windows are static shifted slices of the
        # carried context buffer; _merger_input implements the system's
        # trap assembly (estimator.py)
        from phnrec_tpu.posteriors import mlp as _mlp

        @jax.jit
        def run_traps(ctx):
            F = ctx.shape[0] - 2 * est.trap_shift
            win = jnp.stack(
                [ctx[o : o + F] for o in range(2 * est.trap_shift + 1)],
                axis=1)                                 # [F, trap_len, nb]
            post = _mlp.forward(est.merger, est._merger_input(win),
                                est.fast_exp)
            return sr.dec_soft(sr.post_soft(post))

        return run_traps

    @jax.jit
    def run(ctx):
        F = ctx.shape[0] - 2 * est.trap_shift
        idx = (jnp.arange(F)[:, None] + jnp.arange(2 * est.trap_shift + 1)
               [None, :])
        win = ctx[idx]                                  # [F, 31, B]
        hc = est.assembler.half_context
        from phnrec_tpu.posteriors import mlp
        left = jnp.einsum("tjb,jc->tbc", win[:, :hc, :],
                          est.assembler.m_left,
                          precision=precision.get())
        right = jnp.einsum("tjb,jc->tbc", win[:, hc - 1 :, :],
                           est.assembler.m_right,
                           precision=precision.get())
        lo = mlp.forward(est.band[0], left.reshape(F, -1), est.fast_exp)
        ro = mlp.forward(est.band[1], right.reshape(F, -1), est.fast_exp)
        m = jnp.concatenate([lo, ro], axis=-1)
        m = jnp.where(m > 0.0, jnp.log(jnp.maximum(m, 1e-37)), 0.0)
        post = mlp.forward(est.merger, m, est.fast_exp)
        return sr.dec_soft(sr.post_soft(post))

    return run
