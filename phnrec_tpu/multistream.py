"""Multi-stream streaming recognition: N concurrent audio streams decoded
through ONE fused block dispatch per step.

The reference serves one stream per process (SpeechRec owns a single
decoder/frontend chain, srec.cpp:793-849); serving N streams means N
processes, each re-running the same per-frame loop.  A single stream
leaves an accelerator almost idle (the Viterbi state is [P, S+1, 1] and
the MLP GEMMs have batch 1 per frame block), so this design batches
independent streams into the minor axis:

  * carried mel tails   [N, 2*shift, nbanks]   (Traps be_mat per stream)
  * Viterbi carry       [P, S+1, N]            (batch = minor axis)
  * per-row frame offsets / validity           (streams advance unevenly)

Every step is one jitted program: span [N, samples] -> mel -> STC windows
-> 3 MLPs -> masked Viterbi block (phnloop.viterbi_block_ragged).  A
stream with no pending audio simply idles through the dispatch (its carry
rows pass through), so ragged arrival patterns need no re-batching.

Per-stream semantics are EXACTLY StreamingRecognizer's (srec.cpp:793-927):
replicate-first-frame window init, the 15-frame delay gate, repeat-last-
frame tail flush, and full-history backtrack — asserted stream-for-stream
against the single-stream path in tests/test_multistream.py.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu import normalization
from phnrec_tpu.decoder import phnloop
from phnrec_tpu.io.labels import Label
from phnrec_tpu.pipeline import SpeechRec
from phnrec_tpu.streaming import _convert_chunk, _make_posterior_block_fn


class MultiStreamRecognizer:
    """Decode ``n_streams`` independent audio streams in lockstep-batched
    fused blocks.  Feed bytes with process(i, raw); pump() dispatches
    fused blocks when streams have audio; finish() flushes tails and
    returns per-stream label lists."""

    def __init__(self, sr: SpeechRec, n_streams: int,
                 block_frames: int = 128, auto_pump: bool = True,
                 mesh=None, commit_horizon: Optional[int] = None,
                 partial_pump: bool = False):
        """``mesh``: an optional jax.sharding.Mesh with a 'data' axis —
        streams shard across devices (the stream axis is the minor
        axis of every carried tensor, so XLA partitions the whole fused
        program without collectives: each device serves its slice of the
        streams).  n_streams must divide evenly by the axis size.

        ``commit_horizon``: opt-in fixed-lag commit for UNBOUNDED
        serving sessions — labels ending at least ``commit_horizon``
        frames behind each stream's newest frame are committed and their
        history rows dropped (the reference's TimePruning ring,
        phndec.cpp:191-234), bounding RETAINED history at O(horizon) per
        stream instead of O(session); segments spanning the horizon are
        force-split at the boundary (exactly-telescoping likes) and
        committed scores are rebased out of the carry so float32 stays
        healthy over multi-day sessions.  Like the reference's forced
        commit, a later global-best-path shift cannot rewrite the
        committed prefix.  Residual costs: a stream fed much more slowly
        than its peers raises the retained-block constant (its horizon
        spans more wall blocks), and the committed LABEL lists grow with
        the session — they are the requested output; a serving loop that
        drains them can pop from ``self._committed[b]``.  None (default)
        keeps the full history (exact full backtrack at finish).

        ``partial_pump``: dispatch a fused block as soon as ANY live
        stream has a full block pending; the others contribute what they
        have (possibly nothing — idle rows pass their carry through the
        ragged scan).  Kills head-of-line blocking: one slow or silent
        stream no longer stalls the other N-1.  Default False keeps the
        lockstep policy (every live stream must fill a block), which
        wastes no work on idle rows."""
        if sr.estimator is None:
            raise ValueError("streaming requires an enabled estimator")
        self._check_decoder(sr)
        self.commit_horizon = commit_horizon
        self.online_norm = normalization.OnlineNorm.from_config(
            sr.cfg, sr.frontend.spec.nbanks)
        self.sr = sr
        self.n = n_streams
        self.block = block_frames
        spec = sr.frontend.spec
        self.vs, self.step_len = spec.vector_size, spec.step
        self.nbanks = spec.nbanks
        self.trap_shift = s = sr.estimator.trap_shift
        self.auto_pump = auto_pump
        self.partial_pump = partial_pump

        self._i16 = (sr.wave_format == "lin16" and sr.wave_noise == 0.0)
        dtype = np.int16 if self._i16 else np.float32
        self._bufs = [np.zeros(0, dtype) for _ in range(n_streams)]
        self._byte_rem = [b"" for _ in range(n_streams)]
        self._ended = np.zeros(n_streams, bool)
        self._n_mel = np.zeros(n_streams, np.int64)
        self._n_dec = np.zeros(n_streams, np.int64)
        self._primed_host = np.zeros(n_streams, bool)
        self._flushed = False

        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            if n_streams % mesh.shape["data"]:
                raise ValueError("n_streams must divide the mesh's "
                                 "'data' axis size")
            # the stream axis shards wherever it appears; no collectives
            # exist anywhere in the program (streams are independent)
            self._sh_rows = NamedSharding(mesh, P("data"))
            self._sh_tail = NamedSharding(mesh, P("data", None, None))
            self._sh_carry = self._carry_sharding(mesh)
            self._sh_audio = NamedSharding(mesh, P("data", None))
        else:
            self._sh_rows = self._sh_tail = None
            self._sh_carry = self._sh_audio = None

        def _put(x, sh):
            return x if sh is None else jax.device_put(x, sh)

        self._put = _put
        self._mel_tail = _put(
            jnp.zeros((n_streams, 2 * s, self.nbanks), jnp.float32),
            self._sh_tail)
        self._primed = _put(jnp.zeros((n_streams,), bool), self._sh_rows)
        self._carry = _put(self._init_decode_carry(), self._sh_carry)
        # history: (device History [T, N], valid [N] np) per dispatch
        self._hist: List = []
        self._res_cache: dict = {}
        # fixed-lag commit state (commit_horizon mode): per-stream
        # committed labels, commit boundary frames, path like at the
        # boundary, and the local-row offset of each stream's retained
        # history (frames [offset_b, n_dec_b) remain)
        self._committed: List[List[Label]] = [[] for _ in range(n_streams)]
        self._frame0 = np.zeros(n_streams, np.int64)
        self._alpha0 = np.zeros(n_streams, np.float64)
        self._row_offset = np.zeros(n_streams, np.int64)

        fe = sr.frontend
        dc = np.float32(sr.wave_dc_shift)
        scale = np.float32(sr.wave_scale)
        i16 = self._i16
        post_fn = _make_posterior_block_fn(sr)
        loop_spec = sr.loop_spec
        ts2 = 2 * s
        frame_shift, frame_floor = sr.frame_shift, sr.frame_floor

        # -- device-carried online normalization (norm.cpp:92-234) ------
        # per-stream running mean/var estimation rides in the fused
        # dispatch: accumulate each stream's first estim_interval mel
        # frames (cnt/sum/sumsq rows), then freeze and normalize from
        # the frame COMPLETING the estimate onward (the reference
        # normalizes that very frame, norm.cpp:127-148 + the host
        # process_block's i += take - 1).  estim_interval == 0 applies
        # file-loaded channel params to every frame.
        on = self.online_norm
        on.set_channel(sr.cfg.get_int("onlinenorm", "channel"))
        self._on_E = on.estim_interval
        ch = on._state(on.cur)
        on_mean0 = jnp.asarray(ch["mean"])
        on_inv0 = jnp.asarray(ch["inv_std"] * (ch["glob_std"]
                                               if on.scale_to_gvar
                                               else 1.0))
        on_gstd = jnp.asarray(ch["glob_std"])

        def _onorm(par, v, n_mel, onst):
            """[N, F, nb] mel rows (row j of stream b = global mel frame
            n_mel[b] + j; rows >= v[b] garbage) -> normalized rows +
            advanced estimation state."""
            if not on.enabled:
                return par, onst
            if self._on_E == 0:            # frozen file-loaded params
                out = par
                if on.mean_norm:
                    out = out - on_mean0[None, None]
                if on.var_norm:
                    out = out * on_inv0[None, None]
                return out, onst
            E = jnp.int32(self._on_E)
            cnt, sx, sxx = onst
            F = par.shape[1]
            g = n_mel[:, None] + jnp.arange(F, dtype=jnp.int32)[None, :]
            contrib = ((g < E) & (jnp.arange(F)[None, :]
                                  < v[:, None]))[:, :, None]
            sx = sx + jnp.sum(jnp.where(contrib, par, 0.0), axis=1)
            sxx = sxx + jnp.sum(jnp.where(contrib, par * par, 0.0),
                                axis=1)
            cnt = cnt + jnp.sum(contrib[:, :, 0], axis=1)
            mean = sx / jnp.float32(self._on_E)
            var = jnp.maximum(sxx / jnp.float32(self._on_E)
                              - mean * mean, 1e-20)
            inv = jax.lax.rsqrt(var)
            if on.scale_to_gvar:
                inv = inv * on_gstd[None, :]
            out = par
            if on.mean_norm:
                out = out - mean[:, None, :]
            if on.var_norm:
                out = out * inv[:, None, :]
            apply_row = (g >= E - 1)[:, :, None]
            return jnp.where(apply_row, out, par), (cnt, sx, sxx)

        self._onorm_state = () if not on.enabled or self._on_E == 0 else (
            _put(jnp.zeros((n_streams,), jnp.int32), self._sh_rows),
            _put(jnp.zeros((n_streams, self.nbanks), jnp.float32),
                 self._sh_audio),
            _put(jnp.zeros((n_streams, self.nbanks), jnp.float32),
                 self._sh_audio))

        def _front(span):                      # [N, samples] -> [N, F, nb]
            w = span.astype(jnp.float32)
            if i16 and float(dc) != 0.0:
                w = w + dc
            if i16 and float(scale) != 1.0:
                w = w * scale
            F = (span.shape[1] - self.vs) // self.step_len + 1
            frames = jax.vmap(lambda row: fe.frames_from_wave(row, F))(w)
            par = fe.log_mel_from_frames(frames)
            return normalization.frame_norm(par, frame_shift, frame_floor)

        est = sr.estimator
        if hasattr(est, "assembler") and \
                n_streams >= self.conv_assembly_min_streams:
            # conv-based LCRC assembly (stc.py::batched): the per-stream
            # window-gather post_fn would materialize a [N, F, 31, nb]
            # context tensor (a 31x device-memory blow-up); at few
            # streams the gather is smaller, so the choice is
            # stream-count dependent.  ctx rows [s, s+F) have full real
            # context, so the assembler's edge replication never shows.
            from phnrec_tpu.posteriors import mlp as _mlp

            def _post_block(ctx):      # [N, 2s+F, nb] -> [N, F, n_out]
                F = ctx.shape[1] - ts2
                left, right = est.assembler.batched(ctx)
                lo = _mlp.forward(est.band[0], left[:, s : s + F],
                                  est.fast_exp)
                ro = _mlp.forward(est.band[1], right[:, s : s + F],
                                  est.fast_exp)
                m = jnp.concatenate([lo, ro], axis=-1)
                m = jnp.where(m > 0.0,
                              jnp.log(jnp.maximum(m, 1e-37)), 0.0)
                post = _mlp.forward(est.merger, m, est.fast_exp)
                return sr.dec_soft(sr.post_soft(post))
        else:
            def _post_block(ctx):
                return jax.vmap(post_fn)(ctx)

        def _decode_ctx(ctx, skip, carry, n_dec, n_valid, cap):
            """Shared tail of both fused programs: posterior rows from the
            per-stream context, rolled so each row's valid frames lead,
            then the subclass-selected masked decoder block."""
            lp = _post_block(ctx)                       # [N, cap, n_out]
            idx = jnp.clip(skip[:, None] + jnp.arange(cap)[None, :],
                           0, cap - 1)
            lp = jnp.take_along_axis(lp, idx[:, :, None], axis=1)
            return self._decode_block(carry, lp, n_dec.astype(jnp.int32),
                                      n_valid.astype(jnp.int32))

        def _fused_impl(span, v, mel_tail, primed, carry, n_mel, n_dec,
                        onst):
            """One multi-stream block: span [N, samples] with v[b] valid
            new frames in row b."""
            par = _front(span)                          # [N, block, nb]
            par, onst = _onorm(par, v.astype(jnp.int32),
                               n_mel.astype(jnp.int32), onst)
            tail_eff = jnp.where(
                primed[:, None, None], mel_tail,
                jnp.repeat(par[:, :1], ts2, axis=1))
            ctx = jnp.concatenate([tail_eff, par], axis=1)
            tidx = v[:, None].astype(jnp.int32) + jnp.arange(ts2)[None, :]
            new_tail = jnp.take_along_axis(ctx, tidx[:, :, None], axis=1)
            skip = jnp.clip(jnp.int32(s) - n_mel.astype(jnp.int32), 0,
                            v.astype(jnp.int32))
            carry, hist = _decode_ctx(ctx, skip, carry, n_dec, v - skip,
                                      self.block)
            return new_tail, primed | (v > 0), carry, hist, onst

        _fused = jax.jit(_fused_impl)

        need = (self.block - 1) * self.step_len + self.vs

        @jax.jit
        def _fused_from_buffer(audio, offset, v, mel_tail, primed, carry,
                               n_mel, n_dec, onst):
            """Same block program, but the sample span is sliced out of a
            device-resident [N, L] audio buffer at a TRACED offset — one
            compiled program serves every block position (per-offset
            eager slicing would compile once per block)."""
            span = jax.lax.dynamic_slice(
                audio, (0, offset), (audio.shape[0], need))
            return _fused_impl(span, v, mel_tail, primed, carry, n_mel,
                               n_dec, onst)

        spb = self.block * self.step_len

        @jax.jit
        def _scan_buffer(audio, k_arr, mel_tail, primed, carry,
                         n_mel, n_dec, onst):
            """Decode ``n_blocks`` consecutive blocks from a device
            buffer in ONE dispatch: a lax.scan over block offsets with
            ALL bookkeeping (frame counts, priming, skip) carried on
            device — the dispatch-per-block path pays one set of
            host-argument transfers per block.

            ``k_arr`` holds the block indices to decode (its length is
            the static block count; jit recompiles per distinct count).
            Returns (state', hist_compact [K*block, N]): the scanned
            histories with each row's valid frames contiguous from the
            start (only the FIRST-ever block skips the delay gate, so
            one static gather removes the gap)."""
            N = audio.shape[0]
            vb = jnp.full((N,), self.block, jnp.int32)

            def body(st, k):
                mel_tail, primed, carry, n_mel, n_dec, onst = st
                span = jax.lax.dynamic_slice(
                    audio, (0, k * spb), (N, need))
                skip = jnp.clip(jnp.int32(s) - n_mel, 0, vb)
                new_tail, primed, carry, hist, onst = _fused_impl(
                    span, vb, mel_tail, primed, carry, n_mel, n_dec,
                    onst)
                return (new_tail, primed, carry, n_mel + vb,
                        n_dec + vb - skip, onst), hist

            st0 = (mel_tail, primed, carry, n_mel.astype(jnp.int32),
                   n_dec.astype(jnp.int32), onst)
            K = k_arr.shape[0]
            st, hists = jax.lax.scan(body, st0, k_arr)
            skip0 = jnp.clip(jnp.int32(s) - n_mel.astype(jnp.int32),
                             0, self.block)           # [N]
            return st, self._compact_scan(hists, skip0, K, N)

        self._scan_buffer = _scan_buffer

        @jax.jit
        def _fused_flush(mel_tail, carry, n_mel, n_dec):
            """ProcessTail per stream (srec.cpp:877-927): repeat each
            row's last mel frame trap_shift times; rows with n_mel < s
            valid frames flush only n_mel rows."""
            reps = jnp.repeat(mel_tail[:, -1:], s, axis=1)
            ctx = jnp.concatenate([mel_tail, reps], axis=1)  # [N, 3s, nb]
            skip = jnp.clip(jnp.int32(s) - n_mel.astype(jnp.int32), 0, s)
            return _decode_ctx(ctx, skip, carry, n_dec, s - skip, s)

        self._fused = _fused
        self._fused_from_buffer = _fused_from_buffer
        self._fused_flush = _fused_flush

    # -- decoder hooks (overridden by the stkint subclasses) -------------
    def _check_decoder(self, sr: SpeechRec) -> None:
        if sr.stk_decoder is not None:
            raise ValueError(
                "MultiStreamRecognizer serves the phnloop decoder; for "
                "stkint packages use MultiStreamStkDecode (decode mode) "
                "or MultiStreamKWS (kws mode)")

    # stream count from which the conv-based LCRC assembly replaces the
    # window gather.  An unmeasured default on the GPU (ROADMAP.md,
    # Design item 4); a class attribute so tests can force either path
    # at small scale
    conv_assembly_min_streams = 128

    # -- shared InputXform delay-line carry (stkint subclasses) ----------
    # the reference applies the global <InputXform> per frame with live
    # delay-line memory (ModelSet::UpdateStacks from every ViterbiStep,
    # Viterbi.cc:2068); here each stream carries its stacking FIFOs
    # [N, K-1, D] inside the fused dispatch and advances them by exactly
    # its valid-row count (ragged blocks)
    _xform_inst = None

    def _xform_state0(self):
        if self._xform_inst is None:
            return ()
        from phnrec_tpu.io.xform import instance_init_state
        st = instance_init_state(self._xform_inst)
        return jax.tree_util.tree_map(
            lambda a: jnp.tile(a[None], (self.n,) + (1,) * a.ndim), st)

    def _apply_xform(self, xst, lp, n_valid):
        """Per-stream stateful InputXform over a ragged block: rows
        >= n_valid[b] in stream b are padding and do not advance the
        delay lines."""
        if self._xform_inst is None:
            return xst, lp
        from phnrec_tpu.io.xform import apply_instance_stateful_ragged
        inst = self._xform_inst

        def one(st, x, nv):
            return apply_instance_stateful_ragged(inst, st, x, nv)

        return jax.vmap(one)(xst, lp, n_valid)

    def _init_decode_carry(self):
        return phnloop.init_carry(self.sr.loop_spec, self.n)

    def _carry_sharding(self, mesh):
        from jax.sharding import NamedSharding, PartitionSpec as P
        return NamedSharding(mesh, P(None, None, "data"))

    def _decode_block(self, carry, lp, n_dec, n_valid):
        """(decode carry, rolled log-posteriors [N, F, D], per-row global
        frame offsets, per-row valid counts) -> (carry', block output).

        The scan unroll adapts to the stream count: unrolling amortizes
        loop overhead at narrow widths, and a wide unrolled body is
        large.  The threshold is an unmeasured default on the GPU
        (ROADMAP.md, Design item 4)."""
        unroll = 8 if self.n <= 64 else 1
        return phnloop.viterbi_block_ragged(self.sr.loop_spec, carry, lp,
                                            n_dec, n_valid, unroll)

    def _compact_scan(self, hists, skip0, K: int, N: int):
        """Merge a scanned stack of block outputs into one entry.  For
        History: rows were rolled valid-first per block and only the
        first block of a fresh stream skips (delay gate), so one static
        gather removes the gap at the end of block 0's section."""
        TT = K * self.block
        j = jnp.arange(TT, dtype=jnp.int32)[:, None]
        idx = jnp.clip(
            j + jnp.where(j >= self.block - skip0[None, :],
                          skip0[None, :], 0), 0, TT - 1)
        return phnloop.History(*(
            jnp.take_along_axis(a.reshape(TT, N), idx, axis=0)
            for a in hists))

    # -- feeding ---------------------------------------------------------
    def process(self, i: int, raw: bytes) -> None:
        """Push raw audio bytes for stream ``i``."""
        if self._ended[i]:
            raise ValueError(f"stream {i} already ended")
        sr = self.sr
        if sr.wave_format == "lin16":
            raw = self._byte_rem[i] + raw
            cut = len(raw) - (len(raw) % 2)
            raw, self._byte_rem[i] = raw[:cut], raw[cut:]
            wave = (np.frombuffer(raw, dtype="<i2") if self._i16
                    else _convert_chunk(raw, sr))
        else:
            wave = _convert_chunk(raw, sr)
        self._bufs[i] = np.concatenate([self._bufs[i], wave])
        if self.auto_pump:
            self.pump()

    def end_stream(self, i: int) -> None:
        """Mark stream ``i`` finished (no more audio will arrive); its
        leftovers drain on subsequent pumps/finish."""
        self._ended[i] = True

    def _pending(self) -> np.ndarray:
        lens = np.asarray([b.shape[0] for b in self._bufs])
        return np.where(lens >= self.vs,
                        (lens - self.vs) // self.step_len + 1, 0)

    # -- fused dispatch --------------------------------------------------
    def _dispatch(self, v: np.ndarray) -> None:
        """One fused block consuming v[b] frames from stream b."""
        need = (self.block - 1) * self.step_len + self.vs
        span = np.zeros((self.n, need), self._bufs[0].dtype)
        for b in range(self.n):
            if v[b] > 0:
                take = (int(v[b]) - 1) * self.step_len + self.vs
                span[b, :take] = self._bufs[b][:take]
                self._bufs[b] = self._bufs[b][int(v[b]) * self.step_len:]
        self._record(v, self._fused(
            self._put(jnp.asarray(span), self._sh_audio),
            jnp.asarray(v, np.int32), self._mel_tail,
            self._primed, self._carry,
            jnp.asarray(self._n_mel, np.int32),
            jnp.asarray(self._n_dec, np.int32), self._onorm_state))

    def pump(self) -> int:
        """Dispatch fused blocks per the pump policy — lockstep (default:
        every live stream must fill a block; ended streams contribute
        what they have) or partial (any live stream with a full block
        triggers a dispatch and the rest contribute what they have).
        Returns the number of blocks dispatched."""
        n_blocks = 0
        while True:
            pending = self._pending()
            if self._ended.all():
                go = pending.max(initial=0) >= 1
            elif self.partial_pump:
                go = bool((pending[~self._ended] >= self.block).any())
            else:
                ready = np.where(self._ended, pending > 0,
                                 pending >= self.block)
                go = bool(np.all(ready | self._ended)
                          and pending.max(initial=0) >= self.block)
            if not go:
                return n_blocks
            self._dispatch(np.minimum(pending, self.block))
            n_blocks += 1

    def _record(self, v: np.ndarray, out) -> None:
        """Book-keep one fused dispatch's outputs."""
        new_tail, primed, carry, hist, self._onorm_state = out
        skip = np.clip(self.trap_shift - self._n_mel, 0, v)
        self._mel_tail, self._primed, self._carry = new_tail, primed, carry
        valid = (v - skip).astype(np.int64)
        self._hist.append((hist, valid))
        self._n_mel += v
        self._n_dec += valid
        self._primed_host |= v > 0
        self._maybe_commit()

    # -- fixed-lag commit (commit_horizon mode) --------------------------
    def _drop_committed_blocks(self) -> None:
        """Drop leading history/record blocks once EVERY stream's rows in
        them are committed (block 0 spans [row_offset_b,
        row_offset_b + v0_b)) — shared by the device/host phnloop commits
        and the stk record commit."""
        while self._hist:
            _, v0 = self._hist[0]
            if np.all(self._row_offset + v0 <= self._frame0):
                self._row_offset += v0.astype(np.int64)
                self._hist.pop(0)
            else:
                break

    def _hist_to_host(self) -> None:
        """Materialize retained device history blocks on the host in ONE
        batched fetch (their device copies are then droppable)."""
        dev = [i for i, (h, _) in enumerate(self._hist)
               if not isinstance(h[0], np.ndarray)]
        if not dev:
            return
        fetched = jax.device_get([self._hist[i][0] for i in dev])
        for i, h in zip(dev, fetched):
            self._hist[i] = (phnloop.History(*h), self._hist[i][1])

    def _stream_hist(self, b: int) -> Optional[phnloop.History]:
        cols = [tuple(np.asarray(a)[: int(v[b]), b] for a in h)
                for h, v in self._hist if v[b] > 0]
        if not cols:
            return None
        return phnloop.History(
            *(np.concatenate([c[j] for c in cols]) for j in range(3)))

    # -- device committed-window walk (phnloop commit_horizon mode) ------
    def _hist_device_uniform(self):
        """Validity key when ALL retained blocks are device-resident and
        stream-uniform (the lockstep serving steady state), else None."""
        if not self._hist or isinstance(self._hist[0][0][0], np.ndarray):
            return None
        valids = np.stack([v for _, v in self._hist])
        if not (valids == valids[:, :1]).all():
            return None
        return tuple(int(v[0]) for _, v in self._hist)

    def _walk_window_device(self, key):
        """One dispatch: concat the retained History blocks in HBM, run
        the committed-boundary device backtrack, gather the alpha row at
        each stream's horizon end (for forced splits).  Only compacted
        segments (~7 bytes each) + one [N] float row are fetched."""
        prog = self._res_cache.get(("walk", key))
        if prog is None:
            spec = self.sr.loop_spec

            @jax.jit
            def prog(blocks, n_rel, frame0, row_offset, h_end_rel):
                hist = phnloop.History(*(
                    jnp.concatenate([b[j][: key[k]]
                                     for k, b in enumerate(blocks)],
                                    axis=0) for j in range(3)))
                segs = phnloop.backtrack_device_committed(
                    spec, hist, n_rel, frame0, row_offset)
                a_h = jnp.take_along_axis(
                    hist.alpha, h_end_rel[None, :], axis=0)[0]
                return segs, a_h

            self._res_cache[("walk", key)] = prog
        T = sum(key)
        n_rel = (self._n_dec - self._row_offset).astype(np.int32)
        h_end_rel = np.clip(
            self._n_dec - (self.commit_horizon or 0) - 1
            - self._row_offset, 0, max(T - 1, 0)).astype(np.int32)
        segs, a_h = prog(tuple(h for h, _ in self._hist),
                         jnp.asarray(n_rel),
                         jnp.asarray(self._frame0.astype(np.int32)),
                         jnp.asarray(self._row_offset.astype(np.int32)),
                         jnp.asarray(h_end_rel))
        segs = phnloop.fetch_segments(
            segs, cap=min(4096, segs.phn.shape[1]))
        labels = phnloop.labels_from_segments(
            segs, self._n_dec, self.sr.phonemes,
            row_offset=self._row_offset)
        return labels, np.asarray(a_h)

    def _rebase_device(self, r: np.ndarray) -> None:
        """Jitted rebase of the retained device blocks + carry (one
        dispatch, cached per block pattern) instead of one eager
        subtraction per block."""
        key = ("rebase", len(self._hist))
        prog = self._res_cache.get(key)
        if prog is None:
            @jax.jit
            def prog(blocks, carry, r):
                blocks = tuple(
                    phnloop.History(h.max_phn, h.ent,
                                    h.alpha - r[None, :])
                    for h in blocks)
                alphas, ent = carry
                alphas = jnp.where(
                    alphas <= jnp.float32(phnloop.NEG_INF / 2), alphas,
                    alphas - r[None, None, :])
                return blocks, (alphas, ent)

            self._res_cache[key] = prog
        blocks, self._carry = prog(tuple(h for h, _ in self._hist),
                                   self._carry, jnp.asarray(r))
        self._hist = [(b, v) for b, (_, v) in zip(blocks, self._hist)]
        self._alpha0[:] = 0.0

    def _commit_device(self, key) -> None:
        """Fixed-lag commit with the walk + rebase on device: per cycle,
        two cached dispatches and a ~7-byte/segment fetch regardless of
        stream count (results() programs cached by the bounded
        retained-window pattern)."""
        labels_all, a_h = self._walk_window_device(key)
        for b in range(self.n):
            labels = labels_all[b]
            horizon_end = int(self._n_dec[b]) - self.commit_horizon
            commit = [l for l in labels if l.end_frames <= horizon_end]
            if not commit:
                # forced split at the horizon (ring semantics): the
                # spanning label's like telescopes exactly; a_h[b] is
                # the rebased path like at horizon_end-1
                if not labels or labels[0].start_frames >= horizon_end:
                    continue
                l0 = labels[0]
                commit = [Label(l0.start_frames, horizon_end, l0.name,
                                float(a_h[b]))]
            self._committed[b].extend(commit)
            # rebased alphas make the boundary alpha the sum of the
            # window labels committed so far (delta telescoping)
            self._alpha0[b] = float(sum(l.score for l in commit))
            self._frame0[b] = commit[-1].end_frames
        self._drop_committed_blocks()
        if self._alpha0.any():
            self._rebase_device(self._alpha0.astype(np.float32))

    def _maybe_commit(self) -> None:
        if self.commit_horizon is None or not self._hist:
            return
        retained = int((self._n_dec - self._row_offset).max(initial=0))
        if retained <= 2 * self.commit_horizon + self.block:
            return
        key = self._hist_device_uniform()
        if key is not None:
            self._commit_device(key)
            return
        self._hist_to_host()
        for b in range(self.n):
            hist_b = self._stream_hist(b)
            if hist_b is None:
                continue
            labels = phnloop.backtrack_committed(
                hist_b, int(self._row_offset[b]), int(self._frame0[b]),
                float(self._alpha0[b]), self.sr.phonemes)
            horizon_end = int(self._n_dec[b]) - self.commit_horizon
            commit = [l for l in labels if l.end_frames <= horizon_end]
            if not commit:
                # FORCED boundary (the reference's ring cannot hold a
                # segment longer than its lag either): split the label
                # spanning the horizon; its like telescopes exactly
                if not labels or labels[0].start_frames >= horizon_end:
                    continue
                l0 = labels[0]
                like = float(np.asarray(hist_b.alpha)[
                    horizon_end - 1 - int(self._row_offset[b])]) \
                    - float(self._alpha0[b])
                commit = [Label(l0.start_frames, horizon_end, l0.name,
                                like)]
            self._committed[b].extend(commit)
            e = commit[-1].end_frames
            self._alpha0[b] = float(np.asarray(hist_b.alpha)[
                e - 1 - int(self._row_offset[b])])
            self._frame0[b] = e
        self._drop_committed_blocks()
        self._rebase_alphas()

    def _rebase_alphas(self) -> None:
        """Subtract each stream's committed like from its retained
        scores (shift-invariant recurrence): |alpha| stays bounded by
        the window like over multi-day sessions, where session-
        cumulative float32 scores would quantize below log(0.5)."""
        r = self._alpha0.astype(np.float32)
        if not r.any():
            return
        alphas, ent = self._carry
        rv = jnp.asarray(r)[None, None, :]
        self._carry = (jnp.where(
            alphas <= jnp.float32(phnloop.NEG_INF / 2), alphas,
            alphas - rv), ent)
        self._hist = [
            (phnloop.History(h.max_phn, h.ent,
                             h.alpha - r[None, :]), v)
            for h, v in self._hist]
        self._alpha0[:] = 0.0

    def shard_audio(self, audio) -> "jnp.ndarray":
        """Place an [N, L] sample buffer with the stream axis sharded
        over the mesh (no-op without a mesh) — use before
        decode_device_buffer / dispatch_from_device_buffer."""
        return self._put(jnp.asarray(audio), self._sh_audio)

    # -- device-resident feeding (benchmark / production DMA path) -------
    def dispatch_block_device(self, span_dev) -> None:
        """Advance EVERY stream by exactly ``block`` frames from a
        device-resident sample span [N, (block-1)*step + vs] — the
        zero-host-copy path for inputs that already live in HBM (e.g.
        network DMA in production; pre-staged audio in benchmarks)."""
        v = np.full(self.n, self.block, np.int64)
        self._record(v, self._fused(
            span_dev, jnp.asarray(v, np.int32), self._mel_tail,
            self._primed, self._carry,
            jnp.asarray(self._n_mel, np.int32),
            jnp.asarray(self._n_dec, np.int32), self._onorm_state))

    def decode_device_buffer(self, audio_dev, n_blocks: int,
                             first_block: int = 0) -> None:
        """Advance every stream by ``n_blocks`` * block frames from a
        device-resident [N, L] sample buffer in ONE jitted dispatch
        (scan over block offsets, all bookkeeping on device) — the
        steady-state serving loop with zero per-block host traffic."""
        # the scanned compaction removes ONE delay-gate gap at the end of
        # the scan's first block; any stream whose remaining skip
        # (trap_shift - n_mel) exceeds block_frames would spill skip into
        # block 1 and corrupt the compacted history
        if np.any(self.trap_shift - self._n_mel > self.block):
            raise ValueError(
                "decode_device_buffer needs block_frames >= each "
                "stream's remaining delay-gate skip (trap_shift - "
                "frames_seen); feed more audio via process() first or "
                "use a larger block")
        k_arr = jnp.arange(first_block, first_block + n_blocks,
                           dtype=jnp.int32)
        st, hist = self._scan_buffer(
            audio_dev, k_arr, self._mel_tail, self._primed, self._carry,
            jnp.asarray(self._n_mel, np.int32),
            jnp.asarray(self._n_dec, np.int32), self._onorm_state)
        self._mel_tail, self._primed, self._carry = st[0], st[1], st[2]
        self._onorm_state = st[5]
        skip0 = np.clip(self.trap_shift - self._n_mel, 0, self.block)
        valid = (np.int64(n_blocks) * self.block - skip0).astype(np.int64)
        self._hist.append((hist, valid))
        self._n_mel += n_blocks * self.block
        self._n_dec += valid
        self._primed_host[:] = True
        self._maybe_commit()

    def dispatch_from_device_buffer(self, audio_dev, sample_offset: int
                                    ) -> None:
        """Advance every stream by ``block`` frames reading samples
        [sample_offset, sample_offset + span) from a device-resident
        [N, L] buffer.  The offset is traced, so one compiled program
        serves the whole buffer."""
        v = np.full(self.n, self.block, np.int64)
        self._record(v, self._fused_from_buffer(
            audio_dev, jnp.int32(sample_offset), jnp.asarray(v, np.int32),
            self._mel_tail, self._primed, self._carry,
            jnp.asarray(self._n_mel, np.int32),
            jnp.asarray(self._n_dec, np.int32), self._onorm_state))

    # -- results ---------------------------------------------------------
    def finish(self) -> List[List[Label]]:
        """Drain leftovers, flush the STC tail, backtrack every stream."""
        if not self._flushed:
            self._ended[:] = True
            # pump() with every stream ended drains ALL pending frames
            # (ragged final blocks included)
            while self.pump():
                pass
            if self._primed_host.any():
                carry, hist = self._fused_flush(
                    self._mel_tail, self._carry,
                    jnp.asarray(self._n_mel, np.int32),
                    jnp.asarray(self._n_dec, np.int32))
                self._carry = carry
                valid = np.where(self._primed_host,
                                 np.minimum(self.trap_shift, self._n_mel),
                                 0).astype(np.int64)
                self._hist.append((hist, valid))
                self._n_dec += valid
            self._flushed = True
            self.save_norm_params()
        return self.results()

    def save_norm_params(self) -> None:
        """Persist each stream's frozen online-norm estimate to the
        config's onlinenorm/file, channel id = stream index — the
        multi-stream form of the reference's per-channel XML save
        (norm.cpp:230,309-364)."""
        on = self.online_norm
        if (not on.enabled or self._on_E == 0 or on.file in ("", "none")
                or not self._onorm_state):
            return
        cnt, sx, sxx = jax.device_get(self._onorm_state)
        from phnrec_tpu.io.normfile import save_norm_file
        # start from channels already known to the host estimator (e.g.
        # loaded from this same file at init) so a re-save never drops
        # them — the reference saves its full channel map (norm.cpp:309)
        chans = {cid: (st["mean"], st["inv_std"])
                 for cid, st in on.channels.items()}
        E = np.float32(self._on_E)
        saved = 0
        for b in range(self.n):
            if int(cnt[b]) >= self._on_E:
                mean = (sx[b] / E).astype(np.float32)
                var = np.maximum(sxx[b] / E - mean * mean,
                                 np.float32(1e-20))
                chans[b] = (mean, (1.0 / np.sqrt(var)).astype(np.float32))
                saved += 1
        if saved:
            save_norm_file(on.file, chans)

    def results(self) -> List[List[Label]]:
        """Backtrack every stream's accumulated history (stitched onto
        the committed prefix in commit_horizon mode)."""
        if self.commit_horizon is not None:
            key = self._hist_device_uniform()
            if key is not None:
                window, _ = self._walk_window_device(key)
                return [self._committed[b] + window[b]
                        for b in range(self.n)]
            self._hist_to_host()
            out: List[List[Label]] = []
            for b in range(self.n):
                hist_b = self._stream_hist(b)
                tail = [] if hist_b is None else \
                    phnloop.backtrack_committed(
                        hist_b, int(self._row_offset[b]),
                        int(self._frame0[b]), float(self._alpha0[b]),
                        self.sr.phonemes)
                out.append(self._committed[b] + tail)
            return out
        if not self._hist:
            return [[] for _ in range(self.n)]
        valids = np.stack([v for _, v in self._hist])      # [K, N]
        uniform = bool((valids == valids[:, :1]).all())
        if uniform:
            # lockstep fast path: every row has the same per-block
            # validity, so compaction is device-side slicing and the
            # backtrack runs on device (tiny D2H: ~7 bytes/segment).
            # The whole assemble+backtrack is ONE jitted program, cached
            # per validity pattern, instead of eager slicing/packing.
            key = tuple(int(v[0]) for _, v in self._hist)
            T = sum(key)
            if T == 0:
                return [[] for _ in range(self.n)]
            if T < 1 << 20:
                prog = self._res_cache.get(key)
                if prog is None:
                    spec = self.sr.loop_spec

                    @jax.jit
                    def prog(blocks, n_dec):
                        hist = phnloop.History(*(
                            jnp.concatenate(
                                [b[j][: key[k]]
                                 for k, b in enumerate(blocks)], axis=0)
                            for j in range(3)))
                        return phnloop.backtrack_device(spec, hist, n_dec)

                    self._res_cache[key] = prog
                segs = prog(tuple(h for h, _ in self._hist),
                            jnp.asarray(self._n_dec, jnp.int32))
                segs = phnloop.fetch_segments(
                    segs, cap=min(4096, segs.phn.shape[1]))
                return phnloop.labels_from_segments(
                    segs, self._n_dec, self.sr.phonemes)
            fetched = jax.device_get(phnloop.History(*(
                np.concatenate([np.asarray(h[j])[: int(v[0])]
                                for h, v in self._hist], axis=0)
                for j in range(3))))
            return phnloop.backtrack_batch(
                phnloop.History(*fetched), self._n_dec, self.sr.phonemes)
        # ragged path: fetch once, compact per stream on host
        self._hist_to_host()
        out = []
        for b in range(self.n):
            hist_b = self._stream_hist(b)
            out.append([] if hist_b is None else
                       phnloop.backtrack(hist_b, self.sr.phonemes))
        return out


class MultiStreamKWS(MultiStreamRecognizer):
    """N concurrent LIVE KEYWORD-SPOTTING streams per chip: the full
    stkint KWS chain — posterior stack, dense-network Viterbi
    (NetworkDecoder.scan_block) and the LRTrace candidate state machine
    — batched over streams inside the same fused block dispatches as the
    phnloop server.  Per-stream hits are identical to a single-stream
    StreamingRecognizer in KWS mode (tests/test_multistream_kws.py).

    The per-stream carry is (network token state [N, ...], LRTrace state
    [N, K], beam [N], InputXform delay lines [N, ...]); flush events
    accumulate on device and are decoded on the host at
    results()/finish().  A global <InputXform> (no shipped KWS package
    has one, but the capability is declared) is carried per stream via
    the ragged stateful form (io/xform.py) inside the fused dispatch."""

    def __init__(self, sr: SpeechRec, n_streams: int,
                 block_frames: int = 128, auto_pump: bool = True,
                 mesh=None):
        dec = sr.stk_decoder
        if dec is None or dec.mode != "kws":
            raise ValueError("MultiStreamKWS needs an stkint package "
                             "with decoder/mode=kws")
        self._xform_inst = dec.model_set.input_xform
        from phnrec_tpu.decoder.stknet import (DenseKWSScan, OFF_BEAM,
                                               lrtrace_step_fn)
        self._dec = dec
        self._keywords = dec.keywords()
        c = dec.compiled
        if c.kws_filler_sink is None or not c.kws_word_sinks:
            raise ValueError(
                "KWS network needs a filler-end sink and at least one "
                "sticky keyword-end node (stkinterface.cpp:107-155 node "
                "discovery found none in this network)")
        self._kws_ws = jnp.asarray(np.asarray(c.kws_word_sinks, np.int32))
        self._kws_fs = c.kws_filler_sink
        self._beam0 = float(OFF_BEAM if dec.beam_pruning is None
                            else dec.beam_pruning)
        self._trk_step = lrtrace_step_fn(dec.time_pruning,
                                         dec.kws_score_pruning)
        # dense max-plus network step (see DenseKWSScan): hit-for-hit
        # parity with the gather-based edge-list scan; the default for
        # its fused single-scan structure.  Opt out with
        # PHNREC_TPU_DENSE_KWS=0 (or very large networks).
        import os
        self._dense = None
        if os.environ.get("PHNREC_TPU_DENSE_KWS", "1") != "0" and \
                c.n_models + c.n_states <= 1024:
            self._dense = DenseKWSScan(dec.decoder)
        self._hits_emitted = [0] * n_streams
        # per-stream Label lists, built INCREMENTALLY as event blocks
        # are fetched (decoded device blocks are dropped — a long-lived
        # serving session must not accumulate them)
        self._labels = [[] for _ in range(n_streams)]
        self._final_done = False
        super().__init__(sr, n_streams, block_frames=block_frames,
                         auto_pump=auto_pump, mesh=mesh)

    def set_beam_pruning(self, v: Optional[float]) -> None:
        """Live beam-pruning knob (SetBeamPruning, stkinterface.h:108):
        the width rides in the decode carry, so changing it affects the
        next dispatch without recompiling."""
        from phnrec_tpu.decoder.stknet import OFF_BEAM
        beam = jnp.full((self.n,), OFF_BEAM if v is None else v,
                        jnp.float32)
        self._carry = self._carry[:2] + (self._put(beam, self._sh_rows),
                                         self._carry[3])

    # -- decoder hooks ---------------------------------------------------
    def _check_decoder(self, sr: SpeechRec) -> None:
        pass                                   # validated in __init__

    def _init_decode_carry(self):
        from phnrec_tpu.decoder.stknet import lrtrace_init_state
        if self._dense is not None:
            stk = self._dense.init_carry(self.n)
        else:
            stk0 = self._dec.decoder.init_carry()
            stk = jax.tree_util.tree_map(
                lambda a: jnp.tile(a[None], (self.n,) + (1,) * a.ndim),
                stk0)
        trk = jax.tree_util.tree_map(
            lambda a: jnp.tile(a[None], (self.n,) + (1,) * a.ndim),
            lrtrace_init_state(len(self._keywords)))
        # the beam width rides in the carry (one [N] row) so
        # set_beam_pruning stays a live knob without retracing
        return (stk, trk, jnp.full((self.n,), self._beam0, jnp.float32),
                self._xform_state0())

    def _carry_sharding(self, mesh):
        # every carry leaf has the stream axis LEADING
        from jax.sharding import NamedSharding, PartitionSpec as P
        return NamedSharding(mesh, P("data"))

    def _decode_block(self, carry, lp, n_dec, n_valid):
        dec = self._dec.decoder
        xst, lp = self._apply_xform(carry[3], lp, n_valid)
        obs_state = jax.vmap(dec.state_observations)(lp)   # [N, F, E]
        ws, fs = self._kws_ws, self._kws_fs
        step = self._trk_step

        def trk_one(st, sv, sw, t0, nv):
            F = sv.shape[0]
            tt = t0 + jnp.arange(F, dtype=jnp.int32)
            live = jnp.arange(F) < nv
            return jax.lax.scan(
                step, st,
                (sv[:, ws], sv[:, fs], sw[:, ws].astype(jnp.int32),
                 tt, live))

        if self._dense is not None:
            carry, events = self._decode_block_dense(
                carry[:3] + (xst,), obs_state, n_dec, n_valid)
        else:
            stk_c, trk, beam = carry[:3]

            def net_one(c, o, t0, nv, bm):
                # scan_block's n_valid is the ABSOLUTE frame bound
                return dec.scan_block(c, o, t0, t0 + nv, bm)

            stk_c, recs = jax.vmap(net_one)(stk_c, obs_state, n_dec,
                                            n_valid, beam)
            trk, events = jax.vmap(trk_one)(trk, recs["sink_val"],
                                            recs["sink_wt"], n_dec,
                                            n_valid)
            carry = (stk_c, trk, beam, xst)
        return carry, self._compact_events(events)

    def _compact_events(self, events):
        """Scatter the block's flush events into a small per-stream ring
        (device-side): the dense per-frame event records are
        ~56 bytes/frame/stream, which at serving scale makes the
        results() fetch link-bound (256 streams x 2 min ~ 170 MB); real
        hits are sparse, so a ring of H slots (+1 dump slot) captures
        them in ~1/40 the bytes.  Rows fill in flat (frame, slot,
        keyword) order — the reference callback order — so the ring IS
        the emission sequence; overflowing streams (count > H) fall
        back to fetching the dense block, which is kept alongside."""
        rec1, rec2 = events
        N = self.n
        F = rec1["emit"].shape[1]
        Kw = len(self._keywords)
        # generous ring: 1 hit per 2 frames per stream averaged across
        # keywords/slots (the noise-fed bench emits ~0.1/frame; real
        # speech orders less) — still ~7x smaller than the dense
        # records, and overflow falls back to them
        H = max(64, F // 4)
        L = F * 2 * Kw

        def stk(name):
            return jnp.stack([rec1[name], rec2[name]], axis=2)

        em = stk("emit")                       # [N, F, 2, Kw]
        flat = em.reshape(N, L)
        pos = jnp.cumsum(flat.astype(jnp.int32), axis=1) - 1
        idx = jnp.where(flat & (pos < H), pos, H)
        b_idx = jnp.arange(N)[:, None]

        def ring_of(vals, dt):
            z = jnp.zeros((N, H + 1), dt)
            return z.at[b_idx, idx].set(vals.reshape(N, L).astype(dt))

        slot_i = jax.lax.broadcasted_iota(jnp.int32, em.shape, 2)
        k_i = jax.lax.broadcasted_iota(jnp.int32, em.shape, 3)
        kid = (slot_i * Kw + k_i) * 2 \
            + stk("new_estim").astype(jnp.int32)
        return {
            "count": jnp.sum(flat, axis=1, dtype=jnp.int32),
            "start": ring_of(stk("start"), jnp.int32),
            "end": ring_of(stk("end"), jnp.int32),
            "score": ring_of(stk("score"), jnp.float32),
            "kid": ring_of(kid, jnp.int32),
            "dense": (rec1, rec2),
        }

    def _decode_block_dense(self, carry, obs_state, n_dec, n_valid):
        """Fused dense max-plus network step + LRTrace update in ONE
        scan over the block's frames (DenseKWSScan semantics == the
        edge-list scan, asserted in tests)."""
        dense = self._dense
        ws, fs = self._kws_ws, self._kws_fs
        trk_step = self._trk_step
        trk_vstep = jax.vmap(
            lambda st, wv, fl, w_s, t, lv: trk_step(st, (wv, fl, w_s, t,
                                                         lv)))
        xst = carry[3]

        def step(c, x):
            net_c, trk, beam = c
            obs_t, i = x                            # obs_t [N, E]
            t_net = n_dec + 1 + i                   # 1-based frame times
            live = i < n_valid
            net_c, (sv, sw) = dense.step(net_c, obs_t, t_net, live, beam)
            trk, events = trk_vstep(
                trk, sv[:, ws], sv[:, fs], sw[:, ws].astype(jnp.int32),
                n_dec + i, live)                    # tracker is 0-based
            return (net_c, trk, beam), events

        F = obs_state.shape[1]
        obs_fm = jnp.transpose(obs_state, (1, 0, 2))     # [F, N, E]
        carry3, events = jax.lax.scan(
            step, carry[:3], (obs_fm, jnp.arange(F, dtype=jnp.int32)))
        # events leaves [F, N, K] -> the [N, F, K] convention
        return carry3 + (xst,), jax.tree_util.tree_map(
            lambda a: jnp.transpose(a, (1, 0, 2)), events)

    def _compact_scan(self, hists, skip0, K: int, N: int):
        # per-scan-step compact rings keep their block axis (each
        # sub-ring has its own count); the dense fallback blocks merge
        # on the frame axis (dead frames emit nothing, so no gather)
        out = {k: jnp.moveaxis(hists[k], 0, 1)
               for k in ("count", "start", "end", "score", "kid")}
        out["dense"] = jax.tree_util.tree_map(
            lambda a: jnp.transpose(a, (1, 0, 2, 3)).reshape(
                N, -1, a.shape[3]), hists["dense"])
        return out

    # -- results ---------------------------------------------------------
    def _sync(self) -> None:
        """Fetch + decode any pending event blocks into the per-stream
        Label lists, then DROP them (decoded blocks are never re-read —
        a long-lived serving session must not accumulate device or host
        copies), and append the final candidate flush once after
        finish().  Only the compact hit rings are fetched; a stream
        whose ring overflowed (count > H) falls back to fetching that
        block's dense records."""
        from phnrec_tpu.decoder.stknet import (
            decode_lrtrace_events, flush_outstanding_candidates)

        if self._hist:
            # ONE batched fetch of the compact rings + counts
            fetched = jax.device_get(
                [{k: h[k] for k in ("count", "start", "end", "score",
                                    "kid")}
                 for h, _ in self._hist])
            denses = [h["dense"] for h, _ in self._hist]
            self._hist = []
            Kw = len(self._keywords)
            for comp, dense in zip(fetched, denses):
                cnt = np.asarray(comp["count"])
                multi = cnt.ndim == 2      # scanned dispatch: [N, Kb]
                if not multi:
                    cnt = cnt[:, None]
                Kb = cnt.shape[1]
                rings = {k: np.asarray(comp[k])
                         for k in ("start", "end", "score", "kid")}
                if not multi:
                    rings = {k: v[:, None] for k, v in rings.items()}
                H = rings["start"].shape[2] - 1
                dense_np = (jax.device_get(dense) if (cnt > H).any()
                            else None)
                # vectorized ring decode: one nonzero over [N, Kb, H]
                # (row-major = stream, block, emission order) + bulk
                # .tolist() — a per-element Python loop at serving hit
                # volumes (~100k+/session) dominates finish() otherwise.
                # A stream with ANY overflowed sub-ring decodes fully
                # from the dense records instead (keeps emission order
                # and avoids ring/dense duplication).
                ok_b = ~(cnt > H).any(axis=1)
                mask = ((np.arange(H)[None, None, :]
                         < np.minimum(cnt, H)[:, :, None])
                        & ok_b[:, None, None])
                bb, jj, rr = np.nonzero(mask)
                starts = rings["start"][bb, jj, rr].tolist()
                ends = rings["end"][bb, jj, rr].tolist()
                scores = rings["score"][bb, jj, rr].astype(
                    np.float64).tolist()
                kids = rings["kid"][bb, jj, rr].tolist()
                names = [self._keywords[(k >> 1) % Kw] for k in kids]
                bounds = np.searchsorted(bb, np.arange(self.n + 1))
                for b in range(self.n):
                    lo, hi = bounds[b], bounds[b + 1]
                    if lo != hi:
                        self._labels[b].extend(map(
                            Label, starts[lo:hi], ends[lo:hi],
                            names[lo:hi], scores[lo:hi]))
                for b in np.nonzero(~ok_b)[0]:
                    # rare: some sub-ring overflowed -> decode this
                    # stream's whole dispatch from the dense records
                    rec1, rec2 = dense_np
                    sub = tuple(
                        {k2: np.asarray(v)[b] for k2, v in rec.items()}
                        for rec in (rec1, rec2))
                    self._labels[b].extend(
                        Label(h.start, h.end, h.word, h.score)
                        for h in decode_lrtrace_events(
                            sub, self._keywords))
        if self._flushed and not self._final_done:
            # StkInterface::Done: flush outstanding candidates from the
            # final tracker state, per stream in keyword order
            self._final_done = True
            trk = jax.device_get(self._carry[1])
            sp = float(self._dec.kws_score_pruning)
            for b in range(self.n):
                row = tuple(leaf[b] for leaf in trk)
                self._labels[b].extend(
                    Label(h.start, h.end, h.word, h.score)
                    for h in flush_outstanding_candidates(
                        row, self._keywords, sp))

    def results(self) -> List[List[Label]]:
        """Per-stream KWS hits flushed so far (live callback stream); at
        finish() the outstanding candidates are force-flushed too."""
        self._sync()
        return [list(lb) for lb in self._labels]

    def hits_so_far(self, i: int) -> List[Label]:
        """Newly flushed hits for stream ``i`` since the last call — the
        per-stream live callback (DECMSG_WORD emission).  O(new hits),
        not O(session)."""
        self._sync()
        new = self._labels[i][self._hits_emitted[i]:]
        self._hits_emitted[i] = len(self._labels[i])
        return list(new)


class MultiStreamStkDecode(MultiStreamRecognizer):
    """N concurrent stkint DECODE-mode streams per chip: the live word-
    network serving mode (StkInterface::ProcessFrame decode branch with
    fixed-lag word emission, stkinterface.cpp:214-238) batched over
    streams inside the same fused block dispatches as the phnloop server.

    The per-stream carry is (network token state [N, ...], beam [N],
    InputXform delay lines [N, ...]); the vmapped edge-list scan
    (NetworkDecoder.scan_block) emits per-frame traceback records that
    stay in HBM.  Fixed-lag commit mirrors the single-stream path
    (_stk_commit, streaming.py) but runs the traceback ON DEVICE over
    the retained window (NetworkDecoder._traceback_batch with the
    committed-boundary stop): only crossed-edge ids/values (~8 bytes per
    frame per stream) ever leave the chip, instead of the ~0.7 kB/frame
    record rows — labels ending >= time_pruning frames behind the newest
    frame (the reference's TimePruning ring, Viterbi.cc:65-125) move to
    a committed list and their record blocks are dropped from HBM,
    bounding memory at O(N * horizon) for unbounded serving sessions.
    Ragged (non-lockstep) sessions fall back to a host-side walk.
    Per-stream outputs are identical to a single-stream
    StreamingRecognizer on the same package
    (tests/test_multistream_stk.py)."""

    # record keys the traceback consumes (exit_val / sink_wt dropped at
    # the dispatch boundary — decode mode never reads them)
    _WALK_KEYS = ("in_am", "ex_am", "cm_am", "entry_edge", "entry_val",
                  "sink_val", "cs_am")

    def __init__(self, sr: SpeechRec, n_streams: int,
                 block_frames: int = 128, auto_pump: bool = True,
                 mesh=None, record_horizon: Optional[int] = None):
        dec = sr.stk_decoder
        if dec is None or dec.mode != "decode":
            raise ValueError("MultiStreamStkDecode needs an stkint "
                             "package with decoder/mode=decode")
        from phnrec_tpu.decoder.stknet import OFF_BEAM
        self._dec = dec
        self._beam0 = float(OFF_BEAM if dec.beam_pruning is None
                            else dec.beam_pruning)
        self._xform_inst = dec.model_set.input_xform
        # edge-id records fit int16 for every phnrec-scale network;
        # halves both HBM retention and (fallback-path) fetch bytes
        c = dec.compiled
        self._rec_i16 = max(len(c.in_src), len(c.ex_src),
                            len(dec.decoder.cm) or 1,
                            len(dec.decoder.cs) or 1) < (1 << 15)
        # dense max-plus step with edge-id record emission: replaces the
        # gather-heavy vmapped edge-list scan for small static networks
        # (same records, same tie-breaking — see DenseKWSScan); opt out
        # with PHNREC_TPU_DENSE_STK=0
        import os
        self._dense = None
        if os.environ.get("PHNREC_TPU_DENSE_STK", "1") != "0" and \
                c.n_models + c.n_states <= 1024:
            from phnrec_tpu.decoder.stknet import DenseKWSScan
            self._dense = DenseKWSScan(dec.decoder)
        # per-stream fixed-lag commit state (the multi-stream form of
        # streaming.py's _stk_committed/_stk_frame0/_stk_like0)
        self._stk_committed: List[List[Label]] = \
            [[] for _ in range(n_streams)]
        self._like0 = np.zeros(n_streams, np.float64)
        self._horizon = (record_horizon if record_horizon is not None
                         else max(4 * dec.time_pruning, 4 * block_frames,
                                  512))
        self._walk_cache: dict = {}
        # commit back-off: when a commit attempt settles nothing (e.g.
        # the terminal sink is unreachable over a stretch), do not
        # re-walk on every dispatch — each attempt on a GROWN window
        # compiles a fresh program and fetches a longer edge row.  The
        # next attempt waits until the window grows by another horizon
        # (geometric progress bound on compiles + fetch traffic; memory
        # still grows until a word settles, exactly like the
        # single-stream _stk_commit, which cannot drop unemitted words)
        self._next_commit_at = 0
        super().__init__(sr, n_streams, block_frames=block_frames,
                         auto_pump=auto_pump, mesh=mesh)

    # -- decoder hooks ---------------------------------------------------
    def _check_decoder(self, sr: SpeechRec) -> None:
        pass                                   # validated in __init__

    def _init_decode_carry(self):
        if self._dense is not None:
            stk = self._dense.init_carry_decode(self.n)
        else:
            stk0 = self._dec.decoder.init_carry()
            stk = jax.tree_util.tree_map(
                lambda a: jnp.tile(a[None], (self.n,) + (1,) * a.ndim),
                stk0)
        return (stk, jnp.full((self.n,), self._beam0, jnp.float32),
                self._xform_state0())

    def _carry_sharding(self, mesh):
        from jax.sharding import NamedSharding, PartitionSpec as P
        return NamedSharding(mesh, P("data"))

    def set_beam_pruning(self, v: Optional[float]) -> None:
        """Live beam-pruning knob (SetBeamPruning, stkinterface.h:108)."""
        from phnrec_tpu.decoder.stknet import OFF_BEAM
        beam = jnp.full((self.n,), OFF_BEAM if v is None else v,
                        jnp.float32)
        self._carry = (self._carry[0], self._put(beam, self._sh_rows),
                       self._carry[2])

    def _decode_block(self, carry, lp, n_dec, n_valid):
        dec = self._dec.decoder
        stk_c, beam, xst = carry
        xst, lp = self._apply_xform(xst, lp, n_valid)
        obs_state = jax.vmap(dec.state_observations)(lp)   # [N, F, E]

        if self._dense is not None:
            dense = self._dense

            def step(c, x):
                net_c, bm = c
                obs_t, i = x                       # obs_t [N, E]
                net_c, rec = dense.step_decode(net_c, obs_t,
                                               i < n_valid, bm)
                return (net_c, bm), rec

            F = obs_state.shape[1]
            (stk_c, _), recs = jax.lax.scan(
                step, (stk_c, beam),
                (jnp.transpose(obs_state, (1, 0, 2)),
                 jnp.arange(F, dtype=jnp.int32)))
            # record leaves [F, N, ...] -> the [N, F, ...] convention
            recs = jax.tree_util.tree_map(
                lambda a: jnp.moveaxis(a, 0, 1), recs)
        else:
            def net_one(c, o, t0, nv, bm):
                # scan_block's n_valid is the ABSOLUTE frame bound
                return dec.scan_block(c, o, t0, t0 + nv, bm)

            stk_c, recs = jax.vmap(net_one)(stk_c, obs_state, n_dec,
                                            n_valid, beam)
            recs = {k: recs[k] for k in self._WALK_KEYS}
        if self._rec_i16:
            for k in ("in_am", "ex_am", "cm_am", "entry_edge", "cs_am"):
                recs[k] = recs[k].astype(jnp.int16)
        return (stk_c, beam, xst), recs

    def _compact_scan(self, hists, skip0, K: int, N: int):
        """Scanned record blocks [K, N, F, ...] -> [N, K*F, ...] with the
        block-0 delay-gate gap removed (same gather as the base class,
        applied leaf-wise over the record dict)."""
        TT = K * self.block
        j = jnp.arange(TT, dtype=jnp.int32)[:, None]
        idx = jnp.clip(
            j + jnp.where(j >= self.block - skip0[None, :],
                          skip0[None, :], 0), 0, TT - 1)       # [TT, N]

        def comp(a):
            a = jnp.moveaxis(a, 2, 1).reshape((TT, N) + a.shape[3:])
            ix = idx.reshape((TT, N) + (1,) * (a.ndim - 2))
            return jnp.moveaxis(
                jnp.take_along_axis(a, ix.astype(jnp.int32), axis=0),
                0, 1)

        return jax.tree_util.tree_map(comp, hists)

    # -- retained-window traceback ---------------------------------------
    def _f0_rel(self) -> np.ndarray:
        """Committed boundary in window-relative frames (-1 = stream
        start: the t=0 entry crossing is the real utterance entry)."""
        return np.where(self._frame0 > 0,
                        self._frame0 - self._row_offset,
                        -1).astype(np.int32)

    def _device_walk(self) -> "Optional[List[List[Label]]]":
        """Assemble the retained record window IN HBM (device concat of
        the pending blocks, program cached per block-validity pattern)
        and run the batched device traceback; fetch only crossed-edge
        ids/values.  Returns per-stream window labels, or None when the
        retained blocks are not stream-uniform (ragged sessions use the
        host walk)."""
        if not self._hist:
            return [[] for _ in range(self.n)]
        valids = np.stack([v for _, v in self._hist])
        if not (valids == valids[:, :1]).all() or \
                not (self._row_offset == self._row_offset[0]).all():
            return None
        key = tuple(int(v[0]) for _, v in self._hist)
        prog = self._walk_cache.get(key)
        if prog is None:
            dec = self._dec.decoder

            @jax.jit
            def prog(blocks, n_rel, f0_rel):
                recs = {k: jnp.concatenate(
                    [b[k][:, : key[i]] for i, b in enumerate(blocks)],
                    axis=1) for k in blocks[0]}
                return dec._traceback_batch(recs, n_rel, f0_rel)

            self._walk_cache[key] = prog
        n_rel = (self._n_dec - self._row_offset).astype(np.int32)
        f0_rel = self._f0_rel()
        ok, sink_edge, sink_val, edges, vals = jax.device_get(prog(
            tuple(h for h, _ in self._hist), jnp.asarray(n_rel),
            jnp.asarray(f0_rel)))
        dec = self._dec.decoder
        return [
            dec.labels_from_edge_walk(
                ok[b], sink_edge[b], sink_val[b], edges[b], vals[b],
                int(n_rel[b]), frame_offset=int(self._row_offset[b]),
                frame0_rel=max(int(f0_rel[b]), 0),
                like0=float(self._like0[b]))
            for b in range(self.n)
        ]

    def _host_walk(self) -> List[List[Label]]:
        """Ragged fallback: fetch the retained blocks once (they become
        host arrays in place) and walk each stream's stitched records on
        the host (traceback_host with the committed-boundary stop)."""
        if not self._hist:
            return [[] for _ in range(self.n)]
        fetched = jax.device_get([h for h, _ in self._hist])
        self._hist = [(f, v)
                      for f, (_, v) in zip(fetched, self._hist)]
        dec = self._dec.decoder
        f0_rel = self._f0_rel()
        out: List[List[Label]] = []
        for b in range(self.n):
            rows = [{k: np.asarray(f[k])[b][: int(v[b])] for k in f}
                    for f, v in self._hist if v[b] > 0]
            if not rows:
                out.append([])
                continue
            rec = {k: np.concatenate([r[k] for r in rows])
                   for k in rows[0]}
            cut = max(int(f0_rel[b]), 0)
            rec = {k: a[cut:] for k, a in rec.items()}
            out.append(dec.traceback_host(
                rec,
                frame_offset=int(self._row_offset[b]) + cut,
                boundary=self._frame0[b] > 0,
                like_offset=float(self._like0[b])))
        return out

    def _window_walk(self) -> List[List[Label]]:
        w = self._device_walk()
        return self._host_walk() if w is None else w

    def _maybe_commit(self) -> None:
        retained = int((self._n_dec - self._row_offset).max(initial=0))
        if retained <= max(self._horizon, self._next_commit_at):
            return
        window = self._window_walk()
        r = np.zeros(self.n, np.float32)
        for b in range(self.n):
            horizon = int(self._n_dec[b]) - self._dec.time_pruning
            commit = [l for l in window[b] if l.end_frames <= horizon]
            if not commit:
                continue           # nothing settled yet; keep retaining
            self._stk_committed[b].extend(commit)
            r[b] = sum(l.score for l in commit)
            self._frame0[b] = commit[-1].end_frames
        self._drop_committed_blocks()
        if r.any():
            self._rebase_likes(r)
        retained = int((self._n_dec - self._row_offset).max(initial=0))
        # geometric back-off while nothing settles (see __init__ note)
        self._next_commit_at = (retained + self._horizon
                                if retained > self._horizon else 0)

    def _rebase_likes(self, r: np.ndarray) -> None:
        """Subtract each stream's newly committed like from its carried
        network scores and retained record values (the recurrence is
        shift-invariant) — cumulative float32 path likes stay bounded by
        the window like over multi-day serving sessions, mirroring the
        phnloop _rebase_alphas guarantee.  After the shift the committed
        boundary's cumulative like is exactly 0, so ``_like0`` (the walk
        seed) stays 0 and label deltas are unchanged."""
        from phnrec_tpu.decoder.stknet import NEG
        if not self._hist or isinstance(self._hist[0][0]["entry_val"],
                                        np.ndarray):
            for rec, _ in self._hist:
                for k in ("entry_val", "sink_val"):
                    a = rec[k]
                    np.subtract(a, r.reshape((self.n,) + (1,) *
                                             (a.ndim - 1)),
                                out=a, where=a > NEG / 2)
            self._rebase_carry_host(r)
            return
        key = ("rebase", len(self._hist))
        prog = self._walk_cache.get(key)
        if prog is None:
            dense = self._dense is not None

            @jax.jit
            def prog(blocks, carry, rr):
                def shift(a, axes):
                    rv = rr.reshape((self.n,) + (1,) * axes)
                    return jnp.where(a > NEG / 2, a - rv, a)

                blocks = tuple(
                    dict(b, entry_val=shift(b["entry_val"], 2),
                         sink_val=shift(b["sink_val"], 2))
                    for b in blocks)
                stk, beam, xst = carry
                if dense:
                    alpha, entry, entry_edge = stk
                    stk = (shift(alpha, 1), shift(entry, 1), entry_edge)
                else:
                    alpha, wt, entry, entry_edge, entry_wt = stk
                    stk = (shift(alpha, 1), wt, shift(entry, 1),
                           entry_edge, entry_wt)
                return blocks, (stk, beam, xst)

            self._walk_cache[key] = prog
        blocks, self._carry = prog(tuple(h for h, _ in self._hist),
                                   self._carry, jnp.asarray(r))
        self._hist = [(b, v) for b, (_, v) in zip(blocks, self._hist)]

    def _rebase_carry_host(self, r: np.ndarray) -> None:
        """Carry rebase for the host-fallback path (one jitted where)."""
        from phnrec_tpu.decoder.stknet import NEG
        prog = self._walk_cache.get("rebase_carry")
        if prog is None:
            dense = self._dense is not None

            @jax.jit
            def prog(carry, rr):
                def shift(a):
                    return jnp.where(a > NEG / 2, a - rr[:, None], a)

                stk, beam, xst = carry
                if dense:
                    alpha, entry, entry_edge = stk
                    stk = (shift(alpha), shift(entry), entry_edge)
                else:
                    alpha, wt, entry, entry_edge, entry_wt = stk
                    stk = (shift(alpha), wt, shift(entry), entry_edge,
                           entry_wt)
                return (stk, beam, xst)

            self._walk_cache["rebase_carry"] = prog
        self._carry = prog(self._carry, jnp.asarray(r))

    # -- results ---------------------------------------------------------
    def results(self, settled_only: bool = False) -> List[List[Label]]:
        """Per-stream word labels: committed prefix + traceback over the
        retained record window (ViterbiDone semantics per stream;
        settled_only keeps only labels ending >= time_pruning frames
        behind the newest frame — the fixed-lag callback view)."""
        window = self._window_walk()
        out: List[List[Label]] = []
        for b in range(self.n):
            labels = self._stk_committed[b] + window[b]
            if settled_only:
                horizon = int(self._n_dec[b]) - self._dec.time_pruning
                labels = [l for l in labels if l.end_frames <= horizon]
            out.append(labels)
        return out
