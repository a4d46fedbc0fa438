#!/usr/bin/env python3
"""Smoke run of the wav->rec path on one NVIDIA GPU, at the full widths
of the CZ SpeechDat N1500 package, on a package and audio generated from
a seed (phnrec_tpu/synth.py).

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --chips 4    # only the 4-card mesh phase

Phases, all in this one process (the CPU comparisons run on
``jax.devices("cpu")`` beside the card):

  1. device   JAX devices, card name and power limit, and what each
              precision mode computes on the card (error of a float32
              GEMM against float64)
  2. package  seeded CZ-width package (phndec), a serving variant without
              sentence norm, a KWS variant, and seeded utterances: 256 of
              8 s and 64 of 4-7.5 s
  3. cli      one utterance through ``phnrec_tpu.cli.main`` to a .rec
  4. batch    BatchPipeline on all of them in one padded batch:
              log-posteriors of each utterance's valid frames against the
              plain float32 reference (phnrec_tpu/reference.py) run on the
              CPU at that utterance's length, labels against the same
              entry point run on the CPU;
              compile time, memory, one timed pass; XLA's three-net MLP
              stage timed at the batch shape
  5. serving  StreamingRecognizer and MultiStreamRecognizer (8 streams)
              against the offline decode
  6. kws      MultiStreamKWS (XLA dense network step) from audio against
              the offline KWS decode; one dense KWS block at 256 streams
              timed

Every number line starts with the card's name and power limit.  Times are
this smoke batch's, not benchmark figures.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the script exits non-zero,
without that line, when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# phase sizes on the card: N_UTTS full-length utterances, and N_RAGGED
# shorter ones (RAGGED_LENGTHS fractions of UTT_SECONDS) in the same batch
N_UTTS, UTT_SECONDS = 256, 8.0
N_RAGGED, RAGGED_LENGTHS = 64, (0.5, 0.5625, 0.625, 0.6875, 0.75, 0.8125,
                                0.875, 0.9375)
N_STREAMS, STREAM_SECONDS = 8, 8.0
KWS_TIMING_STREAMS, KWS_BLOCK = 256, 128
# tolerances against the plain reference at "highest".  Two float32
# implementations differ by GEMM summation order, and each fast exp
# (posteriors/fexp.py) truncates to 2^-20 steps, so a few ulps at the
# input move outputs far more: perturbing the reference's own params by
# 5e-7 relative (about 4 ulps) moves its posteriors by up to 2.9e-5 and
# its log-posteriors by 2.2e-4 over 64 x 8 s utterances of this package
# (CPU).  These bounds sit at that float32 noise floor.
POST_ATOL, LOGPOST_ATOL, LOGPOST_MIN_POST = 3e-5, 3e-4, 1e-6
# KWS: hits of the live and the offline path agree in (start, end,
# keyword) and in score to KWS_LR_TIE, the cross-path float32 noise that
# tests/test_multistream_kws.py allows; two likelihood ratios (LRs) closer
# than that are a tie that rounding may break either way.  A hit may
# differ only where its LR is tied with the same keyword's LR at another
# frame of its span or of the KWS_TIE_WINDOW frames after it, and at
# least KWS_MIN_MATCH of the offline hits must match.
KWS_LR_TIE, KWS_TIE_WINDOW, KWS_MIN_MATCH = 5e-3, 40, 0.99
# compute and memory floors of the three-net MLP stage at 765,952
# frames on an H100 (ROADMAP.md, Speed item 2)
MLP_FLOOR_FRAMES = 765_952
MLP_FLOORS_MS = {"f32 compute": 35.0, "tf32 compute": 4.7, "memory": 8.2}


def card_name() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "no nvidia-smi output"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    """A phase's check; raises (so the run fails) where ``assert`` would
    vanish under ``python -O``."""
    if not ok:
        raise SmokeFailure(msg)


class Log:
    """Prints every line prefixed with the card."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _key(labels):
    return [_label_key(l) for l in labels]


def _label_key(label):
    return (label.start_frames, label.end_frames, label.name)


def _timed(fn, repeats: int = 3) -> float:
    """Median wall seconds of ``fn()``, which must end in
    block_until_ready; ``fn`` has been run once before (compiled)."""
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# -- 1. device ----------------------------------------------------------
def phase_device(log: Log) -> dict:
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    log(f"jax.devices() = {devs}")
    log(f"device_kind = {devs[0].device_kind}, count = {len(devs)}, "
        f"platform = {devs[0].platform}")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 512)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    out = {}
    for mode in ("highest", "high", "default"):
        prec = {"highest": jax.lax.Precision.HIGHEST,
                "high": jax.lax.Precision.HIGH,
                "default": jax.lax.Precision.DEFAULT}[mode]
        f = jax.jit(lambda x, y, p=prec: jnp.dot(x, y, precision=p))
        got = np.asarray(f(jnp.asarray(a), jnp.asarray(b)), np.float64)
        err = float(np.max(np.abs(got - exact)) / np.max(np.abs(exact)))
        out[mode] = err
        log(f"precision {mode}: max |GEMM - float64| / max |float64| = "
            f"{err:.3e} (float32 ~1e-7, bf16x3 ~1e-6, tf32 ~1e-4, "
            f"bf16 ~1e-3)")
    return out


# -- 2. package ---------------------------------------------------------
@dataclasses.dataclass
class Inputs:
    pkg: str           # phndec, CZ N1500 widths
    serve_pkg: str     # same widths, no sentence norm (online semantics)
    kws_pkg: str       # KWS variant of serve_pkg
    waves: list        # int16 utterances


def phase_package(work: str, log: Log, spec=None, n_utts: int = N_UTTS,
                  seconds: float = UTT_SECONDS, n_ragged: int = N_RAGGED,
                  seed: int = 0) -> Inputs:
    from phnrec_tpu import synth

    spec = spec or synth.CZ_N1500
    t0 = time.perf_counter()
    pkg = synth.write_package(os.path.join(work, "pkg"), seed, spec)
    serve = dataclasses.replace(spec, sent_mean_norm=False)
    serve_pkg = synth.write_package(os.path.join(work, "serve"), seed,
                                    serve)
    kws_pkg = synth.write_package(os.path.join(work, "kws"), seed, serve,
                                  decoder="kws")
    lengths = [seconds] * n_utts + [
        seconds * RAGGED_LENGTHS[i % len(RAGGED_LENGTHS)]
        for i in range(n_ragged)]
    waves = [synth.waveform([seed, 100, i], secs, spec.sample_freq)
             for i, secs in enumerate(lengths)]
    log(f"package: band nets {spec.band_inputs}->{spec.n_hidden}->"
        f"{spec.n_out} x2, merger {2 * spec.n_out}->{spec.n_hidden}->"
        f"{spec.n_out}, {spec.n_phonemes} phonemes; {n_utts} utterances "
        f"x {seconds:g} s and {n_ragged} of {min(lengths):g}-"
        f"{max(lengths[n_utts:] or [seconds]):g} s; written in "
        f"{time.perf_counter() - t0:.1f} s")
    return Inputs(pkg, serve_pkg, kws_pkg, waves)


# -- 3. cli -------------------------------------------------------------
def phase_cli(inp: Inputs, work: str, log: Log) -> int:
    from phnrec_tpu import cli
    from phnrec_tpu.pipeline import SpeechRec

    raw = os.path.join(work, "utt0.raw")
    rec = os.path.join(work, "utt0.rec")
    inp.waves[0].tofile(raw)
    rc = cli.main(["-c", inp.pkg, "-i", raw, "-o", rec])
    check(rc in (0, None), f"cli exit code {rc}")
    with open(rec) as f:
        lines = f.read().splitlines()
    check(bool(lines), "cli wrote an empty .rec")
    want = SpeechRec(inp.pkg).process_offline(
        "wf", "str", inp.waves[0].tobytes()).rec_lines()
    check([l.split()[:3] for l in lines] == [w.split()[:3] for w in want],
          "cli .rec differs from SpeechRec.process_offline")
    log(f"cli: {len(lines)} labels, first: {lines[0]}")
    return len(lines)


# -- 4. batch -----------------------------------------------------------
def cpu_params(sr, waves) -> list:
    """Frame-normalized mel params of each utterance, computed on the CPU
    with the package's frontend (the reference's input)."""
    import jax

    from phnrec_tpu import normalization

    fe = sr.frontend

    @jax.jit
    def par(w):
        p = fe(w.astype(np.float32), fe.frame_count(w.shape[0]))
        return normalization.frame_norm(p, sr.frame_shift, sr.frame_floor)

    with jax.default_device(_cpu()):
        return [np.asarray(par(jax.device_put(w, _cpu()))) for w in waves]


def reference_logpost(pkg: str, params: list, chunk: int = 32) -> list:
    """Each utterance's [T_b, n_out] log posteriors from the plain
    reference on the CPU, at its own length (utterances of one length run
    together)."""
    import jax

    from phnrec_tpu import reference

    model = reference.load_model(pkg)
    f = jax.jit(jax.vmap(lambda p: reference.log_posteriors(model, p)))
    by_len = {}
    for b, p in enumerate(params):
        by_len.setdefault(p.shape[0], []).append(b)
    out = [None] * len(params)
    with jax.default_device(_cpu()):
        for idx in by_len.values():
            for i in range(0, len(idx), chunk):
                part = idx[i:i + chunk]
                x = jax.device_put(np.stack([params[b] for b in part]),
                                   _cpu())
                for b, lp in zip(part, np.asarray(f(x))):
                    out[b] = lp
    return out


def _first_divergence(got, want, lp_dev, lp_cpu, T: int) -> str:
    """First frame where two label sequences differ, with the CPU's top-2
    log-posterior margin and the device/CPU difference there."""
    def per_frame(labels):
        names = np.full(T, "", object)
        for l in labels:
            names[l.start_frames:l.end_frames] = l.name
        return names

    g, w = per_frame(got), per_frame(want)
    diff = np.nonzero(g != w)[0]
    t = int(diff[0]) if diff.size else T - 1
    top2 = np.sort(lp_cpu[t])[-2:]
    return (f"first diverging frame {t}: device {g[t]!r} vs cpu {w[t]!r}; "
            f"cpu top-2 log-posterior margin {top2[1] - top2[0]:.3e}; "
            f"max |device - cpu| log-posterior there "
            f"{np.max(np.abs(lp_dev[t] - lp_cpu[t])):.3e}")


def phase_batch(inp: Inputs, log: Log, info_modes=("high", "default")
                ) -> dict:
    import jax
    import jax.numpy as jnp

    from phnrec_tpu import precision
    from phnrec_tpu.parallel.batch import BatchPipeline
    from phnrec_tpu.pipeline import SpeechRec

    precision.set_mode("highest")
    sr = SpeechRec(inp.pkg)
    bp = BatchPipeline(sr)
    wave, n_samples = bp.pad_batch(inp.waves)
    wave = wave.astype(np.int16)              # int16 on the link
    n_frames = bp.frame_counts(n_samples)
    T = int(sr.frontend.frame_count(wave.shape[1]))
    B = len(inp.waves)
    log(f"batch: {B} utterances of {int(n_frames.min())}-{T} frames, "
        f"padded to {T}: {B * T} frames")

    w_dev, nf_dev = jnp.asarray(wave), jnp.asarray(n_frames)
    t0 = time.perf_counter()
    compiled = BatchPipeline._core.lower(bp, w_dev, nf_dev, T).compile()
    log(f"batch: _core compile {time.perf_counter() - t0:.1f} s; "
        f"memory_analysis {compiled.memory_analysis()}")
    jax.block_until_ready(compiled(w_dev, nf_dev))
    t_core = _timed(lambda: jax.block_until_ready(compiled(w_dev, nf_dev)))

    res = bp.run_padded(wave, n_samples)      # the user entry point
    t_run = _timed(lambda: bp.run_padded(wave, n_samples), repeats=2)
    lp_dev = np.asarray(bp._post_core(w_dev, nf_dev, T))
    stats = jax.devices()[0].memory_stats() or {}
    audio_s = float(n_samples.sum()) / sr.cfg.get_int("source", "sample_freq")
    log(f"batch: smoke-batch times (not benchmark figures): device _core "
        f"{t_core * 1e3:.1f} ms, run_padded incl. transfer and labels "
        f"{t_run * 1e3:.1f} ms ({audio_s / t_run:.0f} audio-s/s); "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 'n/a')}")

    # plain reference on the CPU, from the CPU frontend's params, and the
    # same entry point run on the CPU at highest
    t0 = time.perf_counter()
    params = cpu_params(sr, inp.waves)
    lp_ref = reference_logpost(inp.pkg, params)
    log(f"batch: CPU reference in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with jax.default_device(_cpu()):
        bp_cpu = BatchPipeline(SpeechRec(inp.pkg))
        res_cpu = bp_cpu.run_padded(wave, n_samples)
        lp_cpu = np.asarray(bp_cpu._post_core(
            jax.device_put(wave, _cpu()), jax.device_put(n_frames, _cpu()),
            T))
    log(f"batch: CPU BatchPipeline in {time.perf_counter() - t0:.1f} s")

    # compare each utterance's valid frames only
    check([lp.shape[0] for lp in lp_ref] == [int(n) for n in n_frames],
          "reference and pipeline frame counts differ")

    def valid(lp):
        return np.concatenate([lp[b, :int(n)] for b, n in enumerate(n_frames)])

    lp_ref = np.concatenate(lp_ref)
    post_ref = np.exp(lp_ref)
    mask = post_ref >= LOGPOST_MIN_POST

    def errors(lp):
        lp = valid(lp)
        return (float(np.max(np.abs(np.exp(lp) - post_ref))),
                float(np.max(np.abs(lp - lp_ref)[mask])))

    post_err, lp_err = errors(lp_dev)
    cpu_post_err, cpu_lp_err = errors(lp_cpu)
    log(f"batch highest: max |posterior - ref| = {post_err:.3e} "
        f"(atol {POST_ATOL:g}); max |log-posterior - ref| where ref >= "
        f"{LOGPOST_MIN_POST:g} = {lp_err:.3e} (atol {LOGPOST_ATOL:g}); the "
        f"CPU run's: {cpu_post_err:.3e} and {cpu_lp_err:.3e}")
    bad = [b for b in range(B)
           if _key(res.labels[b]) != _key(res_cpu.labels[b])]
    n_labels = sum(len(l) for l in res.labels)
    log(f"batch labels: {n_labels} on the device, {B - len(bad)}/{B} "
        f"utterances identical to the CPU run")
    if bad:
        b = bad[0]
        log(f"batch labels: utterance {b} " + _first_divergence(
            res.labels[b], res_cpu.labels[b], lp_dev[b], lp_cpu[b],
            int(n_frames[b])))
    check(post_err <= POST_ATOL, "posteriors differ from the reference")
    check(lp_err <= LOGPOST_ATOL, "log-posteriors differ from the reference")
    check(not bad, f"{len(bad)} utterances' labels differ from the CPU")

    # for information: what the faster modes change
    arg_ref = lp_ref.argmax(-1)
    for mode in info_modes:
        precision.set_mode(mode)
        bp_m = BatchPipeline(SpeechRec(inp.pkg))
        lp_m = valid(np.asarray(bp_m._post_core(w_dev, nf_dev, T)))
        agree = float(np.mean(lp_m.argmax(-1) == arg_ref))
        log(f"batch {mode} (information): max |posterior - ref| = "
            f"{np.max(np.abs(np.exp(lp_m) - post_ref)):.3e}; frame argmax "
            f"agreement with the reference {agree:.6f}")
    precision.set_mode("highest")
    return {"post_err": post_err, "logpost_err": lp_err,
            "labels": n_labels, "core_s": t_core, "run_s": t_run,
            "frames": B * T, "T": T}


def phase_mlp(inp: Inputs, log: Log, n_frames: int) -> dict:
    """XLA's three-net MLP stage (band nets, ln, merger) at ``n_frames``
    rows: the bar a hand-written MLP kernel would have to beat."""
    import jax
    import jax.numpy as jnp

    from phnrec_tpu import precision
    from phnrec_tpu.pipeline import SpeechRec
    from phnrec_tpu.posteriors import mlp

    out = {}
    rng = np.random.default_rng(1)
    for mode in ("highest", "high"):
        precision.set_mode(mode)
        est = SpeechRec(inp.pkg).estimator

        @jax.jit
        def stage(left, right):
            lo = mlp.forward(est.band[0], left)
            ro = mlp.forward(est.band[1], right)
            m = jnp.concatenate([lo, ro], axis=-1)
            m = jnp.where(m > 0.0, jnp.log(jnp.maximum(m, 1e-37)), 0.0)
            return mlp.forward(est.merger, m)

        n_in = est.band[0].n_inp
        left = jnp.asarray(rng.standard_normal((n_frames, n_in)), jnp.float32)
        right = jnp.asarray(rng.standard_normal((n_frames, n_in)),
                            jnp.float32)
        jax.block_until_ready(stage(left, right))
        t = _timed(lambda: jax.block_until_ready(stage(left, right)), 5)
        out[mode] = t
        scale = n_frames / MLP_FLOOR_FRAMES
        floors = ", ".join(f"{k} {v * scale:.2f} ms"
                           for k, v in MLP_FLOORS_MS.items())
        log(f"mlp stage {mode}: {t * 1e3:.2f} ms at {n_frames} frames "
            f"(H100 floors rescaled to these frames: {floors})")
    precision.set_mode("highest")
    return out


# -- 5. serving ---------------------------------------------------------
def phase_serving(inp: Inputs, log: Log, n_streams: int = N_STREAMS,
                  seconds: float = STREAM_SECONDS, block: int = 64) -> int:
    from phnrec_tpu import synth
    from phnrec_tpu.multistream import MultiStreamRecognizer
    from phnrec_tpu.pipeline import SpeechRec
    from phnrec_tpu.streaming import StreamingRecognizer

    sr = SpeechRec(inp.serve_pkg)
    streams = [synth.waveform([0, 200, i], seconds).tobytes()
               for i in range(n_streams)]
    want = [_key(sr.process_offline("wf", "str", s).labels) for s in streams]
    for i, s in enumerate(streams):
        rec = StreamingRecognizer(sr, block_frames=block)
        for o in range(0, len(s), 3202):
            rec.process(s[o:o + 3202])
        check(_key(rec.finish()) == want[i], f"streaming stream {i}")
    ms = MultiStreamRecognizer(sr, n_streams=n_streams, block_frames=block)
    for o in range(0, max(len(s) for s in streams), 4800):
        for i, s in enumerate(streams):
            if o < len(s):
                ms.process(i, s[o:o + 4800])
    got = ms.finish()
    for i in range(n_streams):
        check(_key(got[i]) == want[i], f"multi-stream stream {i}")
    n = sum(len(w) for w in want)
    log(f"serving: StreamingRecognizer and MultiStreamRecognizer "
        f"({n_streams} streams x {seconds:g} s) equal the offline decode "
        f"({n} labels)")
    return n


# -- 6. kws -------------------------------------------------------------
def kws_tie(lr: np.ndarray, hit) -> tuple:
    """For a hit of one keyword, given that keyword's offline LR trace
    ``lr`` [T]: how far the hit's score lies from the LR at its own end
    frame, and from the nearest LR at another frame of its span or of the
    KWS_TIE_WINDOW frames after it.  Both within KWS_LR_TIE: the frame
    that ends the candidate is a tie that rounding may break either way."""
    t_end = hit.end_frames - 1
    own = abs(float(lr[t_end]) - hit.score)
    other = np.r_[lr[hit.start_frames:t_end],
                  lr[t_end + 1:t_end + 1 + KWS_TIE_WINDOW]]
    return own, float(np.min(np.abs(other - hit.score), initial=np.inf))


def phase_kws(inp: Inputs, log: Log, n_streams: int = N_STREAMS,
              seconds: float = STREAM_SECONDS,
              timing_streams: int = KWS_TIMING_STREAMS,
              timing_block: int = KWS_BLOCK) -> dict:
    """MultiStreamKWS from audio against the offline KWS decode of each
    stream.  With random weights a keyword's LR is often flat over frames
    (its end token and the filler's best token take the same
    observations), so its candidate's end frame can turn on float32
    rounding: every hit that differs must sit on such a tie, and at least
    KWS_MIN_MATCH of the offline hits must match."""
    import jax
    import jax.numpy as jnp

    from phnrec_tpu import synth
    from phnrec_tpu.decoder.stknet import DenseKWSScan
    from phnrec_tpu.multistream import MultiStreamKWS
    from phnrec_tpu.pipeline import SpeechRec

    sr = SpeechRec(inp.kws_pkg)
    dec = sr.stk_decoder
    keywords = dec.keywords()
    streams = [synth.waveform([0, 300, i], seconds).tobytes()
               for i in range(n_streams)]
    want, lrs = [], []
    for s in streams:
        post = sr.posteriors_from_params(sr.params_from_waveform(s))
        lp = np.asarray(sr.dec_soft(jnp.asarray(post)))
        want.append(dec.decode(lp))
        # the LR trace of the scan decode() runs, for the tie margins
        wv, fv, _ = dec.decoder.kws_scan(lp, beam=dec.beam_pruning)
        lrs.append(np.asarray(wv) - np.asarray(fv)[:, None])
    live = MultiStreamKWS(sr, n_streams=n_streams, block_frames=32)
    check(isinstance(live._dense, DenseKWSScan), "not the XLA dense step")
    for i, s in enumerate(streams):
        live.process(i, s)
    got = live.finish()

    n_want = sum(len(w) for w in want)
    n_got = sum(len(g) for g in got)
    check(n_want > 0, "no keyword hits on any stream")
    n_same, score_gap, ties = 0, 0.0, []
    for i in range(n_streams):
        w = {_label_key(h): h for h in want[i]}
        g = {_label_key(h): h for h in got[i]}
        for k in w.keys() & g.keys():
            n_same += 1
            score_gap = max(score_gap, abs(w[k].score - g[k].score))
        for side, only in (("offline", w.keys() - g.keys()),
                           ("live", g.keys() - w.keys())):
            for k in sorted(only):
                h = (w if side == "offline" else g)[k]
                own, other = kws_tie(lrs[i][:, keywords.index(h.name)], h)
                ties.append((own, other))
                log(f"kws: stream {i} {side} only {k} LR {h.score:.5f}: "
                    f"{own:.3e} from the offline LR at its end frame, "
                    f"{other:.3e} from the nearest other frame's")
    log(f"kws: MultiStreamKWS from audio ({n_streams} streams x "
        f"{seconds:g} s, XLA dense step): {n_got} hits, offline decode "
        f"{n_want}, {n_same} equal in (start, end, keyword), max score "
        f"gap {score_gap:.3e}; {len(ties)} differ (tie {KWS_LR_TIE:g})")
    check(score_gap <= KWS_LR_TIE, "kws scores differ")
    check(n_same >= KWS_MIN_MATCH * n_want and
          n_got - n_same <= (1 - KWS_MIN_MATCH) * n_want,
          f"kws: only {n_same} of {n_want} offline hits match")
    check(all(max(t) <= KWS_LR_TIE for t in ties),
          "kws: a differing hit is not on an LR tie")

    # one dense KWS block at timing_streams streams, compile excluded
    big = MultiStreamKWS(sr, n_streams=timing_streams,
                         block_frames=timing_block, auto_pump=False)
    rng = np.random.default_rng(2)
    lp = jnp.asarray(np.log(rng.dirichlet(
        np.ones(sr.estimator.n_outs), size=(timing_streams, timing_block))
        .astype(np.float32) + 1e-30))
    n_dec = jnp.zeros(timing_streams, jnp.int32)
    n_valid = jnp.full(timing_streams, timing_block, jnp.int32)
    step = jax.jit(big._decode_block)
    jax.block_until_ready(step(big._carry, lp, n_dec, n_valid))
    t = _timed(lambda: jax.block_until_ready(
        step(big._carry, lp, n_dec, n_valid)), 5)
    us = t / timing_block * 1e6
    log(f"kws: dense block {timing_streams} streams x {timing_block} "
        f"frames {t * 1e3:.2f} ms = {us:.1f} us per frame-step "
        f"(compile excluded)")
    return {"hits": n_want, "same": n_same, "us_per_frame_step": us}


# -- 4 cards ------------------------------------------------------------
def phase_mesh(log: Log, n_devices: int, per_device: int = 16,
               seconds: float = UTT_SECONDS,
               stream_seconds: float = 4.0) -> dict:
    import __graft_entry__

    t0 = time.perf_counter()
    out = __graft_entry__.dryrun_multichip(
        n_devices, per_device=per_device, seconds=seconds,
        stream_seconds=stream_seconds)
    log(f"mesh: {n_devices} devices, {out['batch']} utterances x "
        f"{seconds:g} s and {out['streams']} streams x {stream_seconds:g} "
        f"s: sharded labels equal single-device labels, max score gap "
        f"{out['score_gap']:.3e} ({time.perf_counter() - t0:.1f} s incl. "
        f"compile)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the 4-card mesh phase")
    args = ap.parse_args(argv)

    import jax

    # the repo must sit beside this script: fail before using the card
    import phnrec_tpu  # noqa: F401

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
              "not a GPU", file=sys.stderr)
        return 1
    card = card_name()
    print(card, flush=True)
    log = Log(card)
    phase_device(log)
    if args.chips == 4:
        if len(jax.devices()) < 4:
            print("chip_smoke: --chips 4 needs four GPUs", file=sys.stderr)
            return 1
        phase_mesh(log, 4)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            inp = phase_package(work, log)
            phase_cli(inp, work, log)
            batch = phase_batch(inp, log)
            phase_mlp(inp, log, n_frames=N_UTTS * batch["T"])
            phase_serving(inp, log)
            phase_kws(inp, log)
    d = jax.devices()[0]
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
