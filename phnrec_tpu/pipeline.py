"""Pipeline orchestration: SpeechRec.

Reference: srec.{cpp,h} — the integration class that owns config, frontend,
posterior estimator and decoder, and routes data between pipeline stages.
Stages and their staged-I/O entry/exit points (srec.cpp:929-1111):

    wf ----> par ----> post ----> str
    raw      HTK       HTK        .rec / MLF
    audio    features  posteriors

Unlike the reference's frame-at-a-time streaming objects, every stage here
is a pure function over whole-utterance [T, D] tensors; the jitted core
(params -> posteriors) is shared by all entry points.  Streaming/live mode
chunks the same functions with carried state (see streaming.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu import normalization, softening
from phnrec_tpu.config import PhnRecConfig
from phnrec_tpu.decoder.phnloop import PhnLoopSpec
from phnrec_tpu.frontend import melbanks
from phnrec_tpu.io import audio, htk
from phnrec_tpu.io.labels import Label, MLFWriter, format_rec_line
from phnrec_tpu.io.weights import load_phoneme_list
from phnrec_tpu.posteriors.estimator import build_estimator
from phnrec_tpu.utils.filename import change_file_path, change_file_suffix

# data_format stage ordering (srec.h: dfWaveform < dfParams < dfPosteriors
# < dfStrings)
STAGES = ("wf", "par", "post", "str")


def _stage_index(name: str) -> int:
    if name not in STAGES:
        raise ValueError(
            f"Invalid data format {name!r}. Supported data formats are "
            "'wf', 'par', 'post' and 'str'.")
    return STAGES.index(name)


@dataclass
class DecodeResult:
    labels: List[Label]

    def rec_lines(self, mlf_style: bool = False) -> List[str]:
        return [format_rec_line(l, mlf_style) for l in self.labels]


class SpeechRec:
    """Loads a model package and processes files/lists at any stage pair."""

    def __init__(self, config_dir: str, fast_exp: bool = True,
                 log_fn=None):
        self.config_dir = config_dir
        self.cfg = cfg = PhnRecConfig.load_package(config_dir)
        self.log_fn = log_fn or (lambda msg: None)

        # -- frontend (srec.cpp:545-590)
        kind = cfg.get_str("params", "kind")
        if kind not in ("fbanks",):
            if kind == "plp":
                from phnrec_tpu.frontend.plp import PLPFrontend
                self.frontend = PLPFrontend(melbanks.spec_from_config(cfg), cfg)
            else:
                raise ValueError(f"unknown params/kind {kind!r}")
        else:
            self.frontend = melbanks.MelFrontend(melbanks.spec_from_config(cfg))
        self.wave_format = cfg.get_str("source", "format")
        if self.wave_format not in ("lin16", "alaw"):
            raise ValueError(
                f"Invalid waveform format {self.wave_format!r}. Supported "
                "data formats are 'lin16' and 'alaw'.")
        self.wave_scale = cfg.get_float("source", "scale")
        self.wave_dc_shift = cfg.get_float("source", "dc_shift")
        self.wave_noise = cfg.get_float("source", "noise_level")

        # -- normalization
        self.frame_shift = cfg.get_float("framenorm", "shift")
        self.frame_floor = cfg.get_float("framenorm", "min_floor")
        self.sent_norm = normalization.spec_from_config(cfg)

        # -- posterior estimator (srec.cpp:603-624)
        self.traps_enabled = cfg.get_bool("posteriors", "enabled")
        self.estimator = None
        if self.traps_enabled:
            self.estimator = build_estimator(
                cfg.get_str("posteriors", "system"),
                config_dir,
                nbanks=cfg.get_int("melbanks", "nbanks"),
                trap_len=cfg.get_int("posteriors", "length"),
                add_c0=cfg.get_bool("posteriors", "add_c0"),
                use_hamming=cfg.get_bool("posteriors", "hamming"),
                fast_exp=fast_exp,
            )

        # -- softening (srec.cpp:667-671)
        self.post_soft = softening.softening_fn(
            softening.parse_softening(
                cfg.get_str("posteriors", "softening_func")))
        self.dec_soft = softening.softening_fn(
            softening.parse_softening(cfg.get_str("decoder",
                                                  "softening_func")))

        # -- decoder (srec.cpp:627-665)
        self.decoder_type = cfg.get_str("decoder", "type")
        self.phonemes = load_phoneme_list(
            cfg.get_str("dicts", "phoneme_list"))
        self.wpenalty = cfg.get_float("decoder", "wpenalty")
        self.loop_spec = PhnLoopSpec(
            n_phonemes=len(self.phonemes),
            n_states=cfg.get_int("decoder", "num_states_per_phn"),
            w_penalty=self.wpenalty,
        )
        self.stk_decoder = None
        if self.decoder_type == "stkint":
            from phnrec_tpu.decoder.stknet import StkNetworkDecoder
            self.stk_decoder = StkNetworkDecoder.from_config(self, cfg)

    def set_wpenalty(self, wpenalty: float) -> None:
        """CLI -p override (phnrec.cpp:212-221)."""
        self.wpenalty = wpenalty
        self.loop_spec = self.loop_spec._replace(w_penalty=wpenalty)
        if self.stk_decoder is not None:
            self.stk_decoder.set_wpenalty(wpenalty)

    # ------------------------------------------------------------------
    # stage functions.  Per-utterance (serial) calls pad T up to a
    # 256-frame quantum so the jitted programs compile once per bucket
    # instead of once per distinct utterance length (a file list of 1024
    # unique lengths would otherwise re-lower 1024 times).
    # ------------------------------------------------------------------
    _frame_quantum = 256

    @partial(jax.jit, static_argnums=(0, 2))
    def _wave2par(self, wave_pad, t_pad: int):
        par = self.frontend(wave_pad, t_pad)
        return normalization.frame_norm(par, self.frame_shift,
                                        self.frame_floor)

    @partial(jax.jit, static_argnums=0)
    def _par2post(self, par_pad, n_valid):
        """[T_pad, nbanks] (rows >= n_valid replicate the last valid
        row) -> softened posteriors; sentence statistics mask padding."""
        sent = normalization.sentence_norm(par_pad, self.sent_norm,
                                           n_valid=n_valid)
        post = self.estimator.posteriors_batched(sent[None],
                                                 n_valid[None])
        return self.post_soft(post[0])

    @partial(jax.jit, static_argnums=0)
    def _post2segs(self, post_pad, n_valid):
        from phnrec_tpu.decoder import phnloop
        lp = self.dec_soft(post_pad)
        hist = phnloop.viterbi_scan_batch(self.loop_spec, lp[None])
        return phnloop.backtrack_device(self.loop_spec, hist,
                                        n_valid[None])

    def _pad_T(self, T: int) -> int:
        return -(-max(T, 1) // self._frame_quantum) * self._frame_quantum

    def params_from_waveform(self, raw: bytes) -> np.ndarray:
        """wf -> par: [T, nbanks] log mel (frame-normalized, NOT
        sentence-normalized — matching ProcessOffline, where sentence norm
        runs at the par->post boundary, srec.cpp:977-1000)."""
        from phnrec_tpu.utils.profiling import TIMER
        with TIMER.stage("wave_convert"):
            wave, _ = audio.convert_waveform(
                raw, self.wave_format, scale=self.wave_scale,
                dc_shift=self.wave_dc_shift, noise_level=self.wave_noise)
        T = self.frontend.frame_count(len(wave))
        spec = self.frontend.spec
        t_pad = self._pad_T(T)
        span = (t_pad - 1) * spec.step + spec.vector_size
        wave_pad = np.zeros(span, np.float32)
        wave_pad[: min(len(wave), span)] = wave[:span]
        with TIMER.stage("mel_frontend"):
            out = np.asarray(self._wave2par(jnp.asarray(wave_pad),
                                            t_pad))[:T]
        return out

    def posteriors_from_params(self, par: np.ndarray) -> np.ndarray:
        """par -> post, including sentence normalization and the
        posteriors-stage softening function."""
        if self.estimator is None:
            raise RuntimeError(
                "The 'traps' module have to be enabled for generating "
                "posteriors")
        n_p = self.frontend.n_params
        if par.shape[1] < n_p:
            raise ValueError("Invalid dimensionality of parameter vectors")
        par = np.asarray(par)[:, :n_p]  # truncate (srec.cpp:988-997)
        T = par.shape[0]
        t_pad = self._pad_T(T)
        par_pad = np.concatenate(
            [par, np.repeat(par[-1:], t_pad - T, axis=0)]) \
            if t_pad > T else par
        from phnrec_tpu.utils.profiling import TIMER
        with TIMER.stage("posteriors"):
            out = np.asarray(self._par2post(
                jnp.asarray(par_pad), jnp.int32(T)))[:T]
        return out

    def decode_posteriors(self, post: np.ndarray) -> DecodeResult:
        """post -> str via the decoder softening + Viterbi."""
        from phnrec_tpu.decoder import phnloop
        from phnrec_tpu.utils.profiling import TIMER
        with TIMER.stage("viterbi"):
            if self.stk_decoder is not None:
                # the network decoder buckets T internally (_run_scan)
                lp = self.dec_soft(jnp.asarray(post))
                return DecodeResult(self.stk_decoder.decode(lp))
            post = np.asarray(post)
            T = post.shape[0]
            t_pad = self._pad_T(T)
            post_pad = np.concatenate(
                [post, np.repeat(post[-1:], t_pad - T, axis=0)]) \
                if t_pad > T else post
            segs = self._post2segs(jnp.asarray(post_pad), jnp.int32(T))
        with TIMER.stage("backtrack"):
            # size the slice from T so long utterances never overflow
            # into a second (full-width) blocking refetch round trip
            cap = min(T // self.loop_spec.n_states + 1,
                      segs.phn.shape[1])
            segs = phnloop.fetch_segments(segs, cap=max(cap, 1))
            return DecodeResult(phnloop.labels_from_segments(
                segs, np.asarray([T]), self.phonemes)[0])

    # ------------------------------------------------------------------
    # staged file processing (ProcessFile, srec.cpp:1113-1199)
    # ------------------------------------------------------------------
    def process_offline(self, inpf: str, outpf: str, data):
        """Run stages inpf -> outpf; data is bytes (wf) or ndarray."""
        i, o = _stage_index(inpf), _stage_index(outpf)
        if i >= o:
            raise ValueError("output format must be later than input")
        if inpf == "wf":
            data = self.params_from_waveform(data)
            if outpf == "par":
                return data
        if o >= 2 and i <= 1:
            if not self.traps_enabled and outpf == "post":
                raise RuntimeError(
                    "The 'traps' module have to be enabled for generating "
                    "posteriors")
            if self.traps_enabled:
                data = self.posteriors_from_params(data)
            if outpf == "post":
                return data
        return self.decode_posteriors(data)

    def process_file(self, inpf: str, outpf: str, source: str,
                     target: Optional[str] = None,
                     mlf: Optional[MLFWriter] = None):
        self.log_fn(f"{source} -> {target}\n" if target else f"{source}\n")
        if inpf == "wf":
            data = audio.load_waveform_bytes(source)
        else:
            data, _, _ = htk.read_htk(source)
        result = self.process_offline(inpf, outpf, data)
        if outpf in ("par", "post"):
            if target is None:
                raise ValueError("par/post output requires a target file")
            htk.write_htk(target, result)
        else:
            if mlf is not None:
                mlf.add(target, result.labels)
            elif target is not None:
                with open(target, "w") as f:
                    for line in result.rec_lines():
                        f.write(line + "\n")
        return result

    def compose_target_name(self, source: str, outpf: str,
                            for_mlf: bool) -> str:
        """Target name from a one-column list line (srec.cpp:1216-1236).

        NOTE: for post targets the reference reads the unregistered
        "traps/suffix" entry and aborts (srec.cpp:1224, a latent bug);
        we use the registered posteriors/suffix instead.
        """
        cfg = self.cfg
        if outpf == "par":
            return change_file_suffix(source, cfg.get_str("params", "suffix"))
        if outpf == "post":
            return change_file_suffix(source,
                                      cfg.get_str("posteriors", "suffix"))
        if outpf == "str":
            name = change_file_suffix(source, cfg.get_str("labels", "suffix"))
            if for_mlf and cfg.get_bool("labels", "remove_path"):
                name = change_file_path(name, "*")
            return name
        raise ValueError(outpf)

    def process_file_list(self, inpf: str, outpf: str, list_path: str,
                          mlf_path: Optional[str] = None) -> None:
        entries = []
        with open(list_path) as f:
            for raw in f:
                parts = raw.split()
                if not parts:
                    continue
                source = parts[0]
                target = (parts[1] if len(parts) > 1 else
                          self.compose_target_name(
                              source, outpf, for_mlf=mlf_path is not None))
                entries.append((source, target))
        if self._can_batch_list(inpf, outpf):
            self._process_file_list_batched(entries, mlf_path)
            return
        mlf = MLFWriter(mlf_path) if mlf_path else None
        try:
            for source, target in entries:
                self.process_file(inpf, outpf, source, target, mlf)
        finally:
            if mlf:
                mlf.close()

    def _can_batch_list(self, inpf: str, outpf: str) -> bool:
        """The bucketed batch pipeline covers the production shapes: raw
        waveforms -> strings through the mel frontend + estimator, for
        BOTH decoders — phnloop (device Viterbi + backtrack) and stkint
        (batched posterior stack + NetworkDecoder.decode_batch /
        per-row KWS).  Everything else (par/post staged I/O, PLP,
        dithered sources) takes the serial per-file path, which buckets
        its jits to a frame quantum."""
        return (inpf == "wf" and outpf == "str"
                and self.traps_enabled and self.estimator is not None
                and type(self.frontend) is melbanks.MelFrontend
                and self.wave_noise == 0.0)

    def _process_file_list_batched(self, entries,
                                   mlf_path: Optional[str]) -> None:
        """File-list decode through PrefetchLoader buckets + the jitted
        batch pipeline — the device replacement for the reference's serial
        per-utterance loop (srec.cpp:1246-1291).  Batches are decoded
        with the device backtrack and results are written in LIST ORDER
        (the serial path's output order), overlapping each batch's D2H
        fetch with the next batch's compute."""
        from phnrec_tpu.decoder import phnloop
        from phnrec_tpu.parallel.batch import BatchPipeline
        from phnrec_tpu.parallel.loader import PrefetchLoader

        cfg = self.cfg
        bp = getattr(self, "_bp", None)
        if bp is None:
            bp = self._bp = BatchPipeline(self)
        raw_i16 = self.wave_format == "lin16"
        raw_alaw = self.wave_format == "alaw"
        freq = cfg.get_int("source", "sample_freq")
        loader = PrefetchLoader(
            [s for s, _ in entries], fmt=self.wave_format,
            scale=self.wave_scale, dc_shift=self.wave_dc_shift,
            noise_level=self.wave_noise, sample_freq=freq,
            max_batch=256, granularity=2 * freq, prefetch=3, n_workers=8,
            raw_int16=raw_i16, raw_alaw=raw_alaw)
        results: dict = {}

        def finish(p):
            batch, fetched, n_frames = p
            segs = phnloop.fetch_segments_finish(fetched)
            labels = phnloop.labels_from_segments(
                segs, n_frames, self.phonemes)
            for idx, labs in zip(batch.indices, labels):
                results[idx] = labs

        # keep two batches pending after each admission (a third is held
        # transiently between append and finish): each finish() blocks
        # the host on a D2H round trip whose latency would otherwise
        # serialize against the next batch's H2D — pending fetches ride
        # under later batches' transfers+compute
        inflight: list = []
        for batch in loader:
            self.log_fn("".join(
                f"{s} -> {t}\n" for s, t in
                (entries[i] for i in batch.indices)))
            n_frames = bp.frame_counts(batch.n_samples)
            max_frames = int(
                self.frontend.frame_count(batch.wave.shape[1]))
            ns = (jnp.asarray(batch.n_samples)
                  if batch.wave.dtype == np.uint8 else None)
            if self.stk_decoder is not None:
                # stkint lists: batched posterior stack + the batched
                # network decode (scan + device traceback per batch
                # instead of the serial per-file loop, srec.cpp:1246)
                lp = bp._post_core(jnp.asarray(batch.wave),
                                   jnp.asarray(n_frames), max_frames, ns)
                labels = self.stk_decoder.decode_batch(lp, n_frames)
                for idx, labs in zip(batch.indices, labels):
                    results[idx] = labs
                continue
            segs = bp._core(jnp.asarray(batch.wave),
                            jnp.asarray(n_frames), max_frames, ns)
            fetched = phnloop.fetch_segments_start(segs)
            inflight.append((batch, fetched, n_frames))
            if len(inflight) > 2:
                finish(inflight.pop(0))
        for p in inflight:
            finish(p)

        mlf = MLFWriter(mlf_path) if mlf_path else None
        try:
            for idx, (source, target) in enumerate(entries):
                labels = results[idx]
                if mlf is not None:
                    mlf.add(target, labels)
                elif target is not None:
                    with open(target, "w") as f:
                        for line in DecodeResult(labels).rec_lines():
                            f.write(line + "\n")
        finally:
            if mlf:
                mlf.close()
