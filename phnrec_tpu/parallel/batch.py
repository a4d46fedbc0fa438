"""Batched, data-parallel wav->labels pipeline.

The reference processes utterances one at a time, frame by frame
(ProcessFileList loop, srec.cpp:1246-1291).  The replacement here
runs a whole batch of padded utterances through one jitted tensor program:

    wave [B, L] --frame/mel GEMMs--> params [B, T, D]
      --masked sentence norm--> --LCRC gather/GEMMs--> --MLP stack-->
    log-posteriors [B, T, PS] --vmapped Viterbi scan--> histories [B, T]

Per-utterance true lengths ride along as [B] integers: sentence statistics
mask padded frames, the STC context gather clips to the last VALID frame
(reproducing the reference's repeat-last-frame tail, srec.cpp:877-927), and
history rows beyond n_frames[b] are simply ignored at backtrack — the scan
itself needs no masking because padded steps cannot influence earlier
records.

Data parallelism: the batch axis is sharded over the mesh's 'data' axis
with jax.sharding; XLA partitions every stage without any collective
(decode state is per-utterance).  Throughput counters are psum-aggregated
in aggregate_metrics().
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu import normalization
from phnrec_tpu.decoder import phnloop
from phnrec_tpu.io.labels import Label
from phnrec_tpu.pipeline import SpeechRec


@dataclass
class BatchResult:
    labels: List[List[Label]]       # per utterance
    n_frames: np.ndarray            # [B]


class BatchPipeline:
    """Jitted batch runner built on a SpeechRec's loaded components."""

    def __init__(self, sr: SpeechRec, mesh: Optional[jax.sharding.Mesh] = None):
        if sr.estimator is None:
            raise ValueError("batch pipeline requires an enabled estimator")
        self.sr = sr
        self.mesh = mesh
        self._sharding = (
            jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("data"))
            if mesh is not None else None)

    # -- padding helpers -------------------------------------------------
    def pad_batch(self, waves: Sequence[np.ndarray]) -> Tuple[np.ndarray,
                                                              np.ndarray]:
        """Pad float waveforms to a common length (zeros).  Each waveform
        must already be >= MB_VECTORSIZE samples (io.audio pads)."""
        L = max(w.shape[0] for w in waves)
        fe = self.sr.frontend
        # round frame count up so every bucketed length maps to full frames
        out = np.zeros((len(waves), L), np.float32)
        n_samples = np.zeros(len(waves), np.int32)
        for i, w in enumerate(waves):
            out[i, : w.shape[0]] = w
            n_samples[i] = w.shape[0]
        return out, n_samples

    def frame_counts(self, n_samples: np.ndarray) -> np.ndarray:
        spec = self.sr.frontend.spec
        return np.where(
            n_samples <= spec.vector_size, 1,
            (n_samples - spec.vector_size) // spec.step + 1).astype(np.int32)

    # -- jitted core -----------------------------------------------------
    @partial(jax.jit, static_argnums=(0, 3))
    def _post_core(self, wave: jnp.ndarray, n_frames: jnp.ndarray,
                   max_frames: int,
                   n_samples: Optional[jnp.ndarray] = None):
        """[B, L] waves + [B] frame counts -> decoder-ready log
        posteriors [B, T, D] (wave convert + mel + norms + estimator +
        both softening stages) — the shared front of the phnloop batch
        decode and the batched stkint file-list path."""
        sr = self.sr
        fe = sr.frontend
        est = sr.estimator

        if wave.dtype == jnp.uint8:
            # device-side alaw decode (srec.cpp:769: 8*ALawTableD5[b]) —
            # raw codes cross the host->device link at ONE byte/sample, a
            # quarter of pre-converted f32; the 256-float table gather
            # reproduces the host floats exactly.  No alaw code decodes
            # to 0, so samples past each row's true length are zero-
            # masked to match the reference's float zero-pad
            # (srec.cpp:731-740).
            from phnrec_tpu.io.audio import ALAW_TABLE_D5
            table = jnp.asarray(8.0 * ALAW_TABLE_D5.astype(np.float32))
            wave = table[wave.astype(jnp.int32)]
            if n_samples is not None:
                wave = jnp.where(
                    jnp.arange(wave.shape[1])[None, :] < n_samples[:, None],
                    wave, 0.0)
            if sr.wave_dc_shift != 0.0:
                wave = wave + jnp.float32(sr.wave_dc_shift)
            if sr.wave_scale != 1.0:
                wave = wave * jnp.float32(sr.wave_scale)
        elif wave.dtype == jnp.int16:
            # device-side ConvertWaveformFormat (srec.cpp:709-791, lin16
            # path, no dither): cast, DC shift, scale.  Shipping int16
            # halves host->device bytes vs pre-converted f32.
            wave = wave.astype(jnp.float32)
            if sr.wave_dc_shift != 0.0:
                wave = wave + jnp.float32(sr.wave_dc_shift)
            if sr.wave_scale != 1.0:
                wave = wave * jnp.float32(sr.wave_scale)

        frames = jax.vmap(lambda w: fe.frames_from_wave(w, max_frames))(wave)
        par = fe.log_mel_from_frames(frames)
        par = normalization.frame_norm(par, sr.frame_shift, sr.frame_floor)

        par = jax.vmap(lambda p, n: normalization.sentence_norm(
            p, sr.sent_norm, n_valid=n))(par, n_frames)
        # posterior system dispatch (LCRC/3BT/1BT/1BT_DCT; LCRC runs the
        # conv-based STC assembly with no [T, 31, B] materialization)
        post = est.posteriors_batched(par, n_frames)

        post = sr.post_soft(post)
        return sr.dec_soft(post)

    @partial(jax.jit, static_argnums=(0, 3))
    def _core(self, wave: jnp.ndarray, n_frames: jnp.ndarray,
              max_frames: int, n_samples: Optional[jnp.ndarray] = None):
        """[B, L] waves + [B] frame counts -> compacted Segments (the full
        wav->mel->LCRC->MLPs->Viterbi->backtrack program on device)."""
        sr = self.sr
        lp = self._post_core(wave, n_frames, max_frames, n_samples)
        hist = phnloop.viterbi_scan_batch(sr.loop_spec, lp)
        # backtrack stays on device: only ~7 bytes/segment cross PCIe/host
        # instead of the 8 bytes/frame history (D2H dominates round trips)
        return phnloop.backtrack_device(sr.loop_spec, hist, n_frames)

    # -- public API ------------------------------------------------------
    def run_padded(self, wave: np.ndarray, n_samples: np.ndarray
                   ) -> BatchResult:
        n_frames = self.frame_counts(n_samples)
        max_frames = int(
            self.sr.frontend.frame_count(wave.shape[1]))
        w = jnp.asarray(wave)
        nf = jnp.asarray(n_frames)
        ns = jnp.asarray(n_samples) if wave.dtype == np.uint8 else None
        if self._sharding is not None:
            w = jax.device_put(w, self._sharding)
            nf = jax.device_put(nf, self._sharding)
            if ns is not None:
                ns = jax.device_put(ns, self._sharding)
        segs = self._core(w, nf, max_frames, ns)
        segs = phnloop.fetch_segments(segs)
        labels = phnloop.labels_from_segments(
            segs, n_frames, self.sr.phonemes)
        return BatchResult(labels=labels, n_frames=n_frames)

    def run(self, waves: Sequence[np.ndarray]) -> BatchResult:
        wave, n_samples = self.pad_batch(waves)
        return self.run_padded(wave, n_samples)


def aggregate_metrics(metrics: dict, mesh: jax.sharding.Mesh) -> dict:
    """psum per-host counters (audio seconds, frames, edits) over the mesh."""
    from jax.experimental import multihost_utils
    arr = jnp.asarray([float(v) for v in metrics.values()])
    total = multihost_utils.process_allgather(arr).sum(axis=0)
    return {k: float(total[i]) for i, k in enumerate(metrics)}
