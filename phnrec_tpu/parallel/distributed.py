"""Multi-host data-parallel batch decoding.

The reference processes file lists serially in one process
(ProcessFileList, srec.cpp:1246-1291).  Scale-out design (no reference
analogue — SURVEY.md section 2.3): each host process takes a strided
slice of the .scp list by `jax.process_index()`, buckets utterances by
padded frame count, runs the jitted batch pipeline over its local chips
(batch axis sharded over a 'data' mesh of local or global devices), and
aggregates throughput/accuracy counters across hosts with a psum-style
all-gather.  A progress manifest makes long runs resumable (the
checkpoint/resume story for inference: each utterance is independent, so
resume = skip completed entries; SURVEY.md section 5).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from phnrec_tpu.io import audio
from phnrec_tpu.io.labels import Label, MLFWriter
from phnrec_tpu.parallel.batch import BatchPipeline
from phnrec_tpu.pipeline import SpeechRec


def shard_list(entries: Sequence[str], process_index: int,
               process_count: int) -> List[str]:
    """Strided host shard: process i handles entries i, i+P, i+2P, ..."""
    return list(entries[process_index::process_count])


def bucket_by_frames(lengths: Sequence[int], max_batch: int = 64,
                     granularity: int = 512) -> List[List[int]]:
    """Group utterance indices into batches whose padded frame counts
    share a bucket (rounded up to `granularity` samples) so only a few
    shapes ever compile."""
    buckets: Dict[int, List[int]] = {}
    for i, n in enumerate(lengths):
        b = -(-max(n, 1) // granularity) * granularity
        buckets.setdefault(b, []).append(i)
    batches = []
    for b in sorted(buckets):
        idxs = buckets[b]
        for k in range(0, len(idxs), max_batch):
            batches.append(idxs[k : k + max_batch])
    return batches


@dataclass
class Progress:
    """Resumable progress manifest: one JSON line per completed utterance."""

    path: Optional[str]
    done: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def open(cls, path: Optional[str]) -> "Progress":
        p = cls(path)
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        p.done[rec["source"]] = rec.get("n_labels", 0)
                    except (json.JSONDecodeError, KeyError):
                        continue
        return p

    def mark(self, source: str, n_labels: int) -> None:
        self.done[source] = n_labels
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"source": source,
                                    "n_labels": n_labels}) + "\n")


@dataclass
class RunMetrics:
    audio_seconds: float = 0.0
    n_frames: int = 0
    n_utterances: int = 0
    n_labels: int = 0
    wall_seconds: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        d = {k: float(v) for k, v in self.__dict__.items()}
        d["audio_sec_per_s"] = (self.audio_seconds / self.wall_seconds
                                if self.wall_seconds else 0.0)
        return d


def aggregate_across_hosts(metrics: RunMetrics) -> Dict[str, float]:
    """Sum counters over all host processes (an all-gather across
    processes); on a
    single process this is the identity."""
    import jax

    vals = np.asarray([metrics.audio_seconds, metrics.n_frames,
                       metrics.n_utterances, metrics.n_labels,
                       metrics.wall_seconds], np.float32)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        gathered = multihost_utils.process_allgather(vals)
        vals = np.asarray(gathered).sum(axis=0)
    total = RunMetrics(*[float(v) for v in vals])
    # throughput uses the max wall clock, not the sum
    if jax.process_count() > 1:
        total.wall_seconds = metrics.wall_seconds
    return total.as_dict()


class DistributedRunner:
    """Run a file list wf->str across hosts and local devices."""

    def __init__(self, sr: SpeechRec, mesh=None, max_batch: int = 64,
                 progress_file: Optional[str] = None):
        self.sr = sr
        self.bp = BatchPipeline(sr, mesh=mesh)
        self.max_batch = max_batch
        self.progress = Progress.open(progress_file)

    def run(self, list_path: str, mlf_path: Optional[str] = None,
            out_dir: Optional[str] = None) -> Dict[str, float]:
        import jax

        with open(list_path) as f:
            entries = [line.split()[0] for line in f if line.strip()]
        local = shard_list(entries, jax.process_index(),
                           jax.process_count())
        local = [e for e in local if e not in self.progress.done]

        sample_freq = self.sr.cfg.get_int("source", "sample_freq")
        metrics = RunMetrics()
        t0 = time.perf_counter()

        # prefetching loader: disk reads + native waveform decode run in
        # worker threads, overlapped with the device step (loader.py)
        from phnrec_tpu.parallel.loader import PrefetchLoader
        loader = PrefetchLoader(
            local, fmt=self.sr.wave_format, scale=self.sr.wave_scale,
            dc_shift=self.sr.wave_dc_shift,
            noise_level=self.sr.wave_noise, sample_freq=sample_freq,
            max_batch=self.max_batch)

        mlf = MLFWriter(mlf_path) if mlf_path and \
            jax.process_index() == 0 else None
        results: Dict[str, List[Label]] = {}
        for batch in loader:
            res = self.bp.run_padded(batch.wave, batch.n_samples)
            metrics.audio_seconds += batch.audio_seconds
            for bi, i in enumerate(batch.indices):
                labels = res.labels[bi]
                results[local[i]] = labels
                metrics.n_frames += int(res.n_frames[bi])
                metrics.n_labels += len(labels)
                metrics.n_utterances += 1
                self.progress.mark(local[i], len(labels))
                target = self.sr.compose_target_name(
                    local[i], "str", for_mlf=mlf is not None)
                if mlf is not None:
                    mlf.add(target, labels)
                elif out_dir is not None:
                    out = os.path.join(out_dir,
                                       os.path.basename(target))
                    with open(out, "w") as f:
                        from phnrec_tpu.io.labels import format_rec_line
                        for lab in labels:
                            f.write(format_rec_line(lab) + "\n")
        if mlf is not None:
            mlf.close()
        metrics.wall_seconds = time.perf_counter() - t0
        return aggregate_across_hosts(metrics)
