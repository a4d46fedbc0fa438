"""Per-stage timing and XLA trace capture.

The reference has no profiling machinery at all — only compile-time debug
printf paths (SURVEY.md section 5).  This is the from-scratch observability
layer for this build:

* ``StageTimer``: named wall-clock accumulators around pipeline stages
  (mel, stc, mlp, viterbi, backtrack, io), with correct handling of JAX's
  async dispatch (``block=True`` calls block_until_ready on exit so device
  time lands in the right bucket).
* ``trace()``: context manager around ``jax.profiler`` — captures an XLA
  trace viewable in TensorBoard/Perfetto when a directory is given, no-op
  otherwise, so call sites can leave it in production code.
* ``annotate()``: named TraceAnnotation region that shows up inside the
  captured trace (thin wrapper, safe without an active capture).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0


@dataclass
class StageTimer:
    stats: Dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats))
    enabled: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, block: object = None) -> Iterator[None]:
        """Time a stage.  Pass the stage's output (any JAX pytree) as
        ``block`` to block_until_ready before stopping the clock."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                try:
                    import jax
                    jax.block_until_ready(block)
                except Exception:
                    pass
            s = self.stats[name]
            s.calls += 1
            s.seconds += time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(s.seconds for s in self.stats.values()) or 1.0
        rows = sorted(self.stats.items(), key=lambda kv: -kv[1].seconds)
        lines = [f"{'stage':<16} {'calls':>6} {'seconds':>10} {'%':>6}"]
        for name, s in rows:
            lines.append(f"{name:<16} {s.calls:>6} {s.seconds:>10.4f} "
                         f"{100.0 * s.seconds / total:>5.1f}%")
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()


# module-level default timer; pipelines use this unless given their own
TIMER = StageTimer(enabled=False)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture an XLA profiler trace into log_dir (None => no-op)."""
    if not log_dir:
        yield
        return
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active profiler trace (no-op otherwise)."""
    try:
        import jax
        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:
        yield
