"""Global matmul-precision knob for the numeric pipeline.

The reference does all arithmetic in CPU float32 (STK FLOAT with
DOUBLEPRECISION=0, STKLib/common.h:92-103).  What each mode computes on
the NVIDIA H100 (measured by chip_smoke.py's device phase: largest error
of a [512, 1024] x [1024, 512] float32 GEMM against float64, relative to
the result's largest entry):

  * ``"highest"`` (default) — full float32 GEMMs (5.4e-7, the float32
    level).  The parity mode: posteriors match the plain CPU reference
    (reference.py) and labels equal the CPU run's.
  * ``"high"`` — TF32 tensor-core GEMMs (10-bit mantissa inputs, float32
    accumulation; 2.5e-4).  A throughput mode, not a parity guarantee.
  * ``"default"`` — the same TF32 GEMMs as ``"high"`` on this card.

On the CPU all three compute full float32.

Set once before building pipelines (compiled programs bake the setting in
at trace time):

    from phnrec_tpu import precision
    precision.set_mode("high")

or via the PHNREC_TPU_PRECISION environment variable.
"""

from __future__ import annotations

import os

import jax

_MODES = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}

_mode = os.environ.get("PHNREC_TPU_PRECISION", "highest").lower()
if _mode not in _MODES:
    _mode = "highest"


def set_mode(mode: str) -> None:
    global _mode
    if mode not in _MODES:
        raise ValueError(f"precision mode must be one of {sorted(_MODES)}")
    _mode = mode


def get_mode() -> str:
    return _mode


def get() -> jax.lax.Precision:
    """The jax.lax.Precision for every GEMM in the pipeline."""
    return _MODES[_mode]
