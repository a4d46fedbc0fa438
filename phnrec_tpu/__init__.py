"""phnrec_tpu — a phoneme recognition framework in JAX.

A from-scratch JAX/XLA re-design of the BUT PhnRec phoneme recognizer
(reference: the C++ PhnRec sources). The numeric pipeline

    waveform -> log mel-filterbank energies -> split-temporal-context (LCRC)
    feature assembly -> band MLPs + merger MLP -> per-frame phoneme-state
    posteriors -> phoneme-loop Viterbi -> time-stamped phoneme labels

is implemented as pure functions over [B, T, ...] tensors compiled with jit,
batched across utterances, and sharded data-parallel over a device mesh.
Model packages (config + dicts + weights + windows) in the reference's
format load unchanged; synth.py writes one from a seed.

Layer map (mirrors SURVEY.md section 1):
  config.py              typed INI config        (ref configz.{cpp,h}, srec.cpp:34-110)
  io/                    HTK/label/weights I/O   (ref matrix.h, nn.cpp, traps.cpp)
  frontend/              mel-bank + PLP frontend (ref melbanks.cpp, dspc.cpp, plp.cpp)
  posteriors/            STC assembly + MLPs     (ref traps.cpp, nn.cpp, fexp.h)
  decoder/               Viterbi decoders        (ref phndec.cpp, stkinterface.cpp)
  pipeline.py            orchestration           (ref srec.cpp)
  parallel/              mesh/data-parallel runs (new; no reference analogue)
  cli.py                 phnrec CLI              (ref phnrec.cpp)
  synth.py, reference.py seeded model package + plain float32 reference
"""

__version__ = "0.2.0"

import os as _os

import jax as _jax

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache`` at the
    root of the checkout (a fixed path, so later processes hit it)."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_REPO_ROOT, ".jax_cache"))


# Persistent XLA compilation cache: the first jit of the pipeline takes
# tens of seconds; every later process reuses the compiled binaries.  The
# reference has the same idea at a smaller scale — the .nbin weight cache
# written beside ASCII weights (nn.cpp:533-592).  Opt out with
# PHNREC_TPU_NO_COMPILE_CACHE=1.
if not _os.environ.get("PHNREC_TPU_NO_COMPILE_CACHE"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from phnrec_tpu.config import PhnRecConfig
from phnrec_tpu.pipeline import SpeechRec

__all__ = ["PhnRecConfig", "SpeechRec", "__version__"]
