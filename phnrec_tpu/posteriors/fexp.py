"""ICSI fast-exp emulation (deterministic), exact sigmoid/softmax alternatives.

The reference's shipped builds enable NN_FAST_EXP (makefile_phnrec.lin:10):
hidden sigmoids and output softmaxes use the ICSI bit-trick exponential
(fexp.h:14-21) for bit-compatibility with Quicknet-trained nets.  The trick
writes ``(int)(2^20/ln2 * y) + (1072693248 - 60801)`` into the HIGH word of a
double and reads the double back; the low word is an uninitialized stack
value (up to 2^-20 relative noise in the reference itself — two oracle
builds differ by ~3e-6 in final posteriors).

Device equivalent: decode the constructed double analytically with the
low word = 0,

    i = trunc(A*y) + K;  E = i >> 20;  M = i & 0xFFFFF
    fexp(y) = 2^(E-1023) * (1 + M * 2^-20)

which is exact float32 arithmetic (M has 20 bits < f32's 24-bit mantissa)
and pure elementwise work.  ``fast=False`` paths use the hardware exp instead —
preferable when bit-parity with reference binaries is not needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_LN2 = 0.69314718055994530942
FEXP_A = 1048576 / _LN2            # fexp.h:14
FEXP_K = 1072693248 - 60801        # fexp.h:15,20


def fexp(y: jnp.ndarray) -> jnp.ndarray:
    """Deterministic ICSI fast exp (low word = 0)."""
    # C's (int) cast truncates toward zero, as does astype(int32).
    t = (FEXP_A * y.astype(jnp.float32)).astype(jnp.int32) + FEXP_K
    e = (t >> 20) - 1023
    m = (t & 0xFFFFF).astype(jnp.float32) * (1.0 / 1048576.0)
    # For arguments driving t negative the reference reads a negative double
    # (sign bit set); that needs |y| > ~665, far outside NN pre-activations.
    # exp2 of the huge negative exponent flushes to 0 here instead.
    return jnp.exp2(e.astype(jnp.float32)) * (1.0 + m)


def sigmoid(x: jnp.ndarray, fast: bool = True) -> jnp.ndarray:
    """1 / (1 + exp(-x)); fast variant matches fexp_sigmoid (fexp.h:33-38)."""
    if fast:
        return 1.0 / (1.0 + fexp(-x))
    return jax.nn.sigmoid(x)


def softmax(x: jnp.ndarray, fast: bool = True) -> jnp.ndarray:
    """Max-subtracted softmax along the last axis (fexp.h:49-78)."""
    shifted = x - jnp.max(x, axis=-1, keepdims=True)
    e = fexp(shifted) if fast else jnp.exp(shifted)
    return e / jnp.sum(e, axis=-1, keepdims=True)


def fexp_reference_np(y: np.ndarray) -> np.ndarray:
    """NumPy oracle for fexp with low word 0 (testing only): builds the
    actual double the C macro constructs."""
    y = np.atleast_1d(np.asarray(y, dtype=np.float64))
    i = (FEXP_A * y).astype(np.int64).astype(np.int32) + FEXP_K
    bits = (i.astype(np.int64) & 0xFFFFFFFF) << 32
    return bits.view(np.float64)
