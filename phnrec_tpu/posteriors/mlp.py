"""2-layer MLP forward pass (input -> sigmoid hidden -> softmax output).

Reference: NeuralNet::ForwardPass1Bunch (nn.cpp:872-899): fold-in input
normalization ``(x - mean) * dev`` (nn.cpp:702-716), two GEMMs against
transposed weight matrices with biases pre-added (nn.cpp:721-794), fast
sigmoid/softmax (nn.cpp:796-855 under NN_FAST_EXP).

Here the whole bunch machinery disappears — one [T, n_inp] tensor goes
through two GEMMs for arbitrary T.  Weights are zero-padded to multiples
of 8 on every axis (zero rows/cols, which do not change results).  The
GEMM precision is the process-wide mode of precision.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from phnrec_tpu.io.weights import MLPParams
from phnrec_tpu.posteriors import fexp
from phnrec_tpu import precision


def _pad_to(x: np.ndarray, rows: int, cols: int | None = None) -> np.ndarray:
    if x.ndim == 1:
        out = np.zeros(rows, np.float32)
        out[: x.shape[0]] = x
        return out
    out = np.zeros((rows, cols), np.float32)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def _round_up(n: int, m: int = 8) -> int:
    return (n + m - 1) // m * m


class MLPDevice(NamedTuple):
    """Device-resident padded parameters of one MLP.

    w1: [n_inp, H]  (already transposed + norm-folded: see fold_norms)
    """

    w1: jnp.ndarray      # [n_inp_pad, hid_pad]
    b1: jnp.ndarray      # [hid_pad]
    w2: jnp.ndarray      # [hid_pad, out_pad]
    b2: jnp.ndarray      # [out_pad]
    mean: jnp.ndarray    # [n_inp_pad]
    dev: jnp.ndarray     # [n_inp_pad]
    n_inp: int
    n_hid: int
    n_out: int


def to_device(p: MLPParams) -> MLPDevice:
    """Pad + transpose parameters for the device forward pass.

    Padding with zeros is exact: extra input columns are multiplied by
    dev=0 on zero data, extra hidden units get sigmoid(0)=0.5 but their
    outgoing weights are 0, extra output columns are sliced off before
    softmax.
    """
    i_p, h_p, o_p = (_round_up(p.n_inp), _round_up(p.n_hid),
                     _round_up(p.n_out))
    return MLPDevice(
        w1=jnp.asarray(_pad_to(p.w1.T.astype(np.float32), i_p, h_p)),
        b1=jnp.asarray(_pad_to(p.b1, h_p)),
        w2=jnp.asarray(_pad_to(p.w2.T.astype(np.float32), h_p, o_p)),
        b2=jnp.asarray(_pad_to(p.b2, o_p)),
        mean=jnp.asarray(_pad_to(p.mean, i_p)),
        dev=jnp.asarray(_pad_to(p.dev, i_p)),
        n_inp=p.n_inp,
        n_hid=p.n_hid,
        n_out=p.n_out,
    )


def forward(net: MLPDevice, x: jnp.ndarray, fast: bool = True,
            apply_softmax: bool = True) -> jnp.ndarray:
    """[..., n_inp or n_inp_pad] -> [..., n_out] posteriors.

    Hidden-layer zero-padding note: the reference zeroes padded sigmoid
    slots (nn.cpp:813-818); here padded w1 columns give pre-act b1=0 ->
    sigmoid 0.5, but padded w2 rows are zero so the contribution is 0
    either way.
    """
    n_inp_pad = net.w1.shape[0]
    if x.shape[-1] != n_inp_pad:
        pad = n_inp_pad - x.shape[-1]
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    xn = (x - net.mean) * net.dev
    h = fexp.sigmoid(jnp.dot(xn, net.w1, precision=precision.get()) + net.b1, fast)
    o = jnp.dot(h, net.w2, precision=precision.get()) + net.b2
    o = o[..., : net.n_out]
    if apply_softmax:
        o = fexp.softmax(o, fast)
    return o
