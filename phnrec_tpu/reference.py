"""Plain float32 reference of the LCRC posterior stack: mel params ->
log phoneme-state posteriors, written straight from the reference's
semantics and sharing no code with the production assembly
(posteriors/stc.py's conv/einsum forms) or mlp.to_device's padding.

    sentence mean norm      srec.cpp:1492-1592 (offlinenorm/sent_mean_norm)
    31-frame context        clip-gather: row t sees frames t-15..t+15 with
                            both edges clamped (traps.cpp:186-199,
                            srec.cpp:1035-1059)
    LCRC window x DCT       left = context cols 0..15, right = cols 15..30,
                            each times its window file, then per bank
                            [C0, DCT_1..] (dspc.h:206-233), bank-major
                            (traps.cpp:285-344)
    band nets, ln, merger   nn.cpp:702-855 with the ICSI fast exp
                            (posteriors/fexp.py), sLn guard traps.cpp:459

Every GEMM runs under ``jax.default_matmul_precision("highest")``; place
the call on the CPU (``jax.default_device``) to get a CPU float32 answer.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu.config import PhnRecConfig
from phnrec_tpu.io.weights import MLPParams, load_nbin, load_window
from phnrec_tpu.posteriors import fexp


class ReferenceModel(NamedTuple):
    band0: MLPParams
    band1: MLPParams
    merger: MLPParams
    win_left: np.ndarray       # [half_context]
    win_right: np.ndarray      # [half_context]
    trap_len: int
    add_c0: bool
    sent_mean_norm: bool


def load_model(pkg_dir: str) -> ReferenceModel:
    """Read an LCRC package (``.nbin`` nets, window files, config)."""
    cfg = PhnRecConfig.load_package(pkg_dir)
    trap_len = cfg.get_int("posteriors", "length")
    hc = (trap_len - 1) // 2 + 1
    w = os.path.join(pkg_dir, "weights")
    return ReferenceModel(
        band0=load_nbin(os.path.join(w, "band0.nbin")),
        band1=load_nbin(os.path.join(w, "band1.nbin")),
        merger=load_nbin(os.path.join(w, "merger.nbin")),
        win_left=load_window(os.path.join(pkg_dir, "windows",
                                          "band0.window"), hc),
        win_right=load_window(os.path.join(pkg_dir, "windows",
                                           "band1.window"), hc),
        trap_len=trap_len,
        add_c0=cfg.get_bool("posteriors", "add_c0"),
        sent_mean_norm=cfg.get_bool("offlinenorm", "sent_mean_norm"))


def dct_basis(n: int, n_coefs: int, add_c0: bool) -> np.ndarray:
    """[n, n_coefs]: column 0 is C0 = sqrt(2/n) (with add_c0), then the
    sDCT bases sqrt(2/n) cos(pi/n k (j + 1/2)), k = 1, 2, ..."""
    out = np.zeros((n, n_coefs), np.float64)
    k0 = 0
    if add_c0:
        out[:, 0] = np.sqrt(2.0 / n)
        k0 = 1
    for c in range(k0, n_coefs):
        k = c - k0 + 1
        for j in range(n):
            out[j, c] = np.sqrt(2.0 / n) * np.cos(np.pi / n * k * (j + 0.5))
    return out


def lcrc_features(params: jnp.ndarray, model: ReferenceModel,
                  n_coefs: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[T, nb] params -> (left, right) band-net inputs [T, nb*n_coefs]."""
    T, nb = params.shape
    shift = (model.trap_len - 1) // 2
    hc = shift + 1
    idx = np.clip(np.arange(T)[:, None] + np.arange(model.trap_len)[None, :]
                  - shift, 0, T - 1)
    ctx = params[idx]                                   # [T, 31, nb]
    basis = jnp.asarray(dct_basis(hc, n_coefs, model.add_c0), jnp.float32)

    def side(cols, win):
        x = cols * jnp.asarray(win, jnp.float32)[None, :, None]
        feat = jnp.einsum("tjb,jk->tbk", x, basis)      # [T, nb, n_coefs]
        return feat.reshape(T, nb * n_coefs)

    return side(ctx[:, :hc], model.win_left), side(ctx[:, shift:],
                                                   model.win_right)


def mlp_posteriors(p: MLPParams, x: jnp.ndarray) -> jnp.ndarray:
    """(x - mean) * dev -> fast sigmoid hidden -> fast softmax output."""
    xn = (x - jnp.asarray(p.mean)) * jnp.asarray(p.dev)
    h = fexp.sigmoid(xn @ jnp.asarray(p.w1).T + jnp.asarray(p.b1))
    return fexp.softmax(h @ jnp.asarray(p.w2).T + jnp.asarray(p.b2))


def log_posteriors(model: ReferenceModel, params: jnp.ndarray) -> jnp.ndarray:
    """[T, nb] frame-normalized mel params of ONE utterance (no padding)
    -> [T, n_out] natural-log posteriors."""
    with jax.default_matmul_precision("highest"):
        params = jnp.asarray(params, jnp.float32)
        if model.sent_mean_norm:
            params = params - jnp.mean(params, axis=0, keepdims=True)
        n_coefs = model.band0.n_inp // params.shape[1]
        left, right = lcrc_features(params, model, n_coefs)
        m = jnp.concatenate([mlp_posteriors(model.band0, left),
                             mlp_posteriors(model.band1, right)], axis=-1)
        m = jnp.where(m > 0.0, jnp.log(jnp.maximum(m, 1e-37)), 0.0)
        return jnp.log(mlp_posteriors(model.merger, m))
