"""Posterior estimators: the four Traps systems (traps.cpp:572-586).

The device equivalent of Traps (traps.cpp): mel params [T, nbanks] ->
phoneme-state posteriors [T, n_out] as one jitted tensor program.

  * LCRC (the shipped system, LCRCEstimator):
        L, R   = LCRC assembly (stc.py)                  2 small GEMMs
        lo, ro = band MLPs (mlp.py)                      4 GEMMs
        m      = ln(concat(lo, ro))  (traps.cpp:435-461, sLn dspc.h:155-160)
        post   = merger MLP                              2 GEMMs
  * 3BT / 1BT (TrapsEstimator): one temporal-trap net per mel band
    (3BT skips the top two bands, traps.cpp:97-99); each net consumes the
    band's trap_len-frame trajectory, optionally Hamming-windowed
    (traps.cpp:227-240,246-258); merger input is the band-major concat of
    the band-net outputs through MINUS-ln (traps.cpp:420-427 — the negate
    is specific to these systems).
  * 1BT_DCT (DCTEstimator): no band nets — per band the (optionally
    Hamming-windowed) trajectory reduces to [C0?, DCT_1..] straight into
    the merger, with NO ln (traps.cpp:260-281,429-431).

Model-package file naming follows the reference conventions (config.h:30-39):
<dir>/weights/band{i}.weights(.nbin), <dir>/norms/band{i}.norms,
<dir>/windows/band{i}.window (LCRC only), <dir>/weights/merger.weights.
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu import precision
from phnrec_tpu.io.weights import load_net, load_window
from phnrec_tpu.posteriors import fexp, mlp
from phnrec_tpu.posteriors.stc import (LCRCAssembler, LCRCSpec,
                                       clamped_context, dct_c0_matrix)


class LCRCEstimator:
    """Loads one model package's nets and exposes a jitted forward."""

    def __init__(self, model_dir: str, nbanks: int, trap_len: int = 31,
                 add_c0: bool = True, fast_exp: bool = True):
        w = os.path.join(model_dir, "weights")
        n = os.path.join(model_dir, "norms")
        win = os.path.join(model_dir, "windows")
        half_context = (trap_len - 1) // 2 + 1

        self.band = [
            mlp.to_device(load_net(os.path.join(w, f"band{i}.weights"),
                                   os.path.join(n, f"band{i}.norms")))
            for i in range(2)
        ]
        self.merger = mlp.to_device(
            load_net(os.path.join(w, "merger.weights"),
                     os.path.join(n, "merger.norms")))

        if self.band[0].n_inp % nbanks != 0:
            raise ValueError(
                f"band net input {self.band[0].n_inp} not divisible by "
                f"nbanks {nbanks}")
        n_coefs = self.band[0].n_inp // nbanks
        spec = LCRCSpec(nbanks=nbanks, trap_len=trap_len, n_coefs=n_coefs,
                        add_c0=add_c0)
        self.assembler = LCRCAssembler(
            spec,
            load_window(os.path.join(win, "band0.window"), half_context),
            load_window(os.path.join(win, "band1.window"), half_context),
        )
        self.fast_exp = fast_exp
        self.trap_shift = (trap_len - 1) // 2
        self.n_outs = self.merger.n_out

    @partial(jax.jit, static_argnums=0)
    def posteriors(self, params: jnp.ndarray) -> jnp.ndarray:
        """[T, nbanks] normalized mel params -> [T, n_out] posteriors."""
        left, right = self.assembler(params)
        lo = mlp.forward(self.band[0], left, self.fast_exp)
        ro = mlp.forward(self.band[1], right, self.fast_exp)
        m = jnp.concatenate([lo, ro], axis=-1)
        # sLn guard: ln(x) for x > 0 else 0 (traps.cpp:459, dspc.h:155-160)
        m = jnp.where(m > 0.0, jnp.log(jnp.maximum(m, 1e-37)), 0.0)
        return mlp.forward(self.merger, m, self.fast_exp)

    def posteriors_batched(self, params: jnp.ndarray,
                           n_frames: jnp.ndarray) -> jnp.ndarray:
        """[B, T, nbanks] (+ per-row valid counts) -> [B, T, n_out].
        Conv-based STC assembly — no [T, 31, B] context materialization,
        clamped to the last VALID frame of each padded row."""
        left, right = self.assembler.batched(params, n_frames)
        lo = mlp.forward(self.band[0], left, self.fast_exp)
        ro = mlp.forward(self.band[1], right, self.fast_exp)
        m = jnp.concatenate([lo, ro], axis=-1)
        m = jnp.where(m > 0.0, jnp.log(jnp.maximum(m, 1e-37)), 0.0)
        return mlp.forward(self.merger, m, self.fast_exp)


def hamming_window(n: int) -> np.ndarray:
    """0.54 - 0.46 cos(2 pi i / (n-1)) (sWindow_Hamming, dspc.h:162-167)."""
    i = np.arange(n, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))).astype(
        np.float32)


class _BandStack(NamedTuple):
    """trap_bands identically-shaped MLPs stacked on a leading axis."""

    w1: jnp.ndarray    # [NB, i_pad, h_pad]
    b1: jnp.ndarray    # [NB, h_pad]
    w2: jnp.ndarray    # [NB, h_pad, o_pad]
    b2: jnp.ndarray    # [NB, o_pad]
    mean: jnp.ndarray  # [NB, i_pad]
    dev: jnp.ndarray   # [NB, i_pad]
    n_out: int


class TrapsEstimator:
    """3BT / 1BT: per-band temporal-trap nets (traps.cpp:246-258).

    Each band net's input size must equal trap_len — the reference copies
    exactly trap_len floats per frame at stride trap_len into the net's
    bunch input (traps.cpp:252-257), which is only self-consistent at
    that size.  3BT drops the top two bands (trap_bands = nbanks - 2,
    traps.cpp:97-99)."""

    def __init__(self, model_dir: str, nbanks: int, system: str = "1BT",
                 trap_len: int = 31, use_hamming: bool = True,
                 fast_exp: bool = True, band_nets=None, merger=None):
        if system not in ("3BT", "1BT"):
            raise ValueError(f"TrapsEstimator does not cover {system!r}")
        self.trap_bands = nbanks - 2 if system == "3BT" else nbanks
        self.trap_len = trap_len
        if band_nets is None:
            w = os.path.join(model_dir, "weights")
            n = os.path.join(model_dir, "norms")
            band_nets = [
                load_net(os.path.join(w, f"band{i}.weights"),
                         os.path.join(n, f"band{i}.norms"))
                for i in range(self.trap_bands)
            ]
        devs = [mlp.to_device(p) for p in band_nets]
        if any(d.n_inp != trap_len for d in devs):
            raise ValueError("band-net input size must equal trap length "
                             f"({trap_len}) for {system}")
        if len({(d.n_inp, d.n_hid, d.n_out) for d in devs}) != 1:
            raise ValueError("band nets must share one topology to stack")
        self.bands = _BandStack(
            *(jnp.stack([getattr(d, f) for d in devs])
              for f in ("w1", "b1", "w2", "b2", "mean", "dev")),
            n_out=devs[0].n_out)
        if merger is None:
            merger = load_net(
                os.path.join(model_dir, "weights", "merger.weights"),
                os.path.join(model_dir, "norms", "merger.norms"))
        self.merger = mlp.to_device(merger)
        if self.merger.n_inp != self.trap_bands * devs[0].n_out:
            raise ValueError(
                f"merger input {self.merger.n_inp} != trap_bands "
                f"{self.trap_bands} x band outputs {devs[0].n_out}")
        self.window = jnp.asarray(
            hamming_window(trap_len) if use_hamming
            else np.ones(trap_len, np.float32))
        self.fast_exp = fast_exp
        self.trap_shift = (trap_len - 1) // 2
        self.n_outs = self.merger.n_out

    def _merger_input(self, ctx: jnp.ndarray) -> jnp.ndarray:
        """[T, trap_len, nbanks] context -> [T, NB*band_out] merger input."""
        nb = self.trap_bands
        # [NB, T, trap_len] windowed per-band trajectories
        x = jnp.transpose(ctx[:, :, :nb], (2, 0, 1)) * self.window[None, None]
        i_pad = self.bands.w1.shape[1]
        x = jnp.pad(x, ((0, 0), (0, 0), (0, i_pad - x.shape[-1])))
        p = precision.get()
        xn = (x - self.bands.mean[:, None, :]) * self.bands.dev[:, None, :]
        h = fexp.sigmoid(
            jnp.einsum("nti,nih->nth", xn, self.bands.w1, precision=p)
            + self.bands.b1[:, None, :], self.fast_exp)
        o = jnp.einsum("nth,nho->nto", h, self.bands.w2, precision=p) \
            + self.bands.b2[:, None, :]
        o = fexp.softmax(o[..., : self.bands.n_out], self.fast_exp)
        # band-major concat per frame (traps.cpp:420-425), then MINUS ln
        # (sLn guard + x(-1), traps.cpp:426-427)
        m = jnp.transpose(o, (1, 0, 2)).reshape(o.shape[1], -1)
        return -jnp.where(m > 0.0, jnp.log(jnp.maximum(m, 1e-37)), 0.0)

    @partial(jax.jit, static_argnums=0)
    def posteriors(self, params: jnp.ndarray) -> jnp.ndarray:
        ctx = clamped_context(params, self.trap_len)
        return mlp.forward(self.merger, self._merger_input(ctx),
                           self.fast_exp)

    def posteriors_batched(self, params: jnp.ndarray,
                           n_frames: jnp.ndarray) -> jnp.ndarray:
        def one(p, n):
            ctx = clamped_context(p, self.trap_len, n_valid=n)
            return mlp.forward(self.merger, self._merger_input(ctx),
                               self.fast_exp)
        return jax.vmap(one)(params, n_frames)


class DCTEstimator:
    """1BT_DCT: per-band [C0?, DCT] of the (optionally Hamming-windowed)
    trajectory feeds the merger directly (traps.cpp:260-281); there are
    no band nets and no ln."""

    def __init__(self, model_dir: str, nbanks: int, trap_len: int = 31,
                 add_c0: bool = False, use_hamming: bool = True,
                 fast_exp: bool = True, merger=None):
        if merger is None:
            merger = load_net(
                os.path.join(model_dir, "weights", "merger.weights"),
                os.path.join(model_dir, "norms", "merger.norms"))
        self.merger = mlp.to_device(merger)
        if self.merger.n_inp % nbanks != 0:
            raise ValueError(
                f"merger input {self.merger.n_inp} not divisible by "
                f"nbanks {nbanks}")
        n_coefs = self.merger.n_inp // nbanks   # merger_input_shift
        self.trap_len = trap_len
        win = (hamming_window(trap_len) if use_hamming
               else np.ones(trap_len, np.float32))
        # window folded into the DCT/C0 reduction: one [trap_len, n_coefs]
        # matrix per band (same for every band)
        self.m_dct = jnp.asarray(
            win[:, None] * dct_c0_matrix(trap_len, n_coefs, add_c0),
            dtype=jnp.float32)
        self.fast_exp = fast_exp
        self.trap_shift = (trap_len - 1) // 2
        self.n_outs = self.merger.n_out

    def _merger_input(self, ctx: jnp.ndarray) -> jnp.ndarray:
        # [T, trap_len, nbanks] -> [T, nbanks, n_coefs] -> bank-major flat
        feat = jnp.einsum("tjb,jc->tbc", ctx, self.m_dct,
                          precision=precision.get())
        return feat.reshape(feat.shape[0], -1)

    @partial(jax.jit, static_argnums=0)
    def posteriors(self, params: jnp.ndarray) -> jnp.ndarray:
        ctx = clamped_context(params, self.trap_len)
        return mlp.forward(self.merger, self._merger_input(ctx),
                           self.fast_exp)

    def posteriors_batched(self, params: jnp.ndarray,
                           n_frames: jnp.ndarray) -> jnp.ndarray:
        def one(p, n):
            ctx = clamped_context(p, self.trap_len, n_valid=n)
            return mlp.forward(self.merger, self._merger_input(ctx),
                               self.fast_exp)
        return jax.vmap(one)(params, n_frames)


def build_estimator(system: str, model_dir: str, nbanks: int,
                    trap_len: int = 31, add_c0: bool = True,
                    use_hamming: bool = True, fast_exp: bool = True):
    """Traps::SetSystem (traps.cpp:572-586): LCRC | 3BT | 1BT | 1BT_DCT."""
    if system == "LCRC":
        return LCRCEstimator(model_dir, nbanks=nbanks, trap_len=trap_len,
                             add_c0=add_c0, fast_exp=fast_exp)
    if system in ("3BT", "1BT"):
        return TrapsEstimator(model_dir, nbanks=nbanks, system=system,
                              trap_len=trap_len, use_hamming=use_hamming,
                              fast_exp=fast_exp)
    if system == "1BT_DCT":
        return DCTEstimator(model_dir, nbanks=nbanks, trap_len=trap_len,
                            add_c0=add_c0, use_hamming=use_hamming,
                            fast_exp=fast_exp)
    raise ValueError(f"unknown posterior system {system!r} "
                     "(Traps::SetSystem accepts LCRC/3BT/1BT/1BT_DCT)")
