"""PLP frontend (reference: plp.{cpp,h} — PLPCoefs : MelBanks).

Per frame (plp.cpp:91-141): mel energies (no log) -> floor 1.0 -> equal
loudness curve at the bank centers (dspc.h:235-245) -> cube-root
compression -> duplicate edge banks -> IDFT to autocorrelation
(CreateIDFTMatrix, plp.cpp:143-167) -> Durbin recursion (dspc.cpp:275-308)
-> LPC-to-cepstrum (dspc.cpp:310-323) -> C0 = -ln(1/gain) appended last ->
liftering window (dspc.cpp:327-335) -> cepstral scale.

Design: mel/IDFT stay the two frontend GEMMs; Durbin and LPC->cepstrum
have tiny static order (12), so their recurrences unroll at trace time
into elementwise ops over the whole [T] frame axis — no per-frame loop.
Not used by any shipped package (selected via params/kind=plp), validated
against a standalone reference dump (tools/make_fixtures.sh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu import precision

from phnrec_tpu.frontend.melbanks import (MelFrontend, MelSpec, mel_scale,
                                          mel_to_linear)


def equal_loudness_curve(centers_hz: np.ndarray) -> np.ndarray:
    fsq = centers_hz.astype(np.float64) ** 2
    fsub = fsq / (fsq + 1.6e5)
    return fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))


def idft_matrix(n_bases: int, dim: int) -> np.ndarray:
    """CreateIDFTMatrix (plp.cpp:143-167): [n_bases, dim]."""
    angle = np.pi / (dim - 1)
    scale = 1.0 / (2.0 * (dim - 1))
    i = np.arange(n_bases)[:, None].astype(np.float64)
    j = np.arange(dim)[None, :].astype(np.float64)
    m = 2.0 * scale * np.cos(angle * i * j)
    m[:, 0] = scale
    m[:, -1] = scale * np.cos(angle * i[:, 0] * (dim - 1))
    return m


def lifter_window(order: int, q: float) -> np.ndarray:
    i = np.arange(1, order + 1, dtype=np.float64)
    return 1.0 + 0.5 * q * np.sin(np.pi * i / q)


class PLPFrontend:
    """Mirrors MelFrontend's interface; output dim = order (+1 with c0)."""

    def __init__(self, spec: MelSpec, cfg=None, order: int = 12,
                 compress_fact: float = 0.3333333, cep_lifter: float = 22.0,
                 cep_scale: float = 10.0, add_c0: bool = False):
        if cfg is not None:
            order = cfg.get_int("plp", "order")
            compress_fact = cfg.get_float("plp", "compress_fact")
            cep_lifter = cfg.get_float("plp", "cep_lifter")
            cep_scale = cfg.get_float("plp", "cep_scale")
            add_c0 = cfg.get_bool("plp", "add_c0")
        import dataclasses
        self.spec = dataclasses.replace(spec, take_log=False)
        self.mel = MelFrontend(self.spec)
        self.order = order
        self.compress_fact = compress_fact
        self.cep_lifter = cep_lifter
        self.cep_scale = cep_scale
        self.add_c0 = add_c0

        nb = self.spec.nbanks
        lo = max(float(self.spec.lo_freq), 0.0)
        hi = min(float(self.spec.hi_freq), self.spec.sample_freq / 2.0)
        delta = (mel_scale(hi) - mel_scale(lo)) / (self.spec.full_banks + 1)
        centers = mel_to_linear(
            mel_scale(lo) + delta * np.arange(1, nb + 1))
        self.eql = jnp.asarray(equal_loudness_curve(centers),
                               dtype=jnp.float32)
        self.idft = jnp.asarray(idft_matrix(order + 1, nb + 2).T,
                                dtype=jnp.float32)   # [nb+2, order+1]
        self.lifter = jnp.asarray(lifter_window(order, cep_lifter),
                                  dtype=jnp.float32)

    @property
    def n_params(self) -> int:
        return self.order + 1 if self.add_c0 else self.order

    def frame_count(self, n_samples: int) -> int:
        return self.mel.frame_count(n_samples)

    def frames_from_wave(self, wave, num_frames):
        return self.mel.frames_from_wave(wave, num_frames)

    @partial(jax.jit, static_argnums=0)
    def log_mel_from_frames(self, frames: jnp.ndarray) -> jnp.ndarray:
        """(named for interface parity) [..., vs] -> [..., n_params] PLP."""
        order = self.order
        e = self.mel.log_mel_from_frames(frames)          # energies, no log
        e = jnp.maximum(e, 1.0)
        e = e * self.eql
        e = jnp.power(e, jnp.float32(self.compress_fact))
        e = jnp.concatenate([e[..., :1], e, e[..., -1:]], axis=-1)
        ac = jnp.dot(e, self.idft,
                     precision=precision.get())  # [..., order+1]

        # Durbin recursion, unrolled over the static order (dspc.cpp:275).
        E = ac[..., 0]
        lp = [jnp.zeros_like(E) for _ in range(order)]
        for i in range(order):
            ki = ac[..., i + 1]
            for j in range(i):
                ki = ki + lp[j] * ac[..., i - j]
            ki = ki / E
            E = E * (1.0 - ki * ki)
            new_lp = [lp[j] - ki * lp[i - j - 1] for j in range(i)]
            new_lp.append(-ki)
            for j in range(i + 1):
                lp[j] = new_lp[j]

        # LPC -> cepstrum (dspc.cpp:310-323)
        cep = []
        for i in range(order):
            s = jnp.zeros_like(E)
            for j in range(i):
                s = s + (i - j) * lp[j] * cep[i - j - 1]
            cep.append(-lp[i] - s / (i + 1))

        c0 = jnp.log(E)                                   # -ln(1/gain)
        cep = jnp.stack(cep, axis=-1)
        if self.cep_lifter != 0.0:
            cep = cep * self.lifter
        out = jnp.concatenate([cep, c0[..., None]], axis=-1)
        if self.cep_scale != 1.0:
            out = out * jnp.float32(self.cep_scale)
        return out if self.add_c0 else out[..., :order]

    def __call__(self, wave, num_frames):
        return self.log_mel_from_frames(
            self.frames_from_wave(wave, num_frames))
