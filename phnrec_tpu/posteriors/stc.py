"""Split-temporal-context (LCRC) feature assembly as batched GEMMs.

Reference semantics (traps.cpp): a per-frame sliding band-energy matrix
``be_mat[nbanks][trap_len=31]`` — initialized by replicating the first mel
frame across the whole window (traps.cpp:186-199), then shifted left one
frame at a time.  For the LCRC system (traps.cpp:285-342):

  * Left context  = window columns 0..15  (half_context = 16, includes center)
  * Right context = window columns 15..30 (shares the center column)
  * each is multiplied bankwise by its window file (band0/band1),
  * then per bank reduced to [C0, DCT_1..DCT_10] (add_c0=true), where
    C0 = sqrt(2/n)*sum (dspc.h:223-233) and DCT_k uses basis
    sqrt(2/n)*cos(pi/n*k*(j+0.5)), k=1..10 (dspc.h:206-221),
  * features are laid out bank-major: [bank0 c0,d1..d10, bank1 ...].

Here the whole per-frame sliding machinery collapses into

  ctx[t, j, b] = params[clip(t + j - 15, 0, T-1), b]     (one gather)
  feat_side[t, b, k] = sum_j ctx[t, off+j, b] * M_side[j, k]

where M_side[j, k] = window_side[j] * dct_basis[j, k] is a fixed [16, 11]
matrix per side — i.e. two small GEMMs over a [T*B, 16] reshape.  The
clip-gather reproduces the reference's replicate-first-frame init and the
orchestrator's 3-phase edge handling (srec.cpp:1035-1059: posterior row t
sees mel frames t-15..t+15 with both edges clamped) exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu import precision


def dct_c0_matrix(n: int, n_coefs: int, add_c0: bool) -> np.ndarray:
    """[n, n_coefs] matrix M with columns = [C0?, DCT_1, DCT_2, ...]."""
    norm = np.sqrt(2.0 / n)
    j = np.arange(n, dtype=np.float64)
    cols = []
    n_dct = n_coefs - 1 if add_c0 else n_coefs
    if add_c0:
        cols.append(np.full(n, norm))
    for k in range(1, n_dct + 1):
        cols.append(norm * np.cos(np.pi / n * k * (j + 0.5)))
    return np.stack(cols, axis=1)


def clamped_context(params: jnp.ndarray, trap_len: int,
                    n_valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """[T, B] params -> [T, trap_len, B] sliding context, row t covering
    frames t-shift..t+shift with both edges clamped (replicate-first-frame
    window init traps.cpp:186-199 + the orchestrator's 3-phase edge
    handling srec.cpp:1035-1059).  Gather-free: rows at or beyond
    ``n_valid`` are overwritten with row n_valid-1 (repeat-last-frame
    tail, srec.cpp:877-927), the buffer is edge-replicated by ``shift``
    rows, and the trap_len context columns become static shifted slices —
    pure copies XLA fuses into downstream GEMMs."""
    T = params.shape[0]
    shift = (trap_len - 1) // 2
    p = params
    if n_valid is not None:
        last = p[jnp.maximum(n_valid - 1, 0)]
        mask = (jnp.arange(T) < n_valid)[:, None]
        p = jnp.where(mask, p, last[None, :])
    top = jnp.repeat(p[:1], shift, axis=0)
    bot = jnp.repeat(p[-1:], shift, axis=0)
    p3 = jnp.concatenate([top, p, bot], axis=0)          # [T + 2*shift, B]
    return jnp.stack([p3[o : o + T] for o in range(trap_len)], axis=1)


class LCRCSpec(NamedTuple):
    nbanks: int
    trap_len: int          # 31
    n_coefs: int           # band-net input size / nbanks (11 with add_c0)
    add_c0: bool


class LCRCAssembler:
    """Precomputed window*DCT matrices for both context sides."""

    def __init__(self, spec: LCRCSpec, win_left: np.ndarray,
                 win_right: np.ndarray):
        self.spec = spec
        hc = (spec.trap_len - 1) // 2 + 1   # 16
        self.half_context = hc
        if win_left.shape[0] != hc or win_right.shape[0] != hc:
            raise ValueError("window length must equal half_context")
        M = dct_c0_matrix(hc, spec.n_coefs, spec.add_c0)  # [16, n_coefs]
        self.m_left = jnp.asarray(win_left[:, None] * M, dtype=jnp.float32)
        self.m_right = jnp.asarray(win_right[:, None] * M, dtype=jnp.float32)

    def context_indices(self, num_frames: int) -> jnp.ndarray:
        """[T, trap_len] clip-gather indices: row t covers t-15..t+15."""
        shift = (self.spec.trap_len - 1) // 2
        t = jnp.arange(num_frames)[:, None]
        j = jnp.arange(self.spec.trap_len)[None, :]
        return jnp.clip(t + j - shift, 0, num_frames - 1)

    def context(self, params: jnp.ndarray,
                n_valid: jnp.ndarray | None = None) -> jnp.ndarray:
        """[T, B] mel params -> [T, trap_len, B] clamped sliding context.

        Gather-free formulation: rows at or
        beyond ``n_valid`` are first overwritten with row ``n_valid - 1``
        (the repeat-last-frame tail, srec.cpp:877-927), then the buffer is
        edge-replicated by ``shift`` rows on both ends and the 31 context
        columns become 31 static shifted slices — pure copies that XLA
        fuses into the downstream GEMM.
        """
        return clamped_context(params, self.spec.trap_len, n_valid)

    def batched(self, params: jnp.ndarray,
                n_valid: jnp.ndarray | None = None
                ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Batched LCRC assembly as two depthwise convolutions.

        [B, T, nbanks] mel params (+ per-row valid counts) -> (left,
        right) band-net inputs [B, T, nbanks*n_coefs].  Equivalent to
        vmapping __call__, but never materializes the [T, 31, nbanks]
        sliding context (a 31x HBM blow-up): feat[t, g, k] =
        sum_j p3[t+off+j, g] * M[j, k] is a length-16 temporal conv per
        bank, so each side is one lax.conv with feature_group_count =
        nbanks and the window*DCT matrix tiled across groups — output
        channels land bank-major (g*n_coefs + k) exactly like the
        reference layout (traps.cpp:285-344).
        """
        B, T, nb = params.shape
        shift = (self.spec.trap_len - 1) // 2
        p = params
        if n_valid is not None:
            last = p[jnp.arange(B), jnp.maximum(n_valid - 1, 0)]
            mask = (jnp.arange(T)[None, :] < n_valid[:, None])[..., None]
            p = jnp.where(mask, p, last[:, None, :])
        top = jnp.repeat(p[:, :1], shift, axis=1)
        bot = jnp.repeat(p[:, -1:], shift, axis=1)
        p3 = jnp.concatenate([top, p, bot], axis=1)   # [B, T+2*shift, nb]

        hc = self.half_context
        dn = jax.lax.conv_dimension_numbers(
            (B, T + hc - 1, nb), (hc, 1, nb * self.spec.n_coefs),
            ("NWC", "WIO", "NWC"))

        def side(x, m):
            k = jnp.concatenate([m] * nb, axis=1)[:, None, :]  # [16,1,nb*C]
            return jax.lax.conv_general_dilated(
                x, k, window_strides=(1,), padding="VALID",
                dimension_numbers=dn, feature_group_count=nb,
                precision=precision.get())

        # left covers context cols 0..15 (p3 rows t..t+15), right cols
        # 15..30 (p3 rows t+15..t+30)
        return (side(p3[:, : T + hc - 1], self.m_left),
                side(p3[:, shift:], self.m_right))

    def __call__(self, params: jnp.ndarray,
                 n_valid: jnp.ndarray | None = None
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """[T, nbanks] mel params -> (left, right) band-net inputs
        [T, nbanks*n_coefs] each, bank-major feature layout.  ``n_valid``
        clamps the context to the last valid frame of a padded utterance."""
        T = params.shape[0]
        hc = self.half_context
        ctx = self.context(params, n_valid)            # [T, 31, B]
        left = ctx[:, :hc, :]                          # cols 0..15
        right = ctx[:, hc - 1 :, :]                    # cols 15..30
        # [T, 16, B] -> [T, B, 16] @ [16, C] -> [T, B, C] -> [T, B*C]
        fl = jnp.einsum("tjb,jc->tbc", left, self.m_left, precision=precision.get())
        fr = jnp.einsum("tjb,jc->tbc", right, self.m_right, precision=precision.get())
        return (fl.reshape(T, -1), fr.reshape(T, -1))
