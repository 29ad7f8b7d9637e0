"""HEVC core transforms as batched int32 matmuls on the device.

Parity reference: hm-16.5rc1/source/Lib/TLibCommon/TComTrQuant.cpp —
partialButterfly{4,8,16,32} (:388-980), fastForwardDst/fastInverseDst
(:414-474), xT/xIT (:1952,1988).  HM implements these as per-row butterflies;
on the device the same math is two dense matmul stages with a rounding shift between
them, batched over an arbitrary leading axis of blocks so thousands of TUs
transform in one XLA op.

All arithmetic is int32 and bit-exact vs the reference:
  forward:  C = ((T @ B^T) >> s1)  then  ((T @ tmp^T) >> s2)
  inverse:  two stages with shifts (7, 20 - bitDepth), 16-bit clamp between.
Intermediate magnitudes fit int32 (max ~9.4e7 < 2^31).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.utils import rom
from video_codecs_tpu.utils.devconst import dev_const

TRANSFORM_MATRIX_SHIFT = 6


@functools.lru_cache(maxsize=None)
def _matrices(log2_size: int, dst: bool):
    if dst:
        t = rom.DST4
    else:
        t = rom.dct_matrix(1 << log2_size)
    return t.astype(np.int32), np.ascontiguousarray(t.T, dtype=np.int32)


def _stage(t: jnp.ndarray, blocks: jnp.ndarray, shift: int) -> jnp.ndarray:
    """One butterfly stage: out[..., k, j] = (sum_n T[k,n]*blocks[..., j, n] + add) >> shift."""
    add = 1 << (shift - 1)
    # [..., j, n] @ [n, k] -> [..., j, k]; transpose to [..., k, j].
    prod = jnp.matmul(blocks, t.T, preferred_element_type=jnp.int32)
    out = (prod + add) >> shift
    return jnp.swapaxes(out, -1, -2)


def forward_transform(res: jnp.ndarray, log2_size: int, bit_depth: int = 8,
                      dst: bool = False) -> jnp.ndarray:
    """Forward core transform of residual blocks [..., N, N] int32 -> coeffs.

    Output is indexed [..., vertical_freq, horizontal_freq] like HM's
    row-major coefficient buffer.
    """
    n = 1 << log2_size
    assert res.shape[-1] == n and res.shape[-2] == n
    t = dev_const(_matrices(log2_size, dst)[0])
    shift_1st = log2_size + bit_depth + TRANSFORM_MATRIX_SHIFT - rom.MAX_TR_DYNAMIC_RANGE
    shift_2nd = log2_size + TRANSFORM_MATRIX_SHIFT
    # Stage 1 transforms rows (x): tmp[..., kx, y]
    tmp = _stage(t, res.astype(jnp.int32), shift_1st)
    # Stage 2 transforms columns (y): out[..., ky, kx]
    return _stage(t, tmp, shift_2nd)


def inverse_transform(coeff: jnp.ndarray, log2_size: int, bit_depth: int = 8,
                      dst: bool = False) -> jnp.ndarray:
    """Inverse core transform, bit-exact vs HM partialButterflyInverse*."""
    n = 1 << log2_size
    assert coeff.shape[-1] == n and coeff.shape[-2] == n
    t_inv = dev_const(_matrices(log2_size, dst)[1])
    shift_1st = TRANSFORM_MATRIX_SHIFT + 1
    shift_2nd = TRANSFORM_MATRIX_SHIFT + rom.MAX_TR_DYNAMIC_RANGE - 1 - bit_depth
    clamp = (1 << rom.MAX_TR_DYNAMIC_RANGE)  # 16-bit intermediate range
    # coeff[..., ky, kx]; stage 1 inverts columns: tmp[..., y, kx]... keeping
    # the same (transform rows of the transposed view) formulation as forward:
    tmp = _stage(t_inv, jnp.swapaxes(coeff, -1, -2).astype(jnp.int32), shift_1st)
    tmp = jnp.clip(tmp, -clamp, clamp - 1)
    out = _stage(t_inv, tmp, shift_2nd)
    out = jnp.clip(out, -clamp, clamp - 1)
    return jnp.swapaxes(out, -1, -2)


def forward_transform_np(res: np.ndarray, log2_size: int, bit_depth: int = 8,
                         dst: bool = False) -> np.ndarray:
    """NumPy twin of forward_transform (host-side golden path)."""
    t = rom.DST4 if dst else rom.dct_matrix(1 << log2_size)
    t = t.astype(np.int64)
    s1 = log2_size + bit_depth + TRANSFORM_MATRIX_SHIFT - rom.MAX_TR_DYNAMIC_RANGE
    s2 = log2_size + TRANSFORM_MATRIX_SHIFT
    tmp = (t @ res.astype(np.int64).T + (1 << (s1 - 1))) >> s1
    out = (t @ tmp.T + (1 << (s2 - 1))) >> s2
    return out.astype(np.int32)


def inverse_transform_np(coeff: np.ndarray, log2_size: int, bit_depth: int = 8,
                         dst: bool = False) -> np.ndarray:
    """NumPy twin of inverse_transform."""
    t = rom.DST4 if dst else rom.dct_matrix(1 << log2_size)
    t = t.astype(np.int64)
    s1 = TRANSFORM_MATRIX_SHIFT + 1
    s2 = TRANSFORM_MATRIX_SHIFT + rom.MAX_TR_DYNAMIC_RANGE - 1 - bit_depth
    clamp = 1 << rom.MAX_TR_DYNAMIC_RANGE
    tmp = (t.T @ coeff.astype(np.int64) + (1 << (s1 - 1))) >> s1
    tmp = np.clip(tmp, -clamp, clamp - 1)
    out = (t.T @ tmp.T + (1 << (s2 - 1))) >> s2
    out = np.clip(out, -clamp, clamp - 1)
    return out.T.astype(np.int32)
