"""Distortion kernels: SAD / SSE / Hadamard SATD, batched on the device.

Parity reference: hm-16.5rc1/source/Lib/TLibCommon/TComRdCost.cpp —
function-pointer table (:228-260), xGetSAD*, xGetSSE*, xCalcHADs8x8.
On the device these are reductions / small matmuls over batched blocks; the
encoder mode sweep calls them over [blocks, modes] at once.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.utils.devconst import dev_const


def sad(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Sum of absolute differences over trailing 2 dims."""
    return jnp.sum(jnp.abs(a.astype(jnp.int32) - b.astype(jnp.int32)),
                   axis=(-2, -1))


def sse(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    return jnp.sum(d * d, axis=(-2, -1))


@functools.lru_cache(maxsize=None)
def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_satd_8x8(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """HM-style SATD over [..., 8k, 8m] blocks: sum over 8x8 tiles of
    ((sum |H8 d H8|) + 2) >> 2  (TComRdCost xCalcHADs8x8)."""
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    h, w = d.shape[-2], d.shape[-1]
    assert h % 8 == 0 and w % 8 == 0
    d = d.reshape(d.shape[:-2] + (h // 8, 8, w // 8, 8))
    d = jnp.swapaxes(d, -3, -2)  # [..., th, tw, 8, 8]
    h8 = dev_const(_hadamard(8), jnp.int32)
    t = jnp.einsum("ij,...jk,kl->...il", h8, d, h8,
                   preferred_element_type=jnp.int32)
    s = jnp.sum(jnp.abs(t), axis=(-2, -1))
    s = (s + 2) >> 2
    return jnp.sum(s, axis=(-2, -1))


def hadamard_satd_4x4(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """SATD over 4x4 tiles: ((sum |H4 d H4|) + 1) >> 1 per tile."""
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    h, w = d.shape[-2], d.shape[-1]
    assert h % 4 == 0 and w % 4 == 0
    d = d.reshape(d.shape[:-2] + (h // 4, 4, w // 4, 4))
    d = jnp.swapaxes(d, -3, -2)
    h4 = dev_const(_hadamard(4), jnp.int32)
    t = jnp.einsum("ij,...jk,kl->...il", h4, d, h4,
                   preferred_element_type=jnp.int32)
    s = (jnp.sum(jnp.abs(t), axis=(-2, -1)) + 1) >> 1
    return jnp.sum(s, axis=(-2, -1))
