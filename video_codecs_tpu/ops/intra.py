"""HEVC intra prediction, batched over (blocks, modes) on the device.

Parity references (hm-16.5rc1/source/Lib/TLibCommon):
  TComPattern.cpp:749 fillReferenceSamples (availability + substitution),
  TComPrediction.cpp:412 predIntraAng (Planar :756, angular core
  xPredIntraAng :250, DC with boundary filtering), reference smoothing
  filter TComPattern (1-2-1) — all per spec 8.4.4.2.

Reference sample layout used throughout: a single 1-D array of 4N+1 samples
per block,
    k = 0 .. 2N-1   left column bottom-to-top  (p[-1][2N-1] .. p[-1][0])
    k = 2N          top-left corner            (p[-1][-1])
    k = 2N+1 .. 4N  top row left-to-right      (p[0][-1] .. p[2N-1][-1])
This makes the spec's substitution scan a vectorized forward-fill and the
1-2-1 smoothing a plain 1-D convolution.

Design: every HEVC intra mode is an *integer linear map* of the reference
array (2-tap interpolation for angular, 4-tap for planar, uniform for DC),
followed by a rounding shift.  We therefore precompute, per TB size, a
static weight tensor W[35, N*N, 2*(4N+1)] over the concatenation
[unfiltered ref, smoothed ref] (mode-dependent smoothing selects the half),
and evaluate ALL 35 modes of a batch of blocks as ONE f32 matmul.  It is
exact at default precision, even where the device reads f32 operands as
TF32 (11 significant bits, as on an H100): every weight is an integer of
at most 64 and every sample of at most 1023 (10-bit), both of which fit
11 bits, and every sum stays below 2^24 (the f32 accumulator's integer
range).  tests/test_chip_smoke.py emulates the TF32 rounding; chip_smoke
compares with predict_intra_np on the card.
The only non-linear parts — DC boundary filtering and the pure-H/V edge
filter (luma, N<=16) — are applied as elementwise fixups afterwards.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.utils.devconst import dev_const

from video_codecs_tpu.utils import rom

PLANAR, DC = 0, 1

# Per-mode angle/inverse-angle lookup (index = mode 0..34; 0 for planar/DC).
_ANGLES = np.zeros(35, np.int32)
_ANGLES[2:] = rom.INTRA_PRED_ANGLES
_INV_ABS = np.zeros(35, np.int32)
_INV_ABS[11:26] = -rom.INTRA_INV_ANGLES  # stored positive


def substitute_unavailable(samples: jnp.ndarray, avail: jnp.ndarray,
                           bit_depth: int = 8) -> jnp.ndarray:
    """Spec 8.4.4.2.2 reference substitution, vectorized.

    samples: [..., R] int32 raw neighbor samples (garbage where unavailable)
    avail:   [..., R] bool
    Scan goes k = 0 (bottom-left-most) upward: each unavailable sample takes
    the nearest available predecessor; a fully-unavailable prefix takes the
    first available sample; no samples available -> 1 << (bit_depth - 1).
    """
    ar = jnp.arange(samples.shape[-1], dtype=jnp.int32)
    idx = jnp.where(avail, ar, jnp.int32(-1))
    last = jax.lax.cummax(idx, axis=samples.ndim - 1)
    any_avail = jnp.any(avail, axis=-1, keepdims=True)
    first_idx = jnp.argmax(avail, axis=-1)[..., None].astype(jnp.int32)
    src = jnp.where(last >= 0, last, first_idx)
    filled = jnp.take_along_axis(samples, src, axis=-1)
    return jnp.where(any_avail, filled, jnp.int32(1 << (bit_depth - 1)))


def smooth_reference(ref: jnp.ndarray) -> jnp.ndarray:
    """1-2-1 intra smoothing over the linear reference array, ends kept."""
    mid = (ref[..., :-2] + 2 * ref[..., 1:-1] + ref[..., 2:] + 2) >> 2
    return jnp.concatenate([ref[..., :1], mid, ref[..., -1:]], axis=-1)


def filter_flag(mode: int, log2_size: int, is_luma: bool) -> bool:
    """Spec 8.4.4.2.3 reference-smoothing decision (static)."""
    if not is_luma or log2_size == 2 or mode == DC:
        return False
    thresh = {3: 7, 4: 1, 5: 0}[log2_size]
    dist = min(abs(mode - 26), abs(mode - 10))
    return dist > thresh


def _lin(main_is_top: bool, n: int, *, main_t: int | None = None,
         side_t: int | None = None) -> int:
    """Linear ref index of main[t] / side[t] for a vertical- or
    horizontal-family mode (main = top row for vertical modes)."""
    t = main_t if main_t is not None else side_t
    on_top = main_is_top == (main_t is not None)
    if t == 0:
        return 2 * n  # corner
    return (2 * n + t) if on_top else (2 * n - t)


@functools.lru_cache(maxsize=None)
def _mode_weights(log2_size: int, is_luma: bool):
    """Static weight tensor: W[35, N*N, 2R] over [ref, smoothed_ref];
    plus bias[35] and the common shift S."""
    n = 1 << log2_size
    r = 4 * n + 1
    s_common = max(5, log2_size + 1)
    w = np.zeros((35, n * n, 2 * r), np.float32)
    bias = np.zeros(35, np.int32)

    for mode in range(35):
        half = r if filter_flag(mode, log2_size, is_luma) else 0

        def put(p, lin_idx, weight, scale):
            w[mode, p, half + lin_idx] += weight * scale

        if mode == PLANAR:
            s_m = log2_size + 1
            scale = 1 << (s_common - s_m)
            bias[mode] = n * scale
            for y in range(n):
                for x in range(n):
                    p = y * n + x
                    put(p, 2 * n - 1 - y, n - 1 - x, scale)   # left[y]
                    put(p, 3 * n + 1, x + 1, scale)           # top[n]
                    put(p, 2 * n + 1 + x, n - 1 - y, scale)   # top[x]
                    put(p, n - 1, y + 1, scale)               # left[n]
        elif mode == DC:
            s_m = log2_size + 1
            scale = 1 << (s_common - s_m)
            bias[mode] = n * scale
            for p in range(n * n):
                for i in range(n):
                    put(p, 2 * n + 1 + i, 1, scale)           # top[i]
                    put(p, 2 * n - 1 - i, 1, scale)           # left[i]
        else:
            angle = int(_ANGLES[mode])
            inv = int(_INV_ABS[mode])
            ver = mode >= 18
            scale = 1 << (s_common - 5)
            bias[mode] = 16 * scale

            def ext_lin(k):  # ext[k] = refMain[k - n] -> linear ref index
                if k >= n:
                    return _lin(ver, n, main_t=min(k - n, 2 * n))
                m_ = n - k
                s_idx = min((m_ * inv + 128) >> 8, 2 * n)
                return _lin(ver, n, side_t=s_idx)

            for y in range(n):
                pos = (y + 1) * angle
                iidx = pos >> 5
                fact = pos & 31
                for x in range(n):
                    p = (y * n + x) if ver else (x * n + y)
                    k0 = n + 1 + x + iidx
                    if fact:
                        put(p, ext_lin(k0), 32 - fact, scale)
                        put(p, ext_lin(k0 + 1), fact, scale)
                    else:
                        put(p, ext_lin(k0), 32, scale)
    return w, bias.astype(np.int32), s_common  # numpy: safe across traces


def predict_intra(ref: jnp.ndarray, modes: jnp.ndarray, log2_size: int, *,
                  is_luma: bool = True, bit_depth: int = 8) -> jnp.ndarray:
    """Predict blocks for (batch, mode) pairs.

    ref:   [B, 4N+1] int32 substituted (unfiltered) reference samples
    modes: [B, M] int32 in 0..34
    returns [B, M, N, N] int32 predictions (row y, col x).
    """
    n = 1 << log2_size
    maxval = (1 << bit_depth) - 1
    w, bias, s_common = _mode_weights(log2_size, is_luma)

    ref_f = smooth_reference(ref)
    ref2 = jnp.concatenate([ref, ref_f], axis=-1).astype(jnp.float32)
    # All 35 modes at once: [B, 2R] x [35, N*N, 2R] -> [B, 35, N*N].
    acc = jnp.einsum("br,mpr->bmp", ref2, dev_const(w),
                     preferred_element_type=jnp.float32)
    pred_all = (acc.astype(jnp.int32) + dev_const(bias)[None, :, None]) >> s_common

    # Gather requested modes: [B, M, N*N].
    pred = jnp.take_along_axis(pred_all, modes[..., None], axis=1)
    pred = pred.reshape(modes.shape + (n, n))

    # ---- elementwise fixups (luma, N <= 16) ----
    if is_luma and log2_size <= 4:
        corner = ref[:, 2 * n]
        left = ref[:, 2 * n - 1:n - 1:-1]   # left[0..n-1]
        top = ref[:, 2 * n + 1:3 * n + 1]   # top[0..n-1]
        ys = jnp.arange(n, dtype=jnp.int32)
        xg = ys[None, None, None, :]
        yg = ys[None, None, :, None]

        dc = (jnp.sum(top, axis=-1) + jnp.sum(left, axis=-1) + n) >> (log2_size + 1)
        dcb = dc[:, None, None, None]
        row0 = (top[:, None, None, :] + 3 * dcb + 2) >> 2
        col0 = (left[:, None, :, None] + 3 * dcb + 2) >> 2
        corn = (left[:, :1, None][:, None] + 2 * dcb + top[:, None, None, :1] + 2) >> 2
        is_dc = (modes == DC)[..., None, None]
        pred = jnp.where(is_dc & (yg == 0), jnp.broadcast_to(row0, pred.shape), pred)
        pred = jnp.where(is_dc & (xg == 0) & (yg != 0),
                         jnp.broadcast_to(col0, pred.shape), pred)
        pred = jnp.where(is_dc & (xg == 0) & (yg == 0),
                         jnp.broadcast_to(corn, pred.shape), pred)

        # Pure vertical (26): column 0 gets top[0] + (left[y]-corner)>>1.
        vfix = jnp.clip(top[:, :1][:, None, :, None] +
                        ((left[:, None, :, None] - corner[:, None, None, None]) >> 1),
                        0, maxval)
        pred = jnp.where((modes == 26)[..., None, None] & (xg == 0),
                         jnp.broadcast_to(vfix, pred.shape), pred)
        # Pure horizontal (10): row 0 gets left[0] + (top[x]-corner)>>1.
        hfix = jnp.clip(left[:, :1][:, None, None, :] +
                        ((top[:, None, None, :] - corner[:, None, None, None]) >> 1),
                        0, maxval)
        pred = jnp.where((modes == 10)[..., None, None] & (yg == 0),
                         jnp.broadcast_to(hfix, pred.shape), pred)

    return jnp.clip(pred, 0, maxval).astype(jnp.int32)


def predict_intra_np(ref: np.ndarray, mode: int, log2_size: int, *,
                     is_luma: bool = True, bit_depth: int = 8) -> np.ndarray:
    """Host twin: predict ONE block/mode with the same static weights.

    Used by the sequential host reference encoder/decoder paths where a
    per-block numpy matvec beats a device dispatch.
    """
    n = 1 << log2_size
    maxval = (1 << bit_depth) - 1
    w, bias, s_common = _mode_weights(log2_size, is_luma)
    w = w[mode]                          # [N*N, 2R]
    ref = np.asarray(ref, np.int64)
    mid = (ref[:-2] + 2 * ref[1:-1] + ref[2:] + 2) >> 2
    ref_f = np.concatenate([ref[:1], mid, ref[-1:]])
    ref2 = np.concatenate([ref, ref_f])
    pred = ((w.astype(np.int64) @ ref2 + int(bias[mode])) >> s_common)
    pred = pred.reshape(n, n)

    if is_luma and log2_size <= 4:
        corner = int(ref[2 * n])
        left = ref[2 * n - 1:n - 1:-1]
        top = ref[2 * n + 1:3 * n + 1]
        if mode == DC:
            dc = int((top.sum() + left.sum() + n) >> (log2_size + 1))
            pred[0, 1:] = (top[1:] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[1:] + 3 * dc + 2) >> 2
            pred[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
        elif mode == 26:
            pred[:, 0] = np.clip(top[0] + ((left - corner) >> 1), 0, maxval)
        elif mode == 10:
            pred[0, :] = np.clip(left[0] + ((top - corner) >> 1), 0, maxval)
    return np.clip(pred, 0, maxval).astype(np.int32)


def use_filtered_ref(modes: jnp.ndarray, log2_size: int, is_luma: bool) -> jnp.ndarray:
    """Spec 8.4.4.2.3 filterFlag per mode (bool, broadcast over modes)."""
    if not is_luma or log2_size == 2:
        return jnp.zeros_like(modes, dtype=bool)
    thresh = {3: 7, 4: 1, 5: 0}[log2_size]
    dist = jnp.minimum(jnp.abs(modes - 26), jnp.abs(modes - 10))
    return (modes != DC) & (dist > thresh)
