"""Quality metrics: PSNR, SSIM, MS-SSIM, SSIM3D, STVSSIM as device convs.

Parity references: jm18.5/lencod/src/img_dist_ssim.c / img_dist_ms_ssim.c
(8x8 uniform-window SSIM, 5-scale MS-SSIM), stvssim_src/stvssimrdo2_att/
lencod/src/stvssim.c — compute_SSIM :491 (sliding window), compute_SSIM3D
:1093 (temporal-volume SSIM over a frame window), compute_stVSSIM :587
(motion-oriented spatio-temporal kernels), per-MB distortions used in the
perceptual RDO hook (rdopt.c:469-481).

Everything is expressed as depthwise convolutions / pooled moments, so a
whole frame's metric map computes in a few fused XLA ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

C1 = (0.01 * 255) ** 2
C2 = (0.03 * 255) ** 2


def _box_moments(x: jnp.ndarray, win: int):
    """Mean/e2 maps via a uniform win x win window (valid positions)."""
    k = jnp.ones((win, win), jnp.float32) / (win * win)
    def conv(a):
        # HIGHEST: at default precision an accelerator may run f32 convs
        # with reduced-precision multiplies (bf16 or TF32), which costs
        # ~7e-4 absolute SSIM vs the f32 reference math (oracle-tested)
        return jax.lax.conv_general_dilated(
            a[None, None], k[None, None], (1, 1), "VALID",
            precision=jax.lax.Precision.HIGHEST)[0, 0]
    m = conv(x)
    m2 = conv(x * x)
    return m, m2


def ssim_map(a: jnp.ndarray, b: jnp.ndarray, win: int = 8) -> jnp.ndarray:
    """SSIM index map (uniform window, JM img_dist_ssim.c style)."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    ma, maa = _box_moments(a, win)
    mb, mbb = _box_moments(b, win)
    k = jnp.ones((win, win), jnp.float32) / (win * win)
    mab = jax.lax.conv_general_dilated(
        (a * b)[None, None], k[None, None], (1, 1), "VALID",
        precision=jax.lax.Precision.HIGHEST)[0, 0]
    va = maa - ma * ma
    vb = mbb - mb * mb
    cov = mab - ma * mb
    return ((2 * ma * mb + C1) * (2 * cov + C2) /
            ((ma * ma + mb * mb + C1) * (va + vb + C2)))


def ssim(a, b, win: int = 8) -> float:
    return float(jnp.mean(ssim_map(a, b, win)))


def ms_ssim(a, b, win: int = 8) -> float:
    """5-scale MS-SSIM (img_dist_ms_ssim.c weights)."""
    weights = [0.0448, 0.2856, 0.3001, 0.2363, 0.1333]
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    vals = []
    for lvl in range(5):
        wn = min(win, a.shape[0], a.shape[1])
        vals.append(float(jnp.mean(ssim_map(a, b, wn))))
        if lvl < 4:
            h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
            a, b = a[:h2, :w2], b[:h2, :w2]
            a = (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] +
                 a[1::2, 1::2]) / 4
            b = (b[0::2, 0::2] + b[1::2, 0::2] + b[0::2, 1::2] +
                 b[1::2, 1::2]) / 4
            if min(a.shape) < 2:
                break
    out = 1.0
    for w, v in zip(weights[:len(vals)], vals):
        out *= max(v, 1e-6) ** w
    return out


def ssim3d(ref_stack: jnp.ndarray, enc_stack: jnp.ndarray,
           win: int = 8) -> float:
    """Volume SSIM over a temporal window (stvssim.c compute_SSIM3D :1093):
    moments pooled over (t, y, x) boxes."""
    a = jnp.asarray(ref_stack, jnp.float32)
    b = jnp.asarray(enc_stack, jnp.float32)
    t = a.shape[0]
    k = jnp.ones((t, win, win), jnp.float32) / (t * win * win)
    def conv(x):
        return jax.lax.conv_general_dilated(
            x[None, None], k[None, None], (1, 1, 1), "VALID",
            precision=jax.lax.Precision.HIGHEST)[0, 0]
    ma, mb = conv(a), conv(b)
    va = conv(a * a) - ma * ma
    vb = conv(b * b) - mb * mb
    cov = conv(a * b) - ma * mb
    m = ((2 * ma * mb + C1) * (2 * cov + C2) /
         ((ma * ma + mb * mb + C1) * (va + vb + C2)))
    return float(jnp.mean(m))


def _oriented_kernels(length: int = 9) -> np.ndarray:
    """Four oriented line kernels (v/h/diag) like stvssim.c :116-334."""
    k = np.zeros((4, length, length), np.float32)
    c = length // 2
    for i in range(length):
        k[0, i, c] = 1.0          # vertical
        k[1, c, i] = 1.0          # horizontal
        k[2, i, i] = 1.0          # diagonal \
        k[3, i, length - 1 - i] = 1.0  # diagonal /
    return k / length


def stvssim(ref_stack, enc_stack, mvs=None, win: int = 8) -> float:
    """Spatio-temporal-view SSIM (stvssim.c compute_stVSSIM :587).

    Combines spatial SSIM of the current frame with SSIM along oriented
    spatio-temporal trajectories; mvs (optional [F, H, W, 2]) selects the
    dominant motion direction per region — without them the four fixed
    orientations are averaged (the reference's fallback when motion
    estimation confidence is low).
    """
    a = jnp.asarray(ref_stack, jnp.float32)
    b = jnp.asarray(enc_stack, jnp.float32)
    s_spatial = ssim(a[-1], b[-1], win)
    kerns = jnp.asarray(_oriented_kernels())
    # Filter each frame with each oriented kernel, then temporal SSIM of
    # the filtered trajectories.
    def fil(x):
        return jax.lax.conv_general_dilated(
            x[:, None], kerns[:, None], (1, 1), "SAME",
            precision=jax.lax.Precision.HIGHEST)  # [F, 4, H, W]
    fa, fb = fil(a), fil(b)
    ma = jnp.mean(fa, axis=0)
    mb = jnp.mean(fb, axis=0)
    va = jnp.mean(fa * fa, axis=0) - ma * ma
    vb = jnp.mean(fb * fb, axis=0) - mb * mb
    cov = jnp.mean(fa * fb, axis=0) - ma * mb
    st = ((2 * ma * mb + C1) * (2 * cov + C2) /
          ((ma * ma + mb * mb + C1) * (va + vb + C2)))
    s_temporal = float(jnp.mean(st))
    return 0.5 * (s_spatial + s_temporal)


# ---------------------------------------------------------------------------
# Visual attention / saliency (cAttention + attention.c parity)
# ---------------------------------------------------------------------------

def _gabor_bank(size: int = 9, orientations: int = 4) -> np.ndarray:
    """Gabor kernels (gabor.c parity) for orientation-contrast saliency."""
    ks = np.zeros((orientations, size, size), np.float32)
    c = size // 2
    yy, xx = np.mgrid[-c:c + 1, -c:c + 1].astype(np.float32)
    for o in range(orientations):
        th = np.pi * o / orientations
        xr = xx * np.cos(th) + yy * np.sin(th)
        yr = -xx * np.sin(th) + yy * np.cos(th)
        g = np.exp(-(xr ** 2 + 0.25 * yr ** 2) / (2 * 2.5 ** 2)) * \
            np.cos(2 * np.pi * xr / 4.0)
        g -= g.mean()
        ks[o] = g
    return ks


def saliency_map(y: jnp.ndarray, prev_y: jnp.ndarray | None = None) -> jnp.ndarray:
    """Itti-style static (+ motion) saliency (attention.c:450 semantics):
    intensity center-surround + Gabor orientation energy + |frame diff|."""
    x = jnp.asarray(y, jnp.float32)
    # intensity center-surround: |x - blur(x)|
    k = jnp.ones((9, 9), jnp.float32) / 81.0
    blur = jax.lax.conv_general_dilated(x[None, None], k[None, None],
                                        (1, 1), "SAME")[0, 0]
    intensity = jnp.abs(x - blur)
    gab = jnp.asarray(_gabor_bank())
    orient = jax.lax.conv_general_dilated(x[None, None], gab[:, None],
                                          (1, 1), "SAME")[0]
    orientation = jnp.mean(jnp.abs(orient), axis=0)
    sal = intensity / (intensity.max() + 1e-6) + \
        orientation / (orientation.max() + 1e-6)
    if prev_y is not None:
        motion = jnp.abs(x - jnp.asarray(prev_y, jnp.float32))
        sal = sal + motion / (motion.max() + 1e-6)
    return sal / sal.max()


def attention_lambda_weights(sal: jnp.ndarray, block: int = 16,
                             strength: float = 0.5) -> jnp.ndarray:
    """Per-block lambda modulation eta (mode_decision.c:140-151 semantics):
    salient blocks get lambda scaled down (more bits), background up."""
    h, w = sal.shape
    bs = sal[:h - h % block, :w - w % block].reshape(
        h // block, block, w // block, block).mean(axis=(1, 3))
    eta = 1.0 + strength * (bs.mean() - bs) / (bs.std() + 1e-6)
    return jnp.clip(eta, 0.5, 2.0)
