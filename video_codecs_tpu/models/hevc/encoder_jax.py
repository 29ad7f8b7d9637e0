"""Device-side all-intra frame encoder: two jitted passes (device fast path).

Pass 1 — mode decision (fully parallel): reference samples for every block
gathered from the ORIGINAL planes, all 35 modes predicted as one matmul
(ops.intra), 8x8-Hadamard SATD, then a lax.scan per block-row carrying the
left-neighbor mode for MPM-aware bit costs (rows are independent because
the above-MPM candidate is always DC at CTB granularity — spec 8.4.2).

Pass 2 — reconstruction (wavefront): block (bx, by) depends on left, top,
top-right recon, so all blocks on an anti-diagonal d = bx + 2*by are
independent (the WPP shift, SURVEY.md §2.9/§7.1). One lax.fori_loop over
d with a fixed-size masked batch per step: gather refs -> substitute ->
predict chosen mode -> DCT -> Q -> IQ -> IDCT -> scatter recon. Luma and
both chroma planes are processed in the same step (their dependencies
follow the same wavefront).

Outputs are bit-exact vs the host reference path (intra_codec) and feed
the host CABAC serializer unchanged.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.utils.devconst import dev_const

from video_codecs_tpu.ops import cost as cost_ops
from video_codecs_tpu.ops import intra as intra_ops
from video_codecs_tpu.ops import quant as quant_ops
from video_codecs_tpu.ops import transform as tr_ops

DC = 1


# ---------------------------------------------------------------------------
# Reference-sample gather (vectorized build_ref_np twin)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_offsets(n: int):
    """Static (dy, dx) offsets of the 4N+1 reference samples."""
    r = 4 * n + 1
    dy = np.zeros(r, np.int32)
    dx = np.zeros(r, np.int32)
    for k in range(2 * n):
        dy[k] = 2 * n - 1 - k
        dx[k] = -1
    dy[2 * n] = -1
    dx[2 * n] = -1
    for i in range(2 * n):
        dy[2 * n + 1 + i] = -1
        dx[2 * n + 1 + i] = i
    return dy, dx  # numpy: lru_cache must never hold traced jnp values


def gather_refs(plane: jnp.ndarray, x0: jnp.ndarray, y0: jnp.ndarray,
                n: int) -> jnp.ndarray:
    """Substituted reference arrays [B, 4N+1] for blocks at (x0, y0).

    Availability = raster block decode order: left (j < N), corner, top and
    top-right (clipped at the picture edge); below-left never available.
    """
    h, w = plane.shape
    dy, dx = _ref_offsets(n)
    rows = y0[:, None] + dy[None, :]
    cols = x0[:, None] + dx[None, :]
    k = jnp.arange(4 * n + 1, dtype=jnp.int32)[None, :]
    is_left = (k < 2 * n)
    avail = jnp.where(
        is_left,
        (x0[:, None] > 0) & (k >= n),                 # left part only
        jnp.where(k == 2 * n,
                  (x0[:, None] > 0) & (y0[:, None] > 0),
                  (y0[:, None] > 0) & (cols < w)))
    samples = plane[jnp.clip(rows, 0, h - 1), jnp.clip(cols, 0, w - 1)]
    return intra_ops.substitute_unavailable(samples.astype(jnp.int32), avail)


# ---------------------------------------------------------------------------
# Pass 1: mode decision
# ---------------------------------------------------------------------------

def decide_modes_device(y: jnp.ndarray, qp: int, bw: int, bh: int) -> jnp.ndarray:
    """[bh, bw] best intra mode per 16x16 block (orig-neighbor sweep)."""
    ys = jnp.arange(bh, dtype=jnp.int32) * 16
    xs = jnp.arange(bw, dtype=jnp.int32) * 16
    x0 = jnp.tile(xs, bh)
    y0 = jnp.repeat(ys, bw)
    refs = gather_refs(y.astype(jnp.int32), x0, y0, 16)
    modes = jnp.broadcast_to(jnp.arange(35, dtype=jnp.int32),
                             (bw * bh, 35))
    preds = intra_ops.predict_intra(refs, modes, 4)
    blocks = _extract_blocks(y.astype(jnp.int32), x0, y0, 16)
    satd = cost_ops.hadamard_satd_8x8(blocks[:, None], preds)  # [B, 35]
    satd = satd.reshape(bh, bw, 35)

    sl = math.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0))
    c_mpm0 = int(round(sl * 2.0))
    c_mpm1 = int(round(sl * 3.0))
    c_rem = int(round(sl * 6.0))

    def step(left_mode, satd_b):
        m0 = jnp.where(left_mode < 2, 0, left_mode)
        m2 = jnp.where(left_mode < 2, 26, 0)
        bits = jnp.full(35, c_rem, jnp.int32)
        bits = bits.at[m0].set(c_mpm0).at[1].set(c_mpm1).at[m2].set(c_mpm1)
        # careful: order matters if m0/m2 collide with DC=1; mpm0 wins
        bits = bits.at[m0].set(c_mpm0)
        best = jnp.argmin(satd_b + bits).astype(jnp.int32)
        return best, best

    def row(satd_row):
        _, bests = jax.lax.scan(step, jnp.int32(DC), satd_row)
        return bests

    return jax.vmap(row)(satd)


def _extract_blocks(plane: jnp.ndarray, x0: jnp.ndarray, y0: jnp.ndarray,
                    n: int) -> jnp.ndarray:
    rows = y0[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None, :, None]
    cols = x0[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None, None, :]
    return plane[rows, cols]


# ---------------------------------------------------------------------------
# Pass 2: wavefront reconstruction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _wavefront_schedule(bw: int, bh: int):
    """Static schedule: for each diagonal d = bx + 2*by, the (padded) list
    of block coords; plus per-step valid mask."""
    steps = bw + 2 * (bh - 1)
    per_step: list[list[tuple[int, int]]] = [[] for _ in range(steps)]
    for by in range(bh):
        for bx in range(bw):
            per_step[bx + 2 * by].append((bx, by))
    max_len = max(len(s) for s in per_step)
    coords = np.zeros((steps, max_len, 2), np.int32)
    valid = np.zeros((steps, max_len), bool)
    for d, blocks in enumerate(per_step):
        for i, (bx, by) in enumerate(blocks):
            coords[d, i] = (bx, by)
            valid[d, i] = True
    return coords, valid, steps, max_len  # numpy constants


def _code_blocks(orig, pred, qp, log2, intra_slice=True, sbh=False,
                 rdoq=False, is_luma=True, lam=None):
    """Batched TB coding: returns (levels, recon, cbf).

    rdoq: False = hard quant, True/"lite" = elementwise RDOQ-lite,
    "full" = the scan-based device full RDOQ (rdoq_jax — HM
    xRateDistOptQuant parity; use for the big batched passes, keep
    "lite" inside wavefront loops where a 256-step scan per diagonal
    would dominate).
    """
    res = orig - pred
    coeff = tr_ops.forward_transform(res, log2)
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    if rdoq == "full":
        from video_codecs_tpu.ops import rdoq_jax
        levels = rdoq_jax.rdoq_dev(
            coeff, qp, log2, lam=lam, is_luma=is_luma,
            slice_type=2 if intra_slice else 0)
    elif rdoq:
        levels = quant_ops.rdoq_lite(coeff, qp, log2, lam=lam)
    else:
        levels = quant_ops.quantize(coeff, qp, log2)
    if sbh:
        levels = quant_ops.apply_sbh(levels, log2, coeff, qp)
    cbf = jnp.any(levels != 0, axis=(-2, -1))
    dq = quant_ops.dequantize(levels, qp, log2)
    r = tr_ops.inverse_transform(dq, log2)
    rec = jnp.clip(pred + r, 0, 255)
    rec = jnp.where(cbf[:, None, None], rec, pred)
    return levels, rec, cbf


def _code_blocks_rate(orig, pred, qp, log2, sbh=False, is_luma=True,
                      rdoq="full", lam=None):
    """Batched TB coding that also returns the estimated CABAC rate.

    Returns (levels, recon, cbf, bits[f32 per block]).  With rdoq="full"
    the bits come from the RDOQ's own fractional-bit bookkeeping (HM
    CABAC-counter parity); otherwise a cheap proxy is used.
    """
    res = orig - pred
    coeff = tr_ops.forward_transform(res, log2)
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    if rdoq == "full":
        from video_codecs_tpu.ops import rdoq_jax
        levels, bits = rdoq_jax.rdoq_dev(
            coeff, qp, log2, lam=lam, is_luma=is_luma, slice_type=0,
            return_rate=True)
    else:
        if rdoq:
            levels = quant_ops.rdoq_lite(coeff, qp, log2, lam=lam)
        else:
            levels = quant_ops.quantize(coeff, qp, log2,
                                        intra_slice=False)
        a = jnp.abs(levels)
        bits = (2.0 * jnp.sum(a > 0, axis=(-2, -1)) +
                2.0 * jnp.sum(jnp.log2(1.0 + a.astype(jnp.float32)),
                              axis=(-2, -1)))
    if sbh:
        levels = quant_ops.apply_sbh(levels, log2, coeff, qp)
    cbf = jnp.any(levels != 0, axis=(-2, -1))
    dq = quant_ops.dequantize(levels, qp, log2)
    r = tr_ops.inverse_transform(dq, log2)
    rec = jnp.clip(pred + r, 0, 255)
    rec = jnp.where(cbf[:, None, None], rec, pred)
    return levels, rec, cbf, bits


def _predict_single_mode(refs: jnp.ndarray, modes: jnp.ndarray, log2: int,
                         is_luma: bool) -> jnp.ndarray:
    """[L, 4N+1] refs + [L] modes -> [L, N, N] predictions."""
    return intra_ops.predict_intra(refs, modes[:, None], log2,
                                   is_luma=is_luma)[:, 0]


def encode_frame_device(y, u, v, modes, qp: int, qp_c: int, bw: int, bh: int,
                        sbh: bool = False, rdoq: bool = False):
    """Wavefront recon of a whole frame on device.

    Inputs: int32 planes, modes [bh, bw].
    Returns: levels_y [B,16,16], levels_cb/cr [B,8,8], cbf_y/cb/cr [B],
             rec_y, rec_u, rec_v.
    """
    coords, valid, steps, max_len = _wavefront_schedule(bw, bh)
    coords = dev_const(coords)
    valid = dev_const(valid)
    h, w = y.shape
    b = bw * bh

    state = dict(
        rec_y=jnp.zeros((h, w), jnp.int32),
        rec_u=jnp.zeros((h // 2, w // 2), jnp.int32),
        rec_v=jnp.zeros((h // 2, w // 2), jnp.int32),
        levels_y=jnp.zeros((b, 16, 16), jnp.int32),
        levels_cb=jnp.zeros((b, 8, 8), jnp.int32),
        levels_cr=jnp.zeros((b, 8, 8), jnp.int32),
        cbf=jnp.zeros((3, b), bool),
    )
    modes_flat = modes.reshape(-1)

    def plane_step(plane, orig, x0, y0, n, blk_modes, is_luma, qpp, vmask):
        refs = gather_refs(plane, x0, y0, n)
        pred = _predict_single_mode(refs, blk_modes, 4 if n == 16 else 3,
                                    is_luma)
        oblk = _extract_blocks(orig, x0, y0, n)
        levels, rec, cbf = _code_blocks(oblk, pred, qpp, 4 if n == 16 else 3,
                                        sbh=sbh, rdoq=rdoq)
        rows = y0[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None, :, None]
        cols = x0[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None, None, :]
        # Invalid lanes scatter out of bounds -> dropped.
        rows = jnp.where(vmask[:, None, None], rows, plane.shape[0] + 7)
        plane = plane.at[rows, cols].set(rec, mode="drop")
        return plane, levels, cbf

    def body(d, st):
        c = jax.lax.dynamic_slice(coords, (d, 0, 0), (1, max_len, 2))[0]
        vmask = jax.lax.dynamic_slice(valid, (d, 0), (1, max_len))[0]
        bx, by = c[:, 0], c[:, 1]
        bidx = by * bw + bx
        blk_modes = modes_flat[bidx]

        rec_y, lv_y, cbf_y = plane_step(
            st["rec_y"], y, bx * 16, by * 16, 16, blk_modes, True, qp, vmask)
        rec_u, lv_cb, cbf_cb = plane_step(
            st["rec_u"], u, bx * 8, by * 8, 8, blk_modes, False, qp_c, vmask)
        rec_v, lv_cr, cbf_cr = plane_step(
            st["rec_v"], v, bx * 8, by * 8, 8, blk_modes, False, qp_c, vmask)

        sidx = jnp.where(vmask, bidx, b + 7)
        st = dict(
            rec_y=rec_y, rec_u=rec_u, rec_v=rec_v,
            levels_y=st["levels_y"].at[sidx].set(lv_y, mode="drop"),
            levels_cb=st["levels_cb"].at[sidx].set(lv_cb, mode="drop"),
            levels_cr=st["levels_cr"].at[sidx].set(lv_cr, mode="drop"),
            cbf=st["cbf"].at[:, sidx].set(
                jnp.stack([cbf_y, cbf_cb, cbf_cr]), mode="drop"),
        )
        return st

    state = jax.lax.fori_loop(0, steps, body, state)
    return state


@functools.partial(jax.jit,
                   static_argnames=("qp", "bw", "bh", "deblock", "sbh",
                                    "rdoq"))
def encode_frame_jit(y, u, v, qp: int, bw: int, bh: int, deblock: bool = True,
                     sbh: bool = False, rdoq: bool = False):
    """Full device pipeline: mode decision + wavefront recon + deblock."""
    from video_codecs_tpu.models.hevc.intra_codec import chroma_qp
    from video_codecs_tpu.ops import deblock as deblock_ops

    yi = y.astype(jnp.int32)
    ui = u.astype(jnp.int32)
    vi = v.astype(jnp.int32)
    modes = decide_modes_device(yi, qp, bw, bh)
    st = encode_frame_device(yi, ui, vi, modes, qp, chroma_qp(qp), bw, bh,
                             sbh=sbh, rdoq=rdoq)
    if deblock:
        st["rec_y"], st["rec_u"], st["rec_v"] = deblock_ops.deblock_420(
            st["rec_y"], st["rec_u"], st["rec_v"], qp)
    st["modes"] = modes
    # Compact the device->host transfer: 8-bit recon is exact for Main
    # profile; coefficient levels are clipped to 16
    # bits by the spec (7.4.9.11 CoeffMin/CoeffMax), so int16 is exact.
    st["rec_y"] = st["rec_y"].astype(jnp.uint8)
    st["rec_u"] = st["rec_u"].astype(jnp.uint8)
    st["rec_v"] = st["rec_v"].astype(jnp.uint8)
    for k in ("levels_y", "levels_cb", "levels_cr"):
        st[k] = jnp.clip(st[k], -32768, 32767).astype(jnp.int16)
    st["modes"] = st["modes"].astype(jnp.int8)
    return st

