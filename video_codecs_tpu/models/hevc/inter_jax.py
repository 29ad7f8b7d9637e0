"""Device-side inter (P-slice) encoding engine — the device port of the
LD-P hot loop.

Replaces the sequential host pass of inter_codec.LowDelayEncoder (HM's
TEncSlice::compressSlice CTU loop -> TEncSearch::predInterSearch
TEncSearch.cpp:2912 / xMotionEstimation :3663 / xPatternSearchFracDIF
:4240 -> TEncCu xCheckRDCostMerge2Nx2N :453) with the SURVEY.md §7.1
two-phase design:

Phase 1 (device, fully parallel over all blocks of the picture):
  1. multi-reference motion search (pyramid/TZ integer + half/quarter
     SATD refinement, ops/me.py) for every 16x16 block;
  2. candidate evaluation: per-reference explicit-MV candidates, merge
     approximations (neighbor/temporal MVs from the phase-1 best field),
     the zero MV, and the best intra mode — each scored SATD + lambda*R
     with closed-form rate estimates;
  3. final motion compensation, residual transform + RDOQ + SBH, and
     reconstruction for every inter block at once;
  4. intra blocks reconstructed on an anti-diagonal wavefront (the only
     neighbor-dependent step; mirrors the all-intra device path);
  5. boundary-strength derivation + deblocking on device.

Phase 2 (host, cheap integer work): spec-exact merge/AMVP reconciliation
against the FINAL motion field (models/hevc/motion.py, shared with the
decoder) and CABAC serialization.  The device decides merge from
*approximate* neighbor fields; the host re-derives the real candidate
lists and codes whichever syntax (merge_idx / AMVP+MVD) reproduces the
final MV — the stream is always conformant and the device recon is
always the decoder recon, approximation only ever costs a few bits.

Conformance: streams decode bit-exactly in inter_codec.LowDelayDecoder
and in HM's TAppDecoder (hash-SEI OK) — tests/test_inter_jax.py.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.utils.devconst import dev_const

from video_codecs_tpu.models.hevc import bframe_codec as bc
from video_codecs_tpu.models.hevc import encoder_jax
from video_codecs_tpu.models.hevc import inter_codec as pc
from video_codecs_tpu.models.hevc import motion
from video_codecs_tpu.models.hevc import ra_codec as ra
from video_codecs_tpu.ops import cost as cost_ops
from video_codecs_tpu.ops import deblock as deblock_ops
from video_codecs_tpu.ops import interp
from video_codecs_tpu.ops import intra as intra_ops
from video_codecs_tpu.ops import me as me_ops
from video_codecs_tpu.ops import quant as quant_ops
from video_codecs_tpu.ops import transform as tr_ops

MODE_INTER, MODE_INTRA = 0, 1
INF = np.int32(1 << 30)   # numpy: safe even under lazy import (see rdoq_jax)


# ---------------------------------------------------------------------------
# Device twins of the shared MV helpers
# ---------------------------------------------------------------------------

def scale_mv_dev(mvx, mvy, tb, td):
    """Vectorized spec 8.5.3.2.8 MV scaling (twin of motion.scale_mv).

    tb, td: int32 arrays or scalars (POC deltas, clipped to [-128, 127]).
    """
    tb = jnp.clip(tb, -128, 127)
    td = jnp.clip(td, -128, 127)
    same = (td == tb) | (td == 0)
    td_safe = jnp.where(td == 0, 1, td)
    num = 16384 + jnp.abs(td_safe) // 2
    tx = jnp.where(td_safe < 0, -(num // jnp.abs(td_safe)),
                   num // jnp.abs(td_safe))
    dsf = jnp.clip((tb * tx + 32) >> 6, -4096, 4095)

    def one(v):
        s = dsf * v
        val = (jnp.abs(s) + 127) >> 8
        return jnp.clip(jnp.where(s >= 0, val, -val), -32768, 32767)

    return (jnp.where(same, mvx, one(mvx)).astype(jnp.int32),
            jnp.where(same, mvy, one(mvy)).astype(jnp.int32))


def mvd_bits_dev(dx, dy):
    """Closed-form MVD rate estimate (twin of inter_codec
    mvd_bits_estimate): 2 + per-component [a>0] + 2*max(floor(log2 a), 1)
    for a > 1."""
    def comp(d):
        a = jnp.abs(d)
        lg = jnp.maximum(
            jnp.floor(jnp.log2(jnp.maximum(a, 1).astype(jnp.float32))),
            1.0).astype(jnp.int32)
        return (a > 0).astype(jnp.int32) + jnp.where(a > 1, 2 * lg, 0)

    return 2 + comp(dx) + comp(dy)


def _shift_grid(field: jnp.ndarray, dx: int, dy: int, fill):
    """Neighbor gather on a [bh, bw, ...] grid: value of the block at
    (bx + dx, by + dy), `fill` outside."""
    out = jnp.roll(field, shift=(-dy, -dx), axis=(0, 1))
    bh, bw = field.shape[:2]
    ys = jnp.arange(bh)[:, None] + dy
    xs = jnp.arange(bw)[None, :] + dx
    inb = (ys >= 0) & (ys < bh) & (xs >= 0) & (xs < bw)
    while inb.ndim < out.ndim:
        inb = inb[..., None]
    return jnp.where(inb, out, fill)


def _scatter_blocks(plane, vals, xs, ys, n, sel):
    """Masked batched block scatter; unselected lanes drop out of bounds."""
    rows = ys[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None, :, None]
    cols = xs[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None, None, :]
    rows = jnp.where(sel[:, None, None], rows, plane.shape[0] + 7)
    return plane.at[rows, cols].set(vals, mode="drop")


def _intra_wavefront(yi, ui, vi, intra_grid, intra_modes, planes, cbfs,
                     qp: int, qp_c: int, sbh: bool, rdoq: bool,
                     bw: int, bh: int):
    """Reconstruct the (rare) intra blocks of an inter picture on an
    anti-diagonal wavefront: rec planes already hold the inter recon, so
    each intra block reads decode-order-correct neighbors.

    planes: (rec_y, rec_u, rec_v, coef_y, coef_u, coef_v);
    cbfs: (cbf_y, cbf_u, cbf_v) flat [B] bool with inter blocks filled.
    Returns the updated (planes, cbfs).
    """
    coords, valid, steps, max_len = encoder_jax._wavefront_schedule(bw, bh)
    coords = dev_const(coords)
    valid = dev_const(valid)

    def body(d, st):
        rec_y_p, rec_u_p, rec_v_p, cf_y, cf_u, cf_v, cb_maps = st
        c = jax.lax.dynamic_slice(coords, (d, 0, 0), (1, max_len, 2))[0]
        vm = jax.lax.dynamic_slice(valid, (d, 0), (1, max_len))[0]
        bxs, bys = c[:, 0], c[:, 1]
        sel = vm & intra_grid[bys, bxs]
        xs, ys = bxs * 16, bys * 16
        modes = intra_modes[bys, bxs]
        refs_l = encoder_jax.gather_refs(rec_y_p, xs, ys, 16)
        pr = intra_ops.predict_intra(refs_l, modes[:, None], 4)[:, 0]
        ob = encoder_jax._extract_blocks(yi, xs, ys, 16)
        lv, rec, cb = encoder_jax._code_blocks(ob, pr, qp, 4,
                                               intra_slice=True, sbh=sbh,
                                               rdoq=rdoq)
        rec_y_p = _scatter_blocks(rec_y_p, rec, xs, ys, 16, sel)
        cf_y = _scatter_blocks(cf_y, lv, xs, ys, 16, sel)
        cb_y, cb_u, cb_v = cb_maps
        tgt = jnp.where(sel, bys * bw + bxs, bw * bh)
        cb_y = cb_y.at[tgt].set(cb, mode="drop")
        cxs, cys = xs // 2, ys // 2
        for comp, (orig_p, rec_p, cf_p) in enumerate((
                (ui, rec_u_p, cf_u), (vi, rec_v_p, cf_v))):
            refs_c = encoder_jax.gather_refs(rec_p, cxs, cys, 8)
            prc = intra_ops.predict_intra(refs_c, modes[:, None], 3,
                                          is_luma=False)[:, 0]
            oc = encoder_jax._extract_blocks(orig_p, cxs, cys, 8)
            lvc, recc, cbc = encoder_jax._code_blocks(
                oc, prc, qp_c, 3, intra_slice=True, sbh=sbh, rdoq=rdoq)
            rec_p = _scatter_blocks(rec_p, recc, cxs, cys, 8, sel)
            cf_p = _scatter_blocks(cf_p, lvc, cxs, cys, 8, sel)
            if comp == 0:
                rec_u_p, cf_u = rec_p, cf_p
                cb_u = cb_u.at[tgt].set(cbc, mode="drop")
            else:
                rec_v_p, cf_v = rec_p, cf_p
                cb_v = cb_v.at[tgt].set(cbc, mode="drop")
        return (rec_y_p, rec_u_p, rec_v_p, cf_y, cf_u, cf_v,
                (cb_y, cb_u, cb_v))

    init = planes + (cbfs,)
    has_intra = jnp.any(intra_grid)
    st = jax.lax.cond(
        has_intra,
        lambda s: jax.lax.fori_loop(0, steps, body, s),
        lambda s: s, init)
    return st[:6], st[6]


# ---------------------------------------------------------------------------
# Phase 1: the jitted P-frame pipeline
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("qp", "w", "h", "n_refs", "search_range", "sbh",
                     "rdoq", "tmvp", "me_method", "deblock", "lam"))
def encode_p_frame_dev(y, u, v, refs_y, refs_u, refs_v,
                       col_inter, col_mvx, col_mvy, col_refpoc,
                       ref_pocs, poc, col_poc,
                       qp: int, w: int, h: int, n_refs: int,
                       search_range: int, sbh: bool, rdoq: bool,
                       tmvp: bool, me_method: str = "pyr",
                       deblock: bool = True, lam: float | None = None):
    """One P picture, all pixel math on device.

    refs_y: [R, H, W] int32 stacked L0 references (newest first);
    col_*: collocated picture motion field (TMVP source), [bh, bw];
    ref_pocs: [R] int32.  Returns a dict of field maps + coef/recon planes.
    """
    from video_codecs_tpu.models.hevc.intra_codec import chroma_qp

    bw, bh = w // 16, h // 16
    nb = bw * bh
    qp_c = chroma_qp(qp)
    x0 = jnp.tile(jnp.arange(bw, dtype=jnp.int32) * 16, bh)
    y0 = jnp.repeat(jnp.arange(bh, dtype=jnp.int32) * 16, bw)
    yi = y.astype(jnp.int32)
    cur = encoder_jax._extract_blocks(yi, x0, y0, 16)
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    sl = math.sqrt(lam)

    # ---- 1. motion search per reference ----
    mvx_r, mvy_r, satd_r = [], [], []
    for r in range(n_refs):
        if me_method == "pyr":
            imx, imy = me_ops.pyramid_search(refs_y[r], cur, x0, y0, 16,
                                             search_range)
            mvx, mvy = imx * 4, imy * 4
            mvx, mvy, _ = me_ops._refine(refs_y[r], cur, x0, y0, mvx, mvy,
                                         16, 2)
            mvx, mvy, satd = me_ops._refine(refs_y[r], cur, x0, y0, mvx,
                                            mvy, 16, 1)
        else:
            mvx, mvy, satd = me_ops.motion_search(
                refs_y[r], cur, x0, y0, 16, search_range, me_method)
        mvx_r.append(mvx)
        mvy_r.append(mvy)
        satd_r.append(satd)
    me_mvx = jnp.stack(mvx_r)          # [R, B]
    me_mvy = jnp.stack(mvy_r)
    me_satd = jnp.stack(satd_r)

    # ---- 2a. explicit-MV candidates: rate vs the left-neighbor predictor
    # (approximation of AMVP; the host recomputes the real predictor) ----
    gx = me_mvx.reshape(n_refs, bh, bw)
    gy = me_mvy.reshape(n_refs, bh, bw)
    pred_x = jnp.concatenate([jnp.zeros((n_refs, bh, 1), jnp.int32),
                              gx[:, :, :-1]], axis=2).reshape(n_refs, nb)
    pred_y = jnp.concatenate([jnp.zeros((n_refs, bh, 1), jnp.int32),
                              gy[:, :, :-1]], axis=2).reshape(n_refs, nb)
    bits_me = mvd_bits_dev(me_mvx - pred_x, me_mvy - pred_y)
    ref_bias = jnp.arange(n_refs, dtype=jnp.int32)[:, None]
    cost_me_r = me_satd + jnp.round(
        sl * (4 + ref_bias + bits_me)).astype(jnp.int32)
    best_r = jnp.argmin(cost_me_r, axis=0)            # [B]
    cost_me = jnp.min(cost_me_r, axis=0)
    me_best_mvx = jnp.take_along_axis(me_mvx, best_r[None], axis=0)[0]
    me_best_mvy = jnp.take_along_axis(me_mvy, best_r[None], axis=0)[0]

    # ---- 2b. merge candidate approximations from the phase-1 field ----
    f_mvx = me_best_mvx.reshape(bh, bw)
    f_mvy = me_best_mvy.reshape(bh, bw)
    f_ref = best_r.reshape(bh, bw).astype(jnp.int32)
    cands = []                                        # (mvx, mvy, ref, ok)
    for dx, dy in ((-1, 0), (0, -1), (1, -1), (-1, -1)):
        cx = _shift_grid(f_mvx, dx, dy, 0).reshape(nb)
        cy = _shift_grid(f_mvy, dx, dy, 0).reshape(nb)
        cr = _shift_grid(f_ref, dx, dy, 0).reshape(nb)
        ys_ = jnp.repeat(jnp.arange(bh), bw) + dy
        xs_ = jnp.tile(jnp.arange(bw), bh) + dx
        ok = (ys_ >= 0) & (ys_ < bh) & (xs_ >= 0) & (xs_ < bw) & \
             ((dy < 0) | (dx < 0))
        cands.append((cx, cy, cr, ok))
    if tmvp:
        td = col_poc - col_refpoc.reshape(nb)
        tb = poc - ref_pocs[0]
        tx_, ty_ = scale_mv_dev(col_mvx.reshape(nb), col_mvy.reshape(nb),
                                tb, td)
        cands.append((tx_, ty_, jnp.zeros(nb, jnp.int32),
                      col_inter.reshape(nb)))
    zeros = jnp.zeros(nb, jnp.int32)
    cands.append((zeros, zeros, zeros, jnp.ones(nb, bool)))

    cost_mrg = jnp.full(nb, 1 << 30, jnp.int32)
    mrg_mvx = jnp.zeros(nb, jnp.int32)
    mrg_mvy = jnp.zeros(nb, jnp.int32)
    mrg_ref = jnp.zeros(nb, jnp.int32)
    for idx, (cx, cy, cr, ok) in enumerate(cands):
        pred = interp.mc_luma_multi(refs_y, cr, x0, y0, cx, cy, 16)
        satd = cost_ops.hadamard_satd_8x8(cur, pred)
        c = satd + jnp.round(sl * (2 + idx)).astype(jnp.int32)
        c = jnp.where(ok, c, INF)
        better = c < cost_mrg
        cost_mrg = jnp.where(better, c, cost_mrg)
        mrg_mvx = jnp.where(better, cx, mrg_mvx)
        mrg_mvy = jnp.where(better, cy, mrg_mvy)
        mrg_ref = jnp.where(better, cr, mrg_ref)

    # ---- 2c. intra candidate (orig-neighbor sweep, like the host path) --
    intra_modes = encoder_jax.decide_modes_device(yi, qp, bw, bh)  # [bh,bw]
    refs_o = encoder_jax.gather_refs(yi, x0, y0, 16)
    pred_i = intra_ops.predict_intra(
        refs_o, intra_modes.reshape(nb)[:, None], 4)[:, 0]
    cost_intra = cost_ops.hadamard_satd_8x8(cur, pred_i) + \
        jnp.round(sl * 9).astype(jnp.int32)

    # ---- 2d. decision ----
    use_intra = (cost_intra <= jnp.minimum(cost_mrg, cost_me))
    use_mrg = (~use_intra) & (cost_mrg <= cost_me)
    fin_mvx = jnp.where(use_mrg, mrg_mvx, me_best_mvx)
    fin_mvy = jnp.where(use_mrg, mrg_mvy, me_best_mvy)
    fin_ref = jnp.where(use_mrg, mrg_ref, best_r).astype(jnp.int32)
    pred_mode = jnp.where(use_intra, MODE_INTRA, MODE_INTER)

    # ---- 3. final MC + residual coding for inter blocks ----
    pred_y_fin = interp.mc_luma_multi(refs_y, fin_ref, x0, y0,
                                      fin_mvx, fin_mvy, 16)
    lv_y, rec_blk, cbf_y = encoder_jax._code_blocks(
        cur, pred_y_fin, qp, 4, intra_slice=False, sbh=sbh,
        rdoq="full" if rdoq else False, lam=lam)

    cx0, cy0 = x0 // 2, y0 // 2
    ui = u.astype(jnp.int32)
    vi = v.astype(jnp.int32)
    cur_u = encoder_jax._extract_blocks(ui, cx0, cy0, 8)
    cur_v = encoder_jax._extract_blocks(vi, cx0, cy0, 8)
    pred_u = interp.mc_chroma_multi(refs_u, fin_ref, cx0, cy0,
                                    fin_mvx, fin_mvy, 8)
    pred_v = interp.mc_chroma_multi(refs_v, fin_ref, cx0, cy0,
                                    fin_mvx, fin_mvy, 8)
    lv_u, rec_u_blk, cbf_u = encoder_jax._code_blocks(
        cur_u, pred_u, qp_c, 3, intra_slice=False, sbh=sbh,
        rdoq="full" if rdoq else False, is_luma=False, lam=lam)
    lv_v, rec_v_blk, cbf_v = encoder_jax._code_blocks(
        cur_v, pred_v, qp_c, 3, intra_slice=False, sbh=sbh,
        rdoq="full" if rdoq else False, is_luma=False, lam=lam)

    # scatter inter recon + coefficients into planes
    scatter = _scatter_blocks
    is_inter = pred_mode == MODE_INTER
    rec_y_pl = scatter(jnp.zeros((h, w), jnp.int32), rec_blk, x0, y0, 16,
                       is_inter)
    rec_u_pl = scatter(jnp.zeros((h // 2, w // 2), jnp.int32), rec_u_blk,
                       cx0, cy0, 8, is_inter)
    rec_v_pl = scatter(jnp.zeros((h // 2, w // 2), jnp.int32), rec_v_blk,
                       cx0, cy0, 8, is_inter)
    coef_y = scatter(jnp.zeros((h, w), jnp.int32), lv_y, x0, y0, 16,
                     is_inter)
    coef_u = scatter(jnp.zeros((h // 2, w // 2), jnp.int32), lv_u, cx0,
                     cy0, 8, is_inter)
    coef_v = scatter(jnp.zeros((h // 2, w // 2), jnp.int32), lv_v, cx0,
                     cy0, 8, is_inter)

    # ---- 4. intra blocks: wavefront recon (neighbor-dependent) ----
    coords, valid, steps, max_len = encoder_jax._wavefront_schedule(bw, bh)
    coords = dev_const(coords)
    valid = dev_const(valid)
    intra_grid = use_intra.reshape(bh, bw)

    def body(d, st):
        rec_y_p, rec_u_p, rec_v_p, cf_y, cf_u, cf_v, cb_maps = st
        c = jax.lax.dynamic_slice(coords, (d, 0, 0), (1, max_len, 2))[0]
        vm = jax.lax.dynamic_slice(valid, (d, 0), (1, max_len))[0]
        bxs, bys = c[:, 0], c[:, 1]
        sel = vm & intra_grid[bys, bxs]
        xs, ys = bxs * 16, bys * 16
        modes = intra_modes[bys, bxs]
        # luma
        refs_l = encoder_jax.gather_refs(rec_y_p, xs, ys, 16)
        pr = intra_ops.predict_intra(refs_l, modes[:, None], 4)[:, 0]
        ob = encoder_jax._extract_blocks(yi, xs, ys, 16)
        lv, rec, cb = encoder_jax._code_blocks(ob, pr, qp, 4,
                                               intra_slice=True, sbh=sbh,
                                               rdoq=rdoq)
        rec_y_p = scatter(rec_y_p, rec, xs, ys, 16, sel)
        cf_y = scatter(cf_y, lv, xs, ys, 16, sel)
        cb_y, cb_u, cb_v = cb_maps
        # invalid lanes scatter out of bounds -> dropped
        tgt = jnp.where(sel, bys * bw + bxs, bw * bh)
        cb_y = cb_y.at[tgt].set(cb, mode="drop")
        # chroma
        cxs, cys = xs // 2, ys // 2
        for comp, (orig_p, rec_p, cf_p) in enumerate((
                (ui, rec_u_p, cf_u), (vi, rec_v_p, cf_v))):
            refs_c = encoder_jax.gather_refs(rec_p, cxs, cys, 8)
            prc = intra_ops.predict_intra(refs_c, modes[:, None], 3,
                                          is_luma=False)[:, 0]
            oc = encoder_jax._extract_blocks(orig_p, cxs, cys, 8)
            lvc, recc, cbc = encoder_jax._code_blocks(
                oc, prc, qp_c, 3, intra_slice=True, sbh=sbh, rdoq=rdoq)
            rec_p = scatter(rec_p, recc, cxs, cys, 8, sel)
            cf_p = scatter(cf_p, lvc, cxs, cys, 8, sel)
            if comp == 0:
                rec_u_p, cf_u = rec_p, cf_p
                cb_u = cb_u.at[tgt].set(cbc, mode="drop")
            else:
                rec_v_p, cf_v = rec_p, cf_p
                cb_v = cb_v.at[tgt].set(cbc, mode="drop")
        return (rec_y_p, rec_u_p, rec_v_p, cf_y, cf_u, cf_v,
                (cb_y, cb_u, cb_v))

    has_intra = jnp.any(use_intra)
    init = (rec_y_pl, rec_u_pl, rec_v_pl, coef_y, coef_u, coef_v,
            (jnp.where(is_inter, cbf_y, False),
             jnp.where(is_inter, cbf_u, False),
             jnp.where(is_inter, cbf_v, False)))
    st = jax.lax.cond(
        has_intra,
        lambda s: jax.lax.fori_loop(0, steps, body, s),
        lambda s: s, init)
    rec_y_pl, rec_u_pl, rec_v_pl, coef_y, coef_u, coef_v, cb_maps = st
    cbf_y, cbf_u, cbf_v = cb_maps

    # ---- 5. deblock with BS maps (twin of inter_codec.compute_bs_maps) --
    pm = pred_mode.reshape(bh, bw)
    cby = cbf_y.reshape(bh, bw)
    mx = fin_mvx.reshape(bh, bw)
    my = fin_mvy.reshape(bh, bw)
    rpoc = ref_pocs[fin_ref].reshape(bh, bw)

    def bs_pair(a_intra, b_intra, a_cbf, b_cbf, amx, bmx, amy, bmy,
                arp, brp):
        intra2 = a_intra | b_intra
        one = a_cbf | b_cbf | (arp != brp) | (jnp.abs(amx - bmx) >= 4) | \
            (jnp.abs(amy - bmy) >= 4)
        return jnp.where(intra2, 2, jnp.where(one, 1, 0)).astype(jnp.int32)

    ii = pm == MODE_INTRA
    bs_ver = bs_pair(ii[:, :-1], ii[:, 1:], cby[:, :-1], cby[:, 1:],
                     mx[:, :-1], mx[:, 1:], my[:, :-1], my[:, 1:],
                     rpoc[:, :-1], rpoc[:, 1:]).T
    bs_hor = bs_pair(ii[:-1, :], ii[1:, :], cby[:-1, :], cby[1:, :],
                     mx[:-1, :], mx[1:, :], my[:-1, :], my[1:, :],
                     rpoc[:-1, :], rpoc[1:, :])
    if deblock:
        rec_y_pl, rec_u_pl, rec_v_pl = deblock_ops.deblock_420_bs(
            rec_y_pl, rec_u_pl, rec_v_pl, qp, bs_ver, bs_hor, block=16)

    return dict(
        pred_mode=pred_mode.reshape(bh, bw).astype(jnp.int8),
        intra_mode=intra_modes.astype(jnp.int8),
        mvx=fin_mvx.reshape(bh, bw),
        mvy=fin_mvy.reshape(bh, bw),
        ref_idx=fin_ref.reshape(bh, bw).astype(jnp.int8),
        cbf_y=cbf_y.reshape(bh, bw),
        cbf_cb=cbf_u.reshape(bh, bw),
        cbf_cr=cbf_v.reshape(bh, bw),
        coef_y=jnp.clip(coef_y, -32768, 32767).astype(jnp.int16),
        coef_u=jnp.clip(coef_u, -32768, 32767).astype(jnp.int16),
        coef_v=jnp.clip(coef_v, -32768, 32767).astype(jnp.int16),
        rec_y=rec_y_pl.astype(jnp.uint8),
        rec_u=rec_u_pl.astype(jnp.uint8),
        rec_v=rec_v_pl.astype(jnp.uint8),
    )


# ---------------------------------------------------------------------------
# Phase 1b: the jitted B-frame pipeline (hierarchical-B / RA toolset:
# one reference per list, merge_cands=1, uni/bi per block)
# ---------------------------------------------------------------------------

def b_me_one(ref_y, cur, x0, y0, search_range: int, me_method: str,
             n: int = 16):
    """Per-list ME of one B picture against one reference: integer +
    half/quarter SATD refinement.  Module-level so the multichip dryrun
    can shard exactly this stage over the tile axis (__graft_entry__).

    Returns quarter-pel (mvx, mvy, satd), each [B]."""
    if me_method == "pyr":
        imx, imy = me_ops.pyramid_search(ref_y, cur, x0, y0, n,
                                         search_range)
        mvx, mvy = imx * 4, imy * 4
        mvx, mvy, _ = me_ops._refine(ref_y, cur, x0, y0, mvx, mvy, n, 2)
        return me_ops._refine(ref_y, cur, x0, y0, mvx, mvy, n, 1)
    return me_ops.motion_search(ref_y, cur, x0, y0, n, search_range,
                                me_method)


@functools.partial(
    jax.jit,
    static_argnames=("qp", "w", "h", "has_l1", "search_range", "sbh",
                     "rdoq", "me_method", "deblock", "allow_intra",
                     "merge_eval", "lam", "rqt", "cu8", "no_backward"))
def encode_b_frame_dev(y, u, v, ref0_y, ref0_u, ref0_v,
                       ref1_y, ref1_u, ref1_v,
                       qp: int, w: int, h: int, has_l1: bool,
                       search_range: int, sbh: bool, rdoq: bool,
                       me_method: str = "pyr", deblock: bool = True,
                       me_fields=None, allow_intra: bool = True,
                       merge_eval: str = "first",
                       lam: float | None = None, rqt: bool = False,
                       cu8: bool = False,
                       gx_blk0=None, pic_bw=None, tmvp_fields=None,
                       no_backward: bool = False):
    """One B (or anchor P) picture of the hierarchical/RA toolset, all
    pixel math on device.  Twin of bframe_codec._encode_b_frame's
    decision loop (SURVEY §3.1; HM TEncSearch bi-pred iteration :3567
    collapsed to best-uni averaging like the host path).

    me_fields: optional precomputed ME, [(mvx, mvy, satd)] per list —
    the dryrun path injects tile-sharded ME results here.

    gx_blk0/pic_bw (traced int32 scalars): when the caller runs this
    kernel on a halo-padded TILE of a larger picture, they give the
    global 16-block column of local column 0 and the global picture
    width in 16-blocks, so neighbor-availability masks and left-MV
    predictors follow PICTURE edges, not tile edges — the sharded
    result is then bit-identical to the unsharded one for every block
    in the tile interior (multichip dryrun pad->compute->crop).

    Multi-reference lists (TEncSearch predInterSearch ref_idx loop
    :2912): pass ref planes as [R, H, W] stacks — ME runs per (list,
    ref) and the cheapest ref (SATD + lambda*(mvd + ref_idx TR bins))
    wins per block; all downstream MC gathers use the per-block ref
    index.  2-D planes mean one reference per list (legacy callers)."""
    from video_codecs_tpu.models.hevc.intra_codec import chroma_qp

    bw, bh = w // 16, h // 16
    nb = bw * bh
    qp_c = chroma_qp(qp)
    x0 = jnp.tile(jnp.arange(bw, dtype=jnp.int32) * 16, bh)
    y0 = jnp.repeat(jnp.arange(bh, dtype=jnp.int32) * 16, bw)
    yi = y.astype(jnp.int32)
    ui = u.astype(jnp.int32)
    vi = v.astype(jnp.int32)
    cur = encoder_jax._extract_blocks(yi, x0, y0, 16)
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    sl = math.sqrt(lam)
    n_lists = 2 if has_l1 else 1

    def stack3(p):
        p = p.astype(jnp.int32)
        return p[None] if p.ndim == 2 else p

    refs_y = [stack3(ref0_y), stack3(ref1_y)]
    refs_u = [stack3(ref0_u), stack3(ref1_u)]
    refs_v = [stack3(ref0_v), stack3(ref1_v)]
    nrefs = [refs_y[0].shape[0], refs_y[1].shape[0]]

    # ---- ME per (list, ref); per-block best ref by cost ----
    mvs, satds, bits, ridxs = [], [], [], []
    for lx in range(n_lists):
        cand = []
        for r in range(nrefs[lx]):
            if me_fields is not None and r == 0:
                mvx, mvy, satd = me_fields[lx]
            else:
                mvx, mvy, satd = b_me_one(refs_y[lx][r], cur, x0, y0,
                                          search_range, me_method)
            gx = mvx.reshape(bh, bw)
            gy = mvy.reshape(bh, bw)
            px = jnp.concatenate([jnp.zeros((bh, 1), jnp.int32),
                                  gx[:, :-1]], axis=1).reshape(nb)
            py = jnp.concatenate([jnp.zeros((bh, 1), jnp.int32),
                                  gy[:, :-1]], axis=1).reshape(nb)
            if gx_blk0 is not None:
                gcol = gx_blk0 + jnp.tile(jnp.arange(bw, dtype=jnp.int32),
                                          bh)
                px = jnp.where(gcol == 0, 0, px)
                py = jnp.where(gcol == 0, 0, py)
            b = mvd_bits_dev(mvx - px, mvy - py) + (r + 1 if
                                                   nrefs[lx] > 1 else 0)
            cand.append((mvx, mvy, satd, b,
                         satd + jnp.round(sl * (7 + b)).astype(jnp.int32)))
        best = cand[0]
        ridx = jnp.zeros(nb, jnp.int32)
        for r in range(1, nrefs[lx]):
            better = cand[r][4] < best[4]
            best = tuple(jnp.where(better, n_, o_)
                         for n_, o_ in zip(cand[r], best))
            ridx = jnp.where(better, r, ridx)
        mvs.append((best[0], best[1]))
        satds.append(best[2])
        bits.append(best[3])
        ridxs.append(ridx)

    cost_uni = [satds[lx] + jnp.round(sl * (7 + bits[lx])).astype(jnp.int32)
                for lx in range(n_lists)]

    # bi hypothesis from the two best-uni MVs, then ONE alternating
    # refinement round per list: hold the other hypothesis fixed and
    # diamond-search +-1 quarter-pel on the bi-averaged SATD
    # (TEncSearch.cpp:3567 bi-pred iteration, collapsed to one pass)
    if has_l1:
        p0_14 = interp.mc_luma14_multi(refs_y[0], ridxs[0],
                                       x0, y0, mvs[0][0], mvs[0][1], 16)
        p1_14 = interp.mc_luma14_multi(refs_y[1], ridxs[1],
                                       x0, y0, mvs[1][0], mvs[1][1], 16)

        def bi_refine(fix14, refs_l, ridx_l, mvx, mvy):
            best = cost_ops.hadamard_satd_8x8(
                cur, interp.bi_average(
                    fix14, interp.mc_luma14_multi(
                        refs_l, ridx_l, x0, y0, mvx, mvy, 16)))
            for k in range(8):
                cx_ = mvx + int(me_ops._OFFS8[k][0])
                cy_ = mvy + int(me_ops._OFFS8[k][1])
                satd = cost_ops.hadamard_satd_8x8(
                    cur, interp.bi_average(
                        fix14, interp.mc_luma14_multi(
                            refs_l, ridx_l, x0, y0, cx_, cy_, 16)))
                better = satd < best
                best = jnp.where(better, satd, best)
                mvx = jnp.where(better, cx_, mvx)
                mvy = jnp.where(better, cy_, mvy)
            return mvx, mvy, best

        b1x, b1y, _ = bi_refine(p0_14, refs_y[1], ridxs[1],
                                mvs[1][0], mvs[1][1])
        p1r_14 = interp.mc_luma14_multi(refs_y[1], ridxs[1], x0, y0,
                                        b1x, b1y, 16)
        b0x, b0y, satd_bi = bi_refine(p1r_14, refs_y[0], ridxs[0],
                                      mvs[0][0], mvs[0][1])
        # rate estimate keeps the uni-based mvd bits (refinement moves
        # the MVs at most +-1 quarter step)
        cost_bi = satd_bi + jnp.round(
            sl * (8 + bits[0] + bits[1])).astype(jnp.int32)
        mvs_bi = ((b0x, b0y), (b1x, b1y))
    else:
        cost_bi = jnp.full(nb, 1 << 30, jnp.int32)
        mvs_bi = None

    # provisional field = best explicit hypothesis (for merge approx)
    if has_l1:
        best_uni_is0 = cost_uni[0] <= cost_uni[1]
        cost_uni_min = jnp.minimum(cost_uni[0], cost_uni[1])
        prov_dir = jnp.where(cost_bi < cost_uni_min, 3,
                             jnp.where(best_uni_is0, 1, 2))
        cost_expl = jnp.minimum(cost_bi, cost_uni_min)
    else:
        prov_dir = jnp.ones(nb, jnp.int32)
        cost_expl = cost_uni[0]
    if has_l1:
        is_bi = prov_dir == 3
        prov_mv0x = jnp.where(is_bi, mvs_bi[0][0], mvs[0][0])
        prov_mv0y = jnp.where(is_bi, mvs_bi[0][1], mvs[0][1])
        prov_mv1x = jnp.where(is_bi, mvs_bi[1][0], mvs[1][0])
        prov_mv1y = jnp.where(is_bi, mvs_bi[1][1], mvs[1][1])
        prov_r0 = ridxs[0]
        prov_r1 = ridxs[1]
    else:
        prov_mv0x, prov_mv0y = mvs[0]
        prov_r0 = ridxs[0]
        prov_mv1x = prov_mv1y = jnp.zeros(nb, jnp.int32)
        prov_r1 = jnp.zeros(nb, jnp.int32)

    # ---- merge approximation — twin of derive_merge ("first", flat
    # path: the host codes a single candidate, so only the first
    # available neighbor A1/B1 is codeable) or of the merge-5 list
    # ("best4", qt path: evaluate A1/B1/B0/B2 + zero with their
    # merge_idx rates and keep the cheapest; the host re-derives the
    # spec list per PU and codes the real index) ----
    def grid(a):
        return a.reshape(bh, bw)

    zr = jnp.zeros(nb, jnp.int32)
    fb_dir = 3 if has_l1 else 1

    def mrg_pred(dirs, m0x, m0y, m1x, m1y, r0=None, r1=None):
        p0 = interp.mc_luma14_multi(refs_y[0], zr if r0 is None else r0,
                                    x0, y0, m0x, m0y, 16)
        if not has_l1:
            return jnp.clip((p0 + 32) >> 6, 0, 255).astype(jnp.int32)
        p1 = interp.mc_luma14_multi(refs_y[1], zr if r1 is None else r1,
                                    x0, y0, m1x, m1y, 16)
        return jnp.where(
            (dirs == 3)[:, None, None], interp.bi_average(p0, p1),
            jnp.where((dirs == 1)[:, None, None],
                      jnp.clip((p0 + 32) >> 6, 0, 255),
                      jnp.clip((p1 + 32) >> 6, 0, 255))).astype(jnp.int32)

    if merge_eval == "best4":
        # candidate list approximation (A1, B1, B0, B2 [, TMVP], zero)
        mcands = []
        for dx, dy in ((-1, 0), (0, -1), (1, -1), (-1, -1)):
            ys_ = jnp.repeat(jnp.arange(bh), bw) + dy
            xs_ = jnp.tile(jnp.arange(bw), bh) + dx
            if gx_blk0 is not None:
                gxs = gx_blk0 + xs_
                ok = (ys_ >= 0) & (ys_ < bh) & (gxs >= 0) & \
                     (gxs < pic_bw) & ((dy < 0) | (dx < 0))
            else:
                ok = (ys_ >= 0) & (ys_ < bh) & (xs_ >= 0) & (xs_ < bw) & \
                     ((dy < 0) | (dx < 0))
            mcands.append(tuple(
                _shift_grid(grid(f), dx, dy, fill).reshape(nb)
                for f, fill in ((prov_dir, fb_dir), (prov_mv0x, 0),
                                (prov_mv0y, 0), (prov_mv1x, 0),
                                (prov_mv1y, 0), (prov_r0, 0),
                                (prov_r1, 0))) + (ok,))
        if tmvp_fields is not None:
            # temporal candidate approximation (spec 8.5.3.2.8-9 via the
            # compressed 16x16 collocated field): bottom-right col block
            # when inside the picture and the same CTB row, else center;
            # MV from the selected col list scaled to refIdx 0
            (cinter, c0x_, c0y_, c1x_, c1y_, cpf0, cpf1, crp0, crp1,
             cpoc, curpoc, tp0, tp1) = tmvp_fields
            cinter = cinter.reshape(nb)
            c0x_, c0y_ = c0x_.reshape(nb), c0y_.reshape(nb)
            c1x_, c1y_ = c1x_.reshape(nb), c1y_.reshape(nb)
            cpf0, cpf1 = cpf0.reshape(nb), cpf1.reshape(nb)
            crp0, crp1 = crp0.reshape(nb), crp1.reshape(nb)
            by_i = jnp.repeat(jnp.arange(bh), bw)
            bx_i = jnp.tile(jnp.arange(bw), bh)
            use_br = ((bx_i + 1 < bw) & (by_i + 1 < bh) &
                      ((by_i % 2) == 0) &
                      _shift_grid(grid(cinter), 1, 1, False).reshape(nb))

            def pick(f, fill=0):
                return jnp.where(use_br,
                                 _shift_grid(grid(f), 1, 1, fill)
                                 .reshape(nb), f)

            a_int = pick(cinter, False)
            a0x, a0y = pick(c0x_), pick(c0y_)
            a1x, a1y = pick(c1x_), pick(c1y_)
            a_pf0, a_pf1 = pick(cpf0, False), pick(cpf1, False)
            a_rp0, a_rp1 = pick(crp0), pick(crp1)
            # listCol: L1 if col has no L0, L0 if no L1; else the
            # no-backward/collocated_from_l0 rule (col list 1 here)
            tmv = []
            for lx, tpoc in ((0, tp0), (1, tp1)):
                fixed_col = lx if no_backward else 0  # col_from_l0=0
                lcol = jnp.where(~a_pf0, 1, jnp.where(~a_pf1, 0,
                                                      fixed_col))
                cmx = jnp.where(lcol == 0, a0x, a1x)
                cmy = jnp.where(lcol == 0, a0y, a1y)
                crp = jnp.where(lcol == 0, a_rp0, a_rp1)
                sx, sy = scale_mv_dev(cmx, cmy, curpoc - tpoc,
                                      cpoc - crp)
                tmv.append((sx, sy))
            t_dir = jnp.where(a_int, fb_dir, 0)
            mcands.append((t_dir, tmv[0][0], tmv[0][1],
                           tmv[1][0], tmv[1][1], zr, zr,
                           a_int & (t_dir > 0)))
        mcands.append((jnp.full(nb, fb_dir, jnp.int32), zr, zr, zr, zr,
                       zr, zr, jnp.ones(nb, bool)))
        cost_mrg = jnp.full(nb, 1 << 30, jnp.int32)
        mrg_dir = jnp.full(nb, fb_dir, jnp.int32)
        mrg_mv0x = mrg_mv0y = mrg_mv1x = mrg_mv1y = zr
        mrg_r0 = mrg_r1 = zr
        for idx, (cd, c0x, c0y, c1x, c1y, cr0, cr1, ok) in \
                enumerate(mcands):
            pred = mrg_pred(cd, c0x, c0y, c1x, c1y, cr0, cr1)
            c = cost_ops.hadamard_satd_8x8(cur, pred) + jnp.round(
                sl * (2 + idx)).astype(jnp.int32)
            c = jnp.where(ok, c, INF)
            better = c < cost_mrg
            cost_mrg = jnp.where(better, c, cost_mrg)
            mrg_dir = jnp.where(better, cd, mrg_dir)
            mrg_mv0x = jnp.where(better, c0x, mrg_mv0x)
            mrg_mv0y = jnp.where(better, c0y, mrg_mv0y)
            mrg_mv1x = jnp.where(better, c1x, mrg_mv1x)
            mrg_mv1y = jnp.where(better, c1y, mrg_mv1y)
            mrg_r0 = jnp.where(better, cr0, mrg_r0)
            mrg_r1 = jnp.where(better, cr1, mrg_r1)
    else:
        def pick(field, fallback):
            left = _shift_grid(grid(field), -1, 0, 0)
            above = _shift_grid(grid(field), 0, -1, 0)
            bx_i = jnp.tile(jnp.arange(bw), bh).reshape(bh, bw)
            by_i = jnp.repeat(jnp.arange(bh), bw).reshape(bh, bw)
            out = jnp.where(bx_i > 0, left,
                            jnp.where(by_i > 0, above, fallback))
            return out.reshape(nb)

        mrg_dir = pick(prov_dir, fb_dir)
        mrg_mv0x = pick(prov_mv0x, 0)
        mrg_mv0y = pick(prov_mv0y, 0)
        mrg_mv1x = pick(prov_mv1x, 0)
        mrg_mv1y = pick(prov_mv1y, 0)
        mrg_r0 = pick(prov_r0, 0)
        mrg_r1 = pick(prov_r1, 0)
        # fallback blocks carry zero MVs
        bx_f = jnp.tile(jnp.arange(bw), bh)
        by_f = jnp.repeat(jnp.arange(bh), bw)
        is_fb = (bx_f == 0) & (by_f == 0)
        mrg_mv0x = jnp.where(is_fb, 0, mrg_mv0x)
        mrg_mv0y = jnp.where(is_fb, 0, mrg_mv0y)
        mrg_mv1x = jnp.where(is_fb, 0, mrg_mv1x)
        mrg_mv1y = jnp.where(is_fb, 0, mrg_mv1y)
        mrg_r0 = jnp.where(is_fb, 0, mrg_r0)
        mrg_r1 = jnp.where(is_fb, 0, mrg_r1)
        mrg_dir = jnp.where(is_fb, fb_dir, mrg_dir)
        pred_mrg = mrg_pred(mrg_dir, mrg_mv0x, mrg_mv0y, mrg_mv1x,
                            mrg_mv1y, mrg_r0, mrg_r1)
        cost_mrg = cost_ops.hadamard_satd_8x8(cur, pred_mrg) + jnp.round(
            sl * 2).astype(jnp.int32)

    # ---- intra candidate ----
    intra_modes = encoder_jax.decide_modes_device(yi, qp, bw, bh)
    refs_o = encoder_jax.gather_refs(yi, x0, y0, 16)
    pred_i = intra_ops.predict_intra(
        refs_o, intra_modes.reshape(nb)[:, None], 4)[:, 0]
    cost_intra = cost_ops.hadamard_satd_8x8(cur, pred_i) + \
        jnp.round(sl * 9).astype(jnp.int32)
    if not allow_intra:     # CTB32 qt path: z-scan intra availability
        cost_intra = jnp.full(nb, 1 << 30, jnp.int32)

    # ---- decision (host tie-break order) ----
    use_intra = cost_intra <= jnp.minimum(cost_mrg, cost_expl)
    use_mrg = (~use_intra) & (cost_mrg <= cost_expl)
    fin_dir = jnp.where(use_mrg, mrg_dir, prov_dir)
    fin_mv0x = jnp.where(use_mrg, mrg_mv0x, prov_mv0x)
    fin_mv0y = jnp.where(use_mrg, mrg_mv0y, prov_mv0y)
    fin_mv1x = jnp.where(use_mrg, mrg_mv1x, prov_mv1x)
    fin_mv1y = jnp.where(use_mrg, mrg_mv1y, prov_mv1y)
    fin_r0 = jnp.where(use_mrg, mrg_r0, prov_r0)
    fin_r1 = jnp.where(use_mrg, mrg_r1, prov_r1)
    pred_mode = jnp.where(use_intra, MODE_INTRA, MODE_INTER)

    # ---- final MC + residual ----
    def final_pred(refs0, refs1, xs, ys, n, mv0, mv1, mc14):
        q0 = mc14(refs0, fin_r0, xs, ys, mv0[0], mv0[1], n)
        if has_l1:
            q1 = mc14(refs1, fin_r1, xs, ys, mv1[0], mv1[1], n)
            return jnp.where(
                (fin_dir == 3)[:, None, None], interp.bi_average(q0, q1),
                jnp.where((fin_dir == 1)[:, None, None],
                          jnp.clip((q0 + 32) >> 6, 0, 255),
                          jnp.clip((q1 + 32) >> 6, 0, 255))) \
                .astype(jnp.int32)
        return jnp.clip((q0 + 32) >> 6, 0, 255).astype(jnp.int32)

    pred_y_fin = final_pred(refs_y[0], refs_y[1] if has_l1 else refs_y[0],
                            x0, y0, 16, (fin_mv0x, fin_mv0y),
                            (fin_mv1x, fin_mv1y), interp.mc_luma14_multi)
    lv_y, rec_blk, cbf_y, bits_y = encoder_jax._code_blocks_rate(
        cur, pred_y_fin, qp, 4, sbh=sbh,
        rdoq="full" if rdoq else rdoq, lam=lam)

    cx0, cy0 = x0 // 2, y0 // 2
    cur_u = encoder_jax._extract_blocks(ui, cx0, cy0, 8)
    cur_v = encoder_jax._extract_blocks(vi, cx0, cy0, 8)
    r0u, r0v = refs_u[0], refs_v[0]
    r1u, r1v = refs_u[1], refs_v[1]
    pred_u = final_pred(r0u, r1u, cx0, cy0, 8, (fin_mv0x, fin_mv0y),
                        (fin_mv1x, fin_mv1y), interp.mc_chroma14_multi)
    pred_v = final_pred(r0v, r1v, cx0, cy0, 8, (fin_mv0x, fin_mv0y),
                        (fin_mv1x, fin_mv1y), interp.mc_chroma14_multi)
    lv_u, rec_u_blk, cbf_u, bits_u = encoder_jax._code_blocks_rate(
        cur_u, pred_u, qp_c, 3, sbh=sbh,
        rdoq="full" if rdoq else rdoq, is_luma=False, lam=lam)
    lv_v, rec_v_blk, cbf_v, bits_v = encoder_jax._code_blocks_rate(
        cur_v, pred_v, qp_c, 3, sbh=sbh,
        rdoq="full" if rdoq else rdoq, is_luma=False, lam=lam)
    coef_bits = (bits_y + bits_u + bits_v).reshape(bh, bw)
    tusplit = jnp.zeros(nb, bool)
    cbf_y8 = jnp.zeros((2 * bh, 2 * bw), bool)
    cbf_cb4 = jnp.zeros((2 * bh, 2 * bw), bool)
    cbf_cr4 = jnp.zeros((2 * bh, 2 * bw), bool)

    if rqt:
        # ---- encoder-side RQT depth 1: try TU16 -> 4x TU8 (luma) with
        # 4x4 chroma, keep the RD-cheaper transform tree per block
        # (TEncSearch xEstimateInterResidualQT) ----
        def to4(a, n):
            g = a.shape[0]
            return (a.reshape(g, 2, n, 2, n).transpose(0, 1, 3, 2, 4)
                    .reshape(g * 4, n, n))

        def from4(a, n):
            g = a.shape[0] // 4
            return (a.reshape(g, 2, 2, n, n).transpose(0, 1, 3, 2, 4)
                    .reshape(g, 2 * n, 2 * n))

        rd = "full" if rdoq else rdoq
        lv8, rec8, cbf8, b8 = encoder_jax._code_blocks_rate(
            to4(cur, 8), to4(pred_y_fin, 8), qp, 3, sbh=sbh, rdoq=rd,
            lam=lam)
        lv4u, rec4u, cbf4u, b4u = encoder_jax._code_blocks_rate(
            to4(cur_u, 4), to4(pred_u, 4), qp_c, 2, sbh=sbh, rdoq=rd,
            is_luma=False, lam=lam)
        lv4v, rec4v, cbf4v, b4v = encoder_jax._code_blocks_rate(
            to4(cur_v, 4), to4(pred_v, 4), qp_c, 2, sbh=sbh, rdoq=rd,
            is_luma=False, lam=lam)

        def persum(a):
            return jnp.sum(a.reshape(-1, 4), axis=1)

        def sse(a, b):
            return jnp.sum((a - b).astype(jnp.float32) ** 2,
                           axis=(-2, -1))

        d16 = sse(cur, rec_blk) + sse(cur_u, rec_u_blk) +             sse(cur_v, rec_v_blk)
        d8 = persum(sse(to4(cur, 8), rec8) + sse(to4(cur_u, 4), rec4u) +
                    sse(to4(cur_v, 4), rec4v))
        lamf = jnp.float32(lam)
        # split overhead: ~6 extra cbf/split bins vs the unsplit tree
        j16 = d16 + lamf * (bits_y + bits_u + bits_v + 1.0)
        j8 = d8 + lamf * (persum(b8) + persum(b4u) + persum(b4v) + 7.0)
        tusplit = (j8 < j16) & (pred_mode == MODE_INTER)

        sel = tusplit[:, None, None]
        lv_y = jnp.where(sel, from4(lv8, 8), lv_y)
        rec_blk = jnp.where(sel, from4(rec8, 8), rec_blk)
        lv_u = jnp.where(sel, from4(lv4u, 4), lv_u)
        rec_u_blk = jnp.where(sel, from4(rec4u, 4), rec_u_blk)
        lv_v = jnp.where(sel, from4(lv4v, 4), lv_v)
        rec_v_blk = jnp.where(sel, from4(rec4v, 4), rec_v_blk)
        cbf_y = jnp.where(tusplit, jnp.any(cbf8.reshape(-1, 4), axis=1),
                          cbf_y)
        cbf_u = jnp.where(tusplit, jnp.any(cbf4u.reshape(-1, 4), axis=1),
                          cbf_u)
        cbf_v = jnp.where(tusplit, jnp.any(cbf4v.reshape(-1, 4), axis=1),
                          cbf_v)
        coef_bits = jnp.where(
            tusplit, persum(b8) + persum(b4u) + persum(b4v),
            bits_y + bits_u + bits_v).reshape(bh, bw)

        # sub-TU cbf maps on the 8x8 grid (z order within each block)
        def submap(c4):
            g = c4.reshape(bh, bw, 2, 2)
            f = jnp.zeros((2 * bh, 2 * bw), bool)
            for dy in (0, 1):
                for dx in (0, 1):
                    f = f.at[dy::2, dx::2].set(g[:, :, dy, dx])
            return f

        cbf_y8 = submap(cbf8)
        cbf_cb4 = submap(cbf4u)
        cbf_cr4 = submap(cbf4v)

    # ---- CU8 split: each 16x16 may split into 4 CU8s with their own
    # motion (TEncCu xCompressCU depth recursion to 8x8, TEncSearch
    # predInterSearch per 8x8 PU).  Device decision: per-8 ME/bi
    # hypothesis, TU8+4x4-chroma residual with exact RDOQ rates, then
    # J(4 children + split overhead) vs J(single 16 PU). ----
    split8 = jnp.zeros(nb, bool)
    bw8, bh8 = 2 * bw, 2 * bh
    nb8 = bw8 * bh8
    dir8_m = jnp.zeros((bh8, bw8), jnp.int32)
    mv0x8_m = jnp.zeros((bh8, bw8), jnp.int32)
    mv0y8_m = jnp.zeros((bh8, bw8), jnp.int32)
    mv1x8_m = jnp.zeros((bh8, bw8), jnp.int32)
    mv1y8_m = jnp.zeros((bh8, bw8), jnp.int32)
    r0_8m = jnp.zeros((bh8, bw8), jnp.int32)
    r1_8m = jnp.zeros((bh8, bw8), jnp.int32)
    if cu8:
        x8 = jnp.tile(jnp.arange(bw8, dtype=jnp.int32) * 8, bh8)
        y8 = jnp.repeat(jnp.arange(bh8, dtype=jnp.int32) * 8, bw8)
        cur8 = encoder_jax._extract_blocks(yi, x8, y8, 8)
        mvs8, bits8, ridxs8 = [], [], []
        cost_uni8 = []
        for lx in range(n_lists):
            cand8 = []
            for r in range(nrefs[lx]):
                m8x, m8y, s8 = b_me_one(refs_y[lx][r], cur8, x8, y8,
                                        search_range, me_method, n=8)
                g8x = m8x.reshape(bh8, bw8)
                g8y = m8y.reshape(bh8, bw8)
                p8x = jnp.concatenate([jnp.zeros((bh8, 1), jnp.int32),
                                       g8x[:, :-1]], axis=1).reshape(nb8)
                p8y = jnp.concatenate([jnp.zeros((bh8, 1), jnp.int32),
                                       g8y[:, :-1]], axis=1).reshape(nb8)
                if gx_blk0 is not None:
                    gcol8 = 2 * gx_blk0 + jnp.tile(
                        jnp.arange(bw8, dtype=jnp.int32), bh8)
                    p8x = jnp.where(gcol8 == 0, 0, p8x)
                    p8y = jnp.where(gcol8 == 0, 0, p8y)
                b8 = mvd_bits_dev(m8x - p8x, m8y - p8y) + \
                    (r + 1 if nrefs[lx] > 1 else 0)
                cand8.append((m8x, m8y, s8, b8,
                              s8 + jnp.round(sl * (5 + b8))
                              .astype(jnp.int32)))
            best8 = cand8[0]
            ridx8 = jnp.zeros(nb8, jnp.int32)
            for r in range(1, nrefs[lx]):
                better = cand8[r][4] < best8[4]
                best8 = tuple(jnp.where(better, n_, o_)
                              for n_, o_ in zip(cand8[r], best8))
                ridx8 = jnp.where(better, r, ridx8)
            mvs8.append((best8[0], best8[1]))
            bits8.append(best8[3])
            ridxs8.append(ridx8)
            cost_uni8.append(best8[4])
        zr8 = jnp.zeros(nb8, jnp.int32)
        if has_l1:
            q0 = interp.mc_luma14_multi(refs_y[0], ridxs8[0], x8, y8,
                                        mvs8[0][0], mvs8[0][1], 8)
            q1 = interp.mc_luma14_multi(refs_y[1], ridxs8[1], x8, y8,
                                        mvs8[1][0], mvs8[1][1], 8)
            cost_bi8 = cost_ops.hadamard_satd_8x8(
                cur8, interp.bi_average(q0, q1)) + jnp.round(
                sl * (6 + bits8[0] + bits8[1])).astype(jnp.int32)
            uni0 = cost_uni8[0] <= cost_uni8[1]
            uni_min = jnp.minimum(cost_uni8[0], cost_uni8[1])
            dir8 = jnp.where(cost_bi8 < uni_min, 3,
                             jnp.where(uni0, 1, 2))
            mvr8 = jnp.where(dir8 == 3,
                             bits8[0] + bits8[1] + 6,
                             jnp.where(dir8 == 1, bits8[0], bits8[1]) + 5)
            m1x8, m1y8 = mvs8[1]
        else:
            dir8 = jnp.ones(nb8, jnp.int32)
            mvr8 = bits8[0] + 5
            m1x8 = m1y8 = zr8
        m0x8, m0y8 = mvs8[0]

        r0_8 = ridxs8[0]
        r1_8 = ridxs8[1] if has_l1 else zr8

        def pred8(refs, xs, ys, n, mv0, mv1, mc14):
            q0 = mc14(refs[0], r0_8, xs, ys, mv0[0], mv0[1], n)
            if not has_l1:
                return jnp.clip((q0 + 32) >> 6, 0, 255).astype(jnp.int32)
            q1 = mc14(refs[1], r1_8, xs, ys, mv1[0], mv1[1], n)
            return jnp.where(
                (dir8 == 3)[:, None, None], interp.bi_average(q0, q1),
                jnp.where((dir8 == 1)[:, None, None],
                          jnp.clip((q0 + 32) >> 6, 0, 255),
                          jnp.clip((q1 + 32) >> 6, 0, 255))) \
                .astype(jnp.int32)

        pred8_y = pred8(refs_y, x8, y8, 8, (m0x8, m0y8), (m1x8, m1y8),
                        interp.mc_luma14_multi)
        cx8, cy8 = x8 // 2, y8 // 2
        cur4u = encoder_jax._extract_blocks(ui, cx8, cy8, 4)
        cur4v = encoder_jax._extract_blocks(vi, cx8, cy8, 4)
        pred4u = pred8((r0u, r1u), cx8, cy8, 4, (m0x8, m0y8),
                       (m1x8, m1y8), interp.mc_chroma14_multi)
        pred4v = pred8((r0v, r1v), cx8, cy8, 4, (m0x8, m0y8),
                       (m1x8, m1y8), interp.mc_chroma14_multi)
        rd8 = "full" if rdoq else rdoq
        lv8y, rec8y, cbf8y, rb8y = encoder_jax._code_blocks_rate(
            cur8, pred8_y, qp, 3, sbh=sbh, rdoq=rd8, lam=lam)
        lv4u8, rec4u8, cbf4u8, rb4u = encoder_jax._code_blocks_rate(
            cur4u, pred4u, qp_c, 2, sbh=sbh, rdoq=rd8, is_luma=False,
            lam=lam)
        lv4v8, rec4v8, cbf4v8, rb4v = encoder_jax._code_blocks_rate(
            cur4v, pred4v, qp_c, 2, sbh=sbh, rdoq=rd8, is_luma=False,
            lam=lam)

        def ssef(a, b):
            return jnp.sum((a - b).astype(jnp.float32) ** 2,
                           axis=(-2, -1))

        lamf = jnp.float32(lam)
        d8 = ssef(cur8, rec8y) + ssef(cur4u, rec4u8) + ssef(cur4v, rec4v8)
        # per-CU8 syntax: skip/pred/part/merge + cbf bins ~ 7
        j8 = d8 + lamf * (rb8y + rb4u + rb4v + mvr8.astype(jnp.float32)
                          + 7.0)

        def sum16(a8):
            """[bh8*bw8] child values -> per-16 sums [nb]."""
            g = a8.reshape(bh, 2, bw, 2)
            return jnp.sum(g, axis=(1, 3)).reshape(nb)

        # J of the single-PU 16 alternative: coded distortion + coef
        # rate + its mv/mode rate
        d16f = (ssef(cur, rec_blk) + ssef(cur_u, rec_u_blk) +
                ssef(cur_v, rec_v_blk))
        if has_l1:
            rate16 = jnp.where(
                fin_dir == 3, (bits[0] + bits[1] + 8).astype(jnp.float32),
                (jnp.where(fin_dir == 1, bits[0], bits[1]) + 7)
                .astype(jnp.float32))
        else:
            rate16 = (bits[0] + 7).astype(jnp.float32)
        rate16 = jnp.where(use_mrg, 4.0, rate16)
        j16 = d16f + lamf * (coef_bits.reshape(nb) + rate16 + 5.0)
        j8sum = sum16(j8) + lamf * 1.0            # split_cu_flag
        split8 = (j8sum < j16) & (pred_mode == MODE_INTER)

        # update per-16 outputs for split blocks
        s8g = split8.reshape(bh, bw)
        sel8 = s8g[y8 // 16, x8 // 16]            # [nb8] child mask

        def any16(c8):
            g = c8.reshape(bh, 2, bw, 2)
            return jnp.any(g, axis=(1, 3)).reshape(nb)

        cbf_y = jnp.where(split8, any16(cbf8y), cbf_y)
        cbf_u = jnp.where(split8, any16(cbf4u8), cbf_u)
        cbf_v = jnp.where(split8, any16(cbf4v8), cbf_v)
        coef_bits = jnp.where(
            s8g, sum16(rb8y + rb4u + rb4v).reshape(bh, bw), coef_bits)
        tusplit = tusplit & ~split8
        # per-8 cbf/motion maps (z-order-free: plain raster 8 grid)
        cbf_y8 = jnp.where(s8g.repeat(2, 0).repeat(2, 1),
                           cbf8y.reshape(bh8, bw8), cbf_y8)
        cbf_cb4 = jnp.where(s8g.repeat(2, 0).repeat(2, 1),
                            cbf4u8.reshape(bh8, bw8), cbf_cb4)
        cbf_cr4 = jnp.where(s8g.repeat(2, 0).repeat(2, 1),
                            cbf4v8.reshape(bh8, bw8), cbf_cr4)
        dir8_m = dir8.reshape(bh8, bw8)
        mv0x8_m = m0x8.reshape(bh8, bw8)
        mv0y8_m = m0y8.reshape(bh8, bw8)
        mv1x8_m = m1x8.reshape(bh8, bw8)
        mv1y8_m = m1y8.reshape(bh8, bw8)
        r0_8m = r0_8.reshape(bh8, bw8)
        r1_8m = r1_8.reshape(bh8, bw8)

    is_inter = pred_mode == MODE_INTER
    rec_y_pl = _scatter_blocks(jnp.zeros((h, w), jnp.int32), rec_blk, x0,
                               y0, 16, is_inter)
    rec_u_pl = _scatter_blocks(jnp.zeros((h // 2, w // 2), jnp.int32),
                               rec_u_blk, cx0, cy0, 8, is_inter)
    rec_v_pl = _scatter_blocks(jnp.zeros((h // 2, w // 2), jnp.int32),
                               rec_v_blk, cx0, cy0, 8, is_inter)
    coef_y = _scatter_blocks(jnp.zeros((h, w), jnp.int32), lv_y, x0, y0,
                             16, is_inter)
    coef_u = _scatter_blocks(jnp.zeros((h // 2, w // 2), jnp.int32), lv_u,
                             cx0, cy0, 8, is_inter)
    coef_v = _scatter_blocks(jnp.zeros((h // 2, w // 2), jnp.int32), lv_v,
                             cx0, cy0, 8, is_inter)
    if cu8:
        # overwrite split-CU8 regions with the per-8 coded result
        rec_y_pl = _scatter_blocks(rec_y_pl, rec8y, x8, y8, 8, sel8)
        rec_u_pl = _scatter_blocks(rec_u_pl, rec4u8, cx8, cy8, 4, sel8)
        rec_v_pl = _scatter_blocks(rec_v_pl, rec4v8, cx8, cy8, 4, sel8)
        coef_y = _scatter_blocks(coef_y, lv8y, x8, y8, 8, sel8)
        coef_u = _scatter_blocks(coef_u, lv4u8, cx8, cy8, 4, sel8)
        coef_v = _scatter_blocks(coef_v, lv4v8, cx8, cy8, 4, sel8)

    planes, cbfs = _intra_wavefront(
        yi, ui, vi, use_intra.reshape(bh, bw), intra_modes,
        (rec_y_pl, rec_u_pl, rec_v_pl, coef_y, coef_u, coef_v),
        (jnp.where(is_inter, cbf_y, False),
         jnp.where(is_inter, cbf_u, False),
         jnp.where(is_inter, cbf_v, False)),
        qp, qp_c, sbh, rdoq, bw, bh)
    rec_y_pl, rec_u_pl, rec_v_pl, coef_y, coef_u, coef_v = planes
    cbf_y, cbf_u, cbf_v = cbfs

    # ---- BS maps (twin of bframe_codec._bs_maps_b) + deblock ----
    pm = pred_mode.reshape(bh, bw)
    cby = cbf_y.reshape(bh, bw)
    dirg = fin_dir.reshape(bh, bw)
    m0x = fin_mv0x.reshape(bh, bw)
    m0y = fin_mv0y.reshape(bh, bw)
    m1x = fin_mv1x.reshape(bh, bw)
    m1y = fin_mv1y.reshape(bh, bw)

    def bs_pair(sl_a, sl_b):
        a_i = (pm == MODE_INTRA)[sl_a]
        b_i = (pm == MODE_INTRA)[sl_b]
        intra2 = a_i | b_i
        diff_dir = dirg[sl_a] != dirg[sl_b]
        d0 = (jnp.abs(m0x[sl_a] - m0x[sl_b]) >= 4) | \
             (jnp.abs(m0y[sl_a] - m0y[sl_b]) >= 4)
        d1 = (jnp.abs(m1x[sl_a] - m1x[sl_b]) >= 4) | \
             (jnp.abs(m1y[sl_a] - m1y[sl_b]) >= 4)
        use0 = (dirg[sl_a] & 1) > 0
        mv_diff = jnp.where(dirg[sl_a] == 3, d0 | d1,
                            jnp.where(use0, d0, d1))
        one = cby[sl_a] | cby[sl_b] | diff_dir | mv_diff
        return jnp.where(intra2, 2,
                         jnp.where(one, 1, 0)).astype(jnp.int32)

    bs_ver = bs_pair(np.s_[:, :-1], np.s_[:, 1:]).T
    bs_hor = bs_pair(np.s_[:-1, :], np.s_[1:, :])
    if deblock:
        rec_y_pl, rec_u_pl, rec_v_pl = deblock_ops.deblock_420_bs(
            rec_y_pl, rec_u_pl, rec_v_pl, qp, bs_ver, bs_hor, block=16)

    return dict(
        pred_mode=pred_mode.reshape(bh, bw).astype(jnp.int8),
        intra_mode=intra_modes.astype(jnp.int8),
        inter_dir=fin_dir.reshape(bh, bw).astype(jnp.int8),
        mv0x=m0x, mv0y=m0y, mv1x=m1x, mv1y=m1y,
        cbf_y=cby, cbf_cb=cbf_u.reshape(bh, bw),
        cbf_cr=cbf_v.reshape(bh, bw),
        coef_bits=coef_bits,
        tusplit=tusplit.reshape(bh, bw),
        split8=split8.reshape(bh, bw),
        dir8=dir8_m.astype(jnp.int8),
        mv0x8=mv0x8_m, mv0y8=mv0y8_m, mv1x8=mv1x8_m, mv1y8=mv1y8_m,
        r0_8=r0_8m.astype(jnp.int8), r1_8=r1_8m.astype(jnp.int8),
        ref0_idx=fin_r0.reshape(bh, bw).astype(jnp.int8),
        ref1_idx=fin_r1.reshape(bh, bw).astype(jnp.int8),
        cbf_y8=cbf_y8, cbf_cb4=cbf_cb4, cbf_cr4=cbf_cr4,
        coef_y=jnp.clip(coef_y, -32768, 32767).astype(jnp.int16),
        coef_u=jnp.clip(coef_u, -32768, 32767).astype(jnp.int16),
        coef_v=jnp.clip(coef_v, -32768, 32767).astype(jnp.int16),
        rec_y=rec_y_pl.astype(jnp.uint8),
        rec_u=rec_u_pl.astype(jnp.uint8),
        rec_v=rec_v_pl.astype(jnp.uint8),
    )


# ---------------------------------------------------------------------------
# Phase 2: host reconciliation + CABAC (reuses the LowDelayEncoder
# serializer so the toolset/bitstream stays identical to the host path)
# ---------------------------------------------------------------------------

class DeviceLowDelayEncoder(pc.LowDelayEncoder):
    """LD-P encoder whose per-picture pixel pipeline runs on the device.

    Same bitstream toolset as LowDelayEncoder (CTB=CU=PU=16, multi-ref,
    merge, TMVP, SAO); decisions are made on device, so streams differ
    from the host encoder's but decode in the same decoders.
    """

    #: HM encoder_lowdelay_P_main.cfg GOP-4 ladder: (QPoffset, QPfactor)
    LD_GOP = ((5, 0.4624), (4, 0.4624), (5, 0.4624), (1, 0.578))

    def __init__(self, cfg, search_range: int = 64,
                 me_method: str = "pyr", ld_ladder: bool = True) -> None:
        super().__init__(cfg, search_range, me_method)
        assert not cfg.weighted_pred, "device path: WP later"
        assert not cfg.cu_qp_delta, "device path: CTU-RC later"
        self.ld_ladder = ld_ladder

    def encode_sequence_ldp(self, frames, rate_control=None):
        """Apply HM's LD-P QP/lambda ladder (QPoffset cycle 5,4,5,1 with
        per-entry QPFactor, TEncSlice setUpLambda) unless a rate
        controller drives QP."""
        if rate_control is not None or not self.ld_ladder:
            return super().encode_sequence_ldp(frames, rate_control)
        base = self.cfg.qp
        gop = self.LD_GOP

        def sched(poc):
            if poc == 0:
                return base
            return base + gop[(poc - 1) % len(gop)][0]

        self.qp_schedule = sched
        try:
            return super().encode_sequence_ldp(frames, rate_control)
        finally:
            self.qp_schedule = None
            self.cfg.qp = base

    def _ld_lambda(self, poc):
        if getattr(self, "qp_schedule", None) is None:
            return None
        off, fac = self.LD_GOP[(poc - 1) % len(self.LD_GOP)]
        return hm_lambda(self.cfg.qp, fac, 1 if off > 1 else 0)

    def encode_p_frame(self, y, u, v, dpb, poc):
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        refs = dpb[:cfg.num_refs]
        n_refs = len(refs)
        ref_pocs = [p for (p, _, _) in refs]
        refs_y = jnp.asarray(np.stack([pl[0] for (_, pl, _) in refs])
                             .astype(np.int32))
        refs_u = jnp.asarray(np.stack([pl[1] for (_, pl, _) in refs])
                             .astype(np.int32))
        refs_v = jnp.asarray(np.stack([pl[2] for (_, pl, _) in refs])
                             .astype(np.int32))
        col = refs[0][2] if cfg.temporal_mvp else None
        if col is None:
            col_inter = np.zeros((bh, bw), bool)
            col_mv = np.zeros((bh, bw, 2), np.int32)
            col_refpoc = np.zeros((bh, bw), np.int32)
            col_poc = 0
        else:
            col_inter, col_mv, col_refpoc, col_poc = (
                col.inter, col.mv, col.ref_poc, col.poc)

        st = encode_p_frame_dev(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
            refs_y, refs_u, refs_v,
            jnp.asarray(col_inter), jnp.asarray(col_mv[..., 0]),
            jnp.asarray(col_mv[..., 1]), jnp.asarray(col_refpoc),
            jnp.asarray(np.array(ref_pocs, np.int32)),
            jnp.int32(poc), jnp.int32(col_poc),
            qp=cfg.qp, w=cfg.width, h=cfg.height, n_refs=n_refs,
            search_range=self.search_range, sbh=cfg.sign_data_hiding,
            rdoq=True, tmvp=cfg.temporal_mvp, me_method=self.me_method,
            deblock=not cfg.deblocking_disabled, lam=self._ld_lambda(poc))
        st = {k: np.asarray(val) for k, val in st.items()}

        info = self._reconcile(st, bw, bh, ref_pocs, poc,
                               col if cfg.temporal_mvp else None)

        rec_y = st["rec_y"].astype(np.int32)
        rec_u = st["rec_u"].astype(np.int32)
        rec_v = st["rec_v"].astype(np.int32)

        sao_params = None
        if cfg.sao:
            yv, uv, vv = (p.astype(np.int32) for p in (y, u, v))
            sao_params, (rec_y, rec_u, rec_v) = self._sao_decide_apply(
                (yv, uv, vv), (rec_y, rec_u, rec_v))

        mf = motion.MotionField.empty(bw, bh, poc)
        inter_m = st["pred_mode"] == MODE_INTER
        mf.inter[:] = inter_m
        mf.mv[..., 0] = np.where(inter_m, st["mvx"], 0)
        mf.mv[..., 1] = np.where(inter_m, st["mvy"], 0)
        ref_poc_map = np.array(ref_pocs, np.int32)[st["ref_idx"]]
        mf.ref_poc[:] = np.where(inter_m, ref_poc_map, 0)

        slice_nal = self._encode_p_slice(info, poc, None, n_refs,
                                         sao_params)
        sei_nal = self._hash_sei(rec_y, rec_u, rec_v)
        return [slice_nal, sei_nal], (rec_y, rec_u, rec_v), mf

    def encode_frame(self, y, u, v, *args, **kwargs):
        """IDR pictures via the device all-intra fast path (the host CTB
        loop would dominate at 1080p); SAO falls back to the host path."""
        if self.cfg.sao or self.cfg.tile_columns != 1:
            _warn_host_fallback(self, "IDR picture (sao/tiles cfg)")
            return super().encode_frame(y, u, v, *args, **kwargs)
        return self.encode_frame_fast(y, u, v)

    def _reconcile(self, st, bw, bh, ref_pocs, poc, col):
        """Build the BlockInfo grid: spec-exact merge/AMVP syntax for the
        device-decided final motion field (motion.py derivation, shared
        with the decoder)."""
        cfg = self.cfg
        info: list[list[pc.BlockInfo | None]] = [
            [None] * bw for _ in range(bh)]
        grid = motion.NeighborGrid(info, bw, bh)
        pmod = st["pred_mode"]
        mvx, mvy = st["mvx"], st["mvy"]
        ridx = st["ref_idx"]
        cbf_y, cbf_cb, cbf_cr = st["cbf_y"], st["cbf_cb"], st["cbf_cr"]
        coef_y, coef_u, coef_v = st["coef_y"], st["coef_u"], st["coef_v"]
        imodes = st["intra_mode"]

        for by in range(bh):
            for bx in range(bw):
                b = pc.BlockInfo()
                b.qp = cfg.qp
                xx, yy = bx * 16, by * 16
                b.cbf_y = bool(cbf_y[by, bx])
                b.cbf_cb = bool(cbf_cb[by, bx])
                b.cbf_cr = bool(cbf_cr[by, bx])
                if b.cbf_y:
                    b.levels_y = coef_y[yy:yy + 16, xx:xx + 16] \
                        .astype(np.int32)
                if b.cbf_cb:
                    b.levels_cb = coef_u[yy // 2:yy // 2 + 8,
                                         xx // 2:xx // 2 + 8] \
                        .astype(np.int32)
                if b.cbf_cr:
                    b.levels_cr = coef_v[yy // 2:yy // 2 + 8,
                                         xx // 2:xx // 2 + 8] \
                        .astype(np.int32)
                if pmod[by, bx] == MODE_INTRA:
                    b.pred_mode = pc.MODE_INTRA
                    b.intra_mode = int(imodes[by, bx])
                    info[by][bx] = b
                    continue
                b.pred_mode = pc.MODE_INTER
                mv = (int(mvx[by, bx]), int(mvy[by, bx]))
                r = int(ridx[by, bx])
                b.mv = mv
                b.ref_idx = r
                b.ref_poc = ref_pocs[r]
                merge_list = motion.merge_candidates(
                    grid, bx, by, ref_pocs, poc, col, cfg.merge_cands,
                    cfg.temporal_mvp)
                try:
                    m_idx = merge_list.index((mv, r))
                except ValueError:
                    m_idx = -1
                no_resid = not (b.cbf_y or b.cbf_cb or b.cbf_cr)
                if m_idx >= 0:
                    b.merge = True
                    b.merge_idx = m_idx
                    if no_resid:
                        b.skip = True
                else:
                    b.merge = False
                    amvp = motion.amvp_candidates(
                        grid, bx, by, r, ref_pocs, poc, col,
                        cfg.temporal_mvp)
                    mvds = [(mv[0] - p[0], mv[1] - p[1]) for p in amvp]
                    bits = [pc.mvd_bits_estimate(d) for d in mvds]
                    b.mvp_idx = 0 if bits[0] <= bits[1] else 1
                    b.mvd = mvds[b.mvp_idx]
                info[by][bx] = b
        return info


# ---------------------------------------------------------------------------
# Phase 2 for B pictures: host reconciliation + the device hierarchical-B /
# random-access encoders (bframe_codec / ra_codec syntax, device pixel math)
# ---------------------------------------------------------------------------

L0, L1 = bc.L0, bc.L1


def _reconcile_b(st, bw, bh, ref_poc, poc, is_anchor):
    """Build the BBlock grid for a device-encoded B/anchor picture:
    spec-exact merge/AMVP syntax reproducing the device-decided final
    motion field (bframe_codec.derive_merge / derive_amvp_b, shared with
    the decoder).  Where the device's approximate merge differs from the
    real single merge candidate, the MV is coded explicitly — always
    conformant, approximation only ever costs bits."""
    info: list[list[bc.BBlock | None]] = [[None] * bw for _ in range(bh)]
    pmod = st["pred_mode"]
    idir = st["inter_dir"]
    m0x, m0y = st["mv0x"], st["mv0y"]
    m1x, m1y = st["mv1x"], st["mv1y"]
    cbf_y, cbf_cb, cbf_cr = st["cbf_y"], st["cbf_cb"], st["cbf_cr"]
    coef_y, coef_u, coef_v = st["coef_y"], st["coef_u"], st["coef_v"]
    imodes = st["intra_mode"]

    for by in range(bh):
        for bx in range(bw):
            b = bc.BBlock()
            xx, yy = bx * 16, by * 16
            b.cbf_y = bool(cbf_y[by, bx])
            b.cbf_cb = bool(cbf_cb[by, bx])
            b.cbf_cr = bool(cbf_cr[by, bx])
            if b.cbf_y:
                b.levels_y = coef_y[yy:yy + 16, xx:xx + 16].astype(np.int32)
            if b.cbf_cb:
                b.levels_cb = coef_u[yy // 2:yy // 2 + 8,
                                     xx // 2:xx // 2 + 8].astype(np.int32)
            if b.cbf_cr:
                b.levels_cr = coef_v[yy // 2:yy // 2 + 8,
                                     xx // 2:xx // 2 + 8].astype(np.int32)
            if pmod[by, bx] == MODE_INTRA:
                b.pred_mode = bc.MODE_INTRA
                b.intra_mode = int(imodes[by, bx])
                info[by][bx] = b
                continue
            b.pred_mode = bc.MODE_INTER
            d = int(idir[by, bx])
            mv = {}
            if d & 1:
                mv[L0] = (int(m0x[by, bx]), int(m0y[by, bx]))
            if d & 2:
                mv[L1] = (int(m1x[by, bx]), int(m1y[by, bx]))
            b.inter_dir = d
            b.mv = mv
            mdir, mmv = bc.derive_merge(info, bx, by, bw, bh,
                                        is_b_slice=not is_anchor)
            no_res = not (b.cbf_y or b.cbf_cb or b.cbf_cr)
            if mdir == d and all(tuple(mmv[lx]) == mv[lx] for lx in mv):
                b.merge = True
                if no_res:
                    b.skip = True
            else:
                b.merge = False
                if d == 3:
                    b.mvp_idx = {}
                    b.mvd = {}
                    for lx in (L0, L1):
                        amvp = bc.derive_amvp_b(info, bx, by, bw, bh, lx,
                                                poc, ref_poc)
                        mvds = [(mv[lx][0] - p[0], mv[lx][1] - p[1])
                                for p in amvp]
                        bits = [pc.mvd_bits_estimate(x) for x in mvds]
                        mi = 0 if bits[0] <= bits[1] else 1
                        b.mvp_idx[lx] = mi
                        b.mvd[lx] = mvds[mi]
                else:
                    lx = L0 if d & 1 else L1
                    amvp = bc.derive_amvp_b(info, bx, by, bw, bh, lx,
                                            poc, ref_poc)
                    mvds = [(mv[lx][0] - p[0], mv[lx][1] - p[1])
                            for p in amvp]
                    bits = [pc.mvd_bits_estimate(x) for x in mvds]
                    b.mvp_idx = 0 if bits[0] <= bits[1] else 1
                    b.mvd = mvds[b.mvp_idx]
            info[by][bx] = b
    return info


def _warn_host_fallback(enc, what: str) -> None:
    """Log (once per encoder+reason) when a device engine silently
    diverts to the ~100x-slower host path (VERDICT round-3 ask #10 /
    round-4 weak #8: these used to be silent)."""
    import logging
    seen = getattr(enc, "_fallback_warned", None)
    if seen is None:
        seen = enc._fallback_warned = set()
    if what not in seen:
        seen.add(what)
        logging.getLogger("video_codecs_tpu").warning(
            "%s: HOST-PATH FALLBACK for %s — expect ~100x slower than "
            "the device path", type(enc).__name__, what)


def hm_lambda(qp: int, qp_factor: float, depth: int) -> float:
    """HM's RD lambda ladder (TEncSlice::setUpLambda TEncSlice.cpp:320-350):
    lambda = QPFactor * 2^((qp-12)/3), scaled by Clip3(2, 4, (qp-12)/6)
    for pictures above the base temporal layer."""
    lam = qp_factor * 2.0 ** ((qp - 12) / 3.0)
    if depth > 0:
        lam *= min(4.0, max(2.0, (qp - 12) / 6.0))
    return lam


def _gop_lambda(enc, poc):
    """Slice lambda for the current picture from the encoder's GOPEntry
    table (RA path); None -> legacy 0.57 constant elsewhere."""
    gop = getattr(enc, "gop", None)
    if not gop:
        return None
    gs = getattr(enc, "gop_size", 0)
    e = next((e for e in gop if gs and (poc - e.poc) % gs == 0), None)
    if e is None:
        return None
    return hm_lambda(enc.cfg.qp, e.qp_factor, e.temporal_id)


def _device_b_frame(enc, frame, poc, refs, is_anchor):
    """Shared device B/anchor picture path: run encode_b_frame_dev, then
    host reconciliation + CABAC with the encoder's own serializer."""
    cfg = enc.cfg
    y, u, v = frame
    bw, bh = cfg.width // 16, cfg.height // 16
    ref_poc = {lx: rp for lx, (rp, _) in refs.items()}
    has_l1 = L1 in refs
    r0 = refs[L0][1]
    r1 = refs[L1][1] if has_l1 else r0

    st = encode_b_frame_dev(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(np.asarray(r0[0], np.int32)),
        jnp.asarray(np.asarray(r0[1], np.int32)),
        jnp.asarray(np.asarray(r0[2], np.int32)),
        jnp.asarray(np.asarray(r1[0], np.int32)),
        jnp.asarray(np.asarray(r1[1], np.int32)),
        jnp.asarray(np.asarray(r1[2], np.int32)),
        qp=cfg.qp, w=cfg.width, h=cfg.height, has_l1=has_l1,
        search_range=enc.search_range, sbh=cfg.sign_data_hiding,
        rdoq=True, me_method=enc.me_method,
        deblock=not cfg.deblocking_disabled, lam=_gop_lambda(enc, poc))
    st = {k: np.asarray(val) for k, val in st.items()}

    info = _reconcile_b(st, bw, bh, ref_poc, poc, is_anchor)
    rec_y = st["rec_y"].astype(np.int32)
    rec_u = st["rec_u"].astype(np.int32)
    rec_v = st["rec_v"].astype(np.int32)
    sao_params = None
    if cfg.sao:
        yv, uv, vv = (np.asarray(p).astype(np.int32) for p in (y, u, v))
        sao_params, (rec_y, rec_u, rec_v) = enc._sao_decide_apply(
            (yv, uv, vv), (rec_y, rec_u, rec_v))
    slice_nal = enc._encode_b_slice(info, poc, is_anchor, ref_poc,
                                    poc - ref_poc[L0], sao_params)
    sei_nal = enc._hash_sei(rec_y, rec_u, rec_v)
    return [slice_nal, sei_nal], (rec_y, rec_u, rec_v)


class DeviceHierarchicalBEncoder(bc.HierarchicalBEncoder):
    """2-level hierarchical-B encoder with the per-picture pixel pipeline
    on the device (same toolset/bitstream syntax as HierarchicalBEncoder)."""

    def __init__(self, cfg, search_range: int = 64,
                 me_method: str = "pyr") -> None:
        super().__init__(cfg, search_range, me_method)

    def encode_frame(self, y, u, v, *args, **kwargs):
        if self.cfg.sao or self.cfg.tile_columns != 1:
            _warn_host_fallback(self, "IDR picture (sao/tiles cfg)")
            return super().encode_frame(y, u, v, *args, **kwargs)
        return self.encode_frame_fast(y, u, v)

    def _encode_b_frame(self, frame, poc, refs, is_anchor):
        return _device_b_frame(self, frame, poc, refs, is_anchor)


class DeviceRandomAccessEncoder(ra.RandomAccessEncoder):
    """GOP-driven RA encoder (GOPEntry tables, BASELINE config 3
    structure) with the per-picture pixel pipeline on the device."""

    def __init__(self, cfg, gop: tuple = ra.GOP8_RA,
                 search_range: int = 64, me_method: str = "pyr") -> None:
        super().__init__(cfg, gop, search_range, me_method)

    def encode_frame(self, y, u, v, *args, **kwargs):
        if self.cfg.sao or self.cfg.tile_columns != 1:
            _warn_host_fallback(self, "IDR picture (sao/tiles cfg)")
            return super().encode_frame(y, u, v, *args, **kwargs)
        return self.encode_frame_fast(y, u, v)

    def _encode_b_frame(self, frame, poc, refs, is_anchor):
        # tag reference-ness for the NAL type (RandomAccessEncoder logic)
        e = next((e for e in self.gop
                  if (poc - e.poc) % self.gop_size == 0), None)
        self._cur_is_ref = e is None or e.temporal_id < 3
        return _device_b_frame(self, frame, poc, refs, is_anchor)
