"""HEVC deblocking filter (spec 8.7.2), batched over all edges, on the device.

Parity reference: hm-16.5rc1/source/Lib/TLibCommon/TComLoopFilter.cpp —
loopFilterPic (:130) vertical-then-horizontal over the picture,
xEdgeFilterLuma (:560) strong/weak decision, beta/tc tables (:59-67),
xPelFilterLuma / xPelFilterChroma.

This module implements the uniform-grid case of the current builds: every
edge on the deblocking grid is a CU/TU boundary with both sides intra
(boundary strength 2).  Vertical edges of the whole picture are filtered
first, then horizontal edges on the vertically-filtered samples — each
pass is one fully-parallel tensor op (all edges x all 4-line segments at
once).  The horizontal pass reuses the vertical kernel on the transposed
plane.  A per-edge BS map hook extends this to inter later.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.utils.devconst import dev_const

from video_codecs_tpu.utils import rom

# TComLoopFilter.cpp:59-67 (spec Tables 8-12).
TC_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
     13, 14, 16, 18, 20, 22, 24], np.int32)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
     13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
     44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], np.int32)

INTRA_TC_OFFSET = 2  # BS=2 -> tc index + 2


def _luma_params(qp: int, bit_depth: int = 8) -> tuple[int, int]:
    scale = 1 << (bit_depth - 8)
    tc = int(TC_TABLE[min(max(qp + INTRA_TC_OFFSET, 0), 53)]) * scale
    beta = int(BETA_TABLE[min(max(qp, 0), 51)]) * scale
    return tc, beta


def _chroma_params(qp: int, bit_depth: int = 8) -> int:
    qpc = int(rom.CHROMA_QP_TABLE_420[min(max(qp, 0), 57)])
    scale = 1 << (bit_depth - 8)
    return int(TC_TABLE[min(max(qpc + INTRA_TC_OFFSET, 0), 53)]) * scale


def _filter_ver_edges_luma(plane: jnp.ndarray, edges: np.ndarray, qp,
                           bit_depth: int = 8,
                           bs: jnp.ndarray | None = None,
                           beta_off: int = 0,
                           tc_off: int = 0) -> jnp.ndarray:
    """Filter vertical luma edges at columns `edges`.

    bs: optional [E, H//4] boundary strength per 4-line segment (0/1/2);
    None means BS=2 everywhere (all-intra picture).
    qp: scalar, or [E, H//4] per-segment edge QP ((QP_P + QP_Q + 1) >> 1,
    spec 8.7.2.5.3) when CU QPs vary (cu_qp_delta)."""
    if edges.size == 0:
        return plane
    scale = 1 << (bit_depth - 8)
    scalar_qp = isinstance(qp, (int, np.integer))
    # slice beta/tc offsets shift the table indices by 2*offset_div2
    # before clipping (spec 8.7.2.5.3)
    bo, to = 2 * beta_off, 2 * tc_off
    if scalar_qp:
        tc2 = int(TC_TABLE[min(max(qp + INTRA_TC_OFFSET + to, 0),
                               53)]) * scale
        tc1 = int(TC_TABLE[min(max(qp + to, 0), 53)]) * scale
        beta = int(BETA_TABLE[min(max(qp + bo, 0), 51)]) * scale
        if beta == 0 and tc2 == 0:
            return plane
    else:
        qpa = jnp.asarray(qp, jnp.int32)                      # [E, S]
        tc2 = dev_const(TC_TABLE)[jnp.clip(qpa + INTRA_TC_OFFSET + to,
                                             0, 53)] * scale
        tc1 = dev_const(TC_TABLE)[jnp.clip(qpa + to, 0, 53)] * scale
        beta = dev_const(BETA_TABLE)[jnp.clip(qpa + bo, 0, 51)] * scale
    h = plane.shape[0]
    maxval = (1 << bit_depth) - 1
    idx = edges[:, None] + np.arange(-4, 4)[None, :]          # [E, 8]
    blk = plane[:, idx]                                        # [H, E, 8]
    blk = jnp.swapaxes(blk, 0, 1).reshape(-1, h // 4, 4, 8)    # [E, S, 4, 8]
    p3, p2, p1, p0 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    q0, q1, q2, q3 = blk[..., 4], blk[..., 5], blk[..., 6], blk[..., 7]

    dp = jnp.abs(p2 - 2 * p1 + p0)    # [E, S, 4]
    dq = jnp.abs(q2 - 2 * q1 + q0)
    d0 = dp[..., 0] + dq[..., 0]      # [E, S]
    d3 = dp[..., 3] + dq[..., 3]
    d = d0 + d3
    vec = (bs is not None) or not scalar_qp
    if bs is None:
        filt = d < beta
        tc = (tc2 * jnp.ones_like(d))[..., None] if vec else tc2
    else:
        tc = jnp.where(bs == 2, tc2, tc1)[..., None]   # [E, S, 1] -> bcast
        filt = (d < beta) & (bs > 0)

    def strong_line(i):
        return ((2 * (dp[..., i] + dq[..., i]) < (beta >> 2)) &
                ((jnp.abs(p3[..., i] - p0[..., i]) +
                  jnp.abs(q0[..., i] - q3[..., i])) < (beta >> 3)) &
                (jnp.abs(p0[..., i] - q0[..., i]) < ((5 * tc + 1) >> 1)))

    if vec:
        tc = tc[..., 0]  # [E, S] for the per-segment decisions below
    strong = filt & strong_line(0) & strong_line(3)            # [E, S]
    dp_s = dp[..., 0] + dp[..., 3]
    dq_s = dq[..., 0] + dq[..., 3]
    side_thr = (beta + (beta >> 1)) >> 3
    dep1 = dp_s < side_thr
    deq1 = dq_s < side_thr

    # ---- strong filter (3 samples each side) ----
    tcl = tc[..., None] if vec else tc  # [E,S,1] vs scalar
    sp0 = jnp.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   p0 - 2 * tcl, p0 + 2 * tcl)
    sp1 = jnp.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tcl, p1 + 2 * tcl)
    sp2 = jnp.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                   p2 - 2 * tcl, p2 + 2 * tcl)
    sq0 = jnp.clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                   q0 - 2 * tcl, q0 + 2 * tcl)
    sq1 = jnp.clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tcl, q1 + 2 * tcl)
    sq2 = jnp.clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                   q2 - 2 * tcl, q2 + 2 * tcl)

    # ---- weak filter ----
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = jnp.abs(delta) < 10 * tcl
    dclip = jnp.clip(delta, -tcl, tcl)
    wp0 = jnp.clip(p0 + dclip, 0, maxval)
    wq0 = jnp.clip(q0 - dclip, 0, maxval)
    tch = tcl >> 1
    dp1 = jnp.clip((((p2 + p0 + 1) >> 1) - p1 + dclip) >> 1, -tch, tch)
    wq1d = jnp.clip((((q2 + q0 + 1) >> 1) - q1 - dclip) >> 1, -tch, tch)
    wp1 = jnp.clip(p1 + dp1, 0, maxval)
    wq1 = jnp.clip(q1 + wq1d, 0, maxval)

    st = strong[..., None]                                     # [E, S, 1]
    fl = filt[..., None]
    wk = fl & ~st & weak_on
    out_p0 = jnp.where(st, sp0, jnp.where(wk, wp0, p0))
    out_q0 = jnp.where(st, sq0, jnp.where(wk, wq0, q0))
    out_p1 = jnp.where(st, sp1, jnp.where(wk & dep1[..., None], wp1, p1))
    out_q1 = jnp.where(st, sq1, jnp.where(wk & deq1[..., None], wq1, q1))
    out_p2 = jnp.where(st, sp2, p2)
    out_q2 = jnp.where(st, sq2, q2)

    new = jnp.stack([out_p2, out_p1, out_p0, out_q0, out_q1, out_q2], axis=-1)
    new = new.reshape(edges.size, h, 6)
    new = jnp.swapaxes(new, 0, 1)                              # [H, E, 6]
    widx = edges[:, None] + np.arange(-3, 3)[None, :]
    return plane.at[:, widx].set(new)


def _filter_ver_edges_chroma(plane: jnp.ndarray, edges: np.ndarray, qp,
                             bit_depth: int = 8,
                             mask: jnp.ndarray | None = None,
                             tc_off: int = 0,
                             qp_off: int = 0) -> jnp.ndarray:
    """Chroma vertical edges, filtered where BS==2 (spec 8.7.2.5.5).

    mask: optional [E, H_c] bool (BS==2 per line); None = everywhere.
    qp: scalar luma edge QP, or [E, H_c] per-line luma edge QPs."""
    if edges.size == 0:
        return plane
    if isinstance(qp, (int, np.integer)):
        scale = 1 << (bit_depth - 8)
        # QpC = table[Clip3(0, 57, qP + cQpOffset)] with the PPS
        # cb/cr offset (spec 8.7.2.5.5)
        qpc = int(rom.CHROMA_QP_TABLE_420[min(max(qp + qp_off, 0), 57)])
        tc = int(TC_TABLE[min(max(qpc + INTRA_TC_OFFSET + 2 * tc_off,
                                  0), 53)]) * scale
        if tc == 0:
            return plane
    else:
        scale = 1 << (bit_depth - 8)
        qpa = jnp.asarray(qp, jnp.int32)
        if qp_off:
            qpa = qpa + qp_off
        qpc = dev_const(rom.CHROMA_QP_TABLE_420)[jnp.clip(qpa, 0, 57)]
        tc_arr = dev_const(TC_TABLE)[
            jnp.clip(qpc + INTRA_TC_OFFSET + 2 * tc_off, 0, 53)] * scale
        tc = jnp.swapaxes(tc_arr, 0, 1)  # [H_c, E]
    maxval = (1 << bit_depth) - 1
    idx = edges[:, None] + np.arange(-2, 2)[None, :]
    blk = plane[:, idx]                                        # [H, E, 4]
    p1, p0, q0, q1 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    delta = jnp.clip(((((q0 - p0) << 2) + p1 - q1 + 4) >> 3), -tc, tc)
    np0 = jnp.clip(p0 + delta, 0, maxval)
    nq0 = jnp.clip(q0 - delta, 0, maxval)
    if not isinstance(qp, (int, np.integer)):
        keep = tc == 0
        np0 = jnp.where(keep, p0, np0)
        nq0 = jnp.where(keep, q0, nq0)
    if mask is not None:
        m = jnp.swapaxes(mask, 0, 1)                           # [H, E]
        np0 = jnp.where(m, np0, p0)
        nq0 = jnp.where(m, nq0, q0)
    new = jnp.stack([np0, nq0], axis=-1)                       # [H, E, 2]
    widx = edges[:, None] + np.arange(-1, 1)[None, :]
    return plane.at[:, widx].set(new)


def deblock_420(rec_y: jnp.ndarray, rec_u: jnp.ndarray, rec_v: jnp.ndarray,
                qp: int, block: int = 16, bit_depth: int = 8):
    """Deblock an all-intra picture with a uniform `block` CU/TU grid.

    Vertical edges first (whole picture), then horizontal on the result
    (HM loopFilterPic order).  Horizontal = vertical kernel on transpose.
    """
    h, w = rec_y.shape
    ey = np.arange(block, w, block, dtype=np.int32)
    ex = np.arange(block, h, block, dtype=np.int32)
    cb = block // 2
    cey = np.arange(cb, w // 2, cb, dtype=np.int32)
    cex = np.arange(cb, h // 2, cb, dtype=np.int32)

    rec_y = _filter_ver_edges_luma(rec_y, ey, qp, bit_depth)
    rec_y = _filter_ver_edges_luma(rec_y.T, ex, qp, bit_depth).T
    out_c = []
    for p in (rec_u, rec_v):
        p = _filter_ver_edges_chroma(p, cey, qp, bit_depth)
        p = _filter_ver_edges_chroma(p.T, cex, qp, bit_depth).T
        out_c.append(p)
    return rec_y, out_c[0], out_c[1]


# ---------------------------------------------------------------------------
# NumPy twin (host reference path)
# ---------------------------------------------------------------------------

def deblock_420_np(rec_y: np.ndarray, rec_u: np.ndarray, rec_v: np.ndarray,
                   qp: int, block: int = 16, bit_depth: int = 8):
    out = deblock_420(jnp.asarray(rec_y), jnp.asarray(rec_u),
                      jnp.asarray(rec_v), qp, block, bit_depth)
    return tuple(np.asarray(o) for o in out)


def deblock_420_bs(rec_y, rec_u, rec_v, qp,
                   bs_ver: np.ndarray, bs_hor: np.ndarray,
                   block: int = 16, bit_depth: int = 8,
                   qp_map=None, seg4: bool = False,
                   beta_off: int = 0, tc_off: int = 0,
                   cb_qp_off: int = 0, cr_qp_off: int = 0):
    """Deblock with per-block-pair boundary strengths (inter pictures).

    bs_ver: [n_ver_edges, bh] BS between horizontally adjacent blocks;
    bs_hor: [n_hor_edges, bw] BS between vertically adjacent blocks.
    seg4: BS maps are already at 4-sample-segment granularity
    ([E, H//4] / [E, W//4], spec 8.7.2.4 resolution — the general
    decoder path); block must be 8.
    qp_map: optional [bh, bw] per-block luma QP (cu_qp_delta pictures);
    edge QPs follow spec 8.7.2.5.3: (QP_P + QP_Q + 1) >> 1.
    """
    h, w = rec_y.shape
    ey = np.arange(block, w, block, dtype=np.int32)
    ex = np.arange(block, h, block, dtype=np.int32)
    segs = block // 4

    if seg4:
        assert block == 8
        bs_v = jnp.asarray(bs_ver)                         # [E, H//4]
        bs_h = jnp.asarray(bs_hor)
    else:
        bs_v = jnp.repeat(jnp.asarray(bs_ver), segs, axis=1)
        bs_h = jnp.repeat(jnp.asarray(bs_hor), segs, axis=1)
    qp_v = qp_h = qp
    cqp_v = cqp_h = qp
    if qp_map is not None and seg4:
        # per-4x4 luma QP map (cu_qp_delta pictures, general decoder):
        # edge QP = (QP_P + QP_Q + 1) >> 1 per 4-sample segment
        # (spec 8.7.2.5.3)
        q4 = jnp.asarray(qp_map, jnp.int32)                # [H//4, W//4]
        qp_v = ((q4[:, ey // 4 - 1] + q4[:, ey // 4] + 1) >> 1).T
        qp_h = (q4[ex // 4 - 1, :] + q4[ex // 4, :] + 1) >> 1
        cqp_v = jnp.repeat(qp_v[1::2], 2, axis=1)
        cqp_h = jnp.repeat(qp_h[1::2], 2, axis=1)
    elif qp_map is not None:
        qm = jnp.asarray(qp_map, jnp.int32)
        qe_v = (qm[:, :-1] + qm[:, 1:] + 1) >> 1           # [bh, E]
        qe_h = (qm[:-1, :] + qm[1:, :] + 1) >> 1           # [E, bw]
        qp_v = jnp.repeat(qe_v.T, segs, axis=1)            # [E, H//4]
        qp_h = jnp.repeat(qe_h, segs, axis=1)              # [E, W//4]
        step_ = 16 // block
        crep_ = block // 2
        cqp_v = jnp.repeat(qe_v.T[step_ - 1::step_], crep_, axis=1)
        cqp_h = jnp.repeat(qe_h[step_ - 1::step_], crep_, axis=1)
    rec_y = _filter_ver_edges_luma(rec_y, ey, qp_v, bit_depth, bs=bs_v,
                                   beta_off=beta_off, tc_off=tc_off)
    rec_y = _filter_ver_edges_luma(rec_y.T, ex, qp_h, bit_depth, bs=bs_h,
                                   beta_off=beta_off, tc_off=tc_off).T

    # Chroma edges always lie on the 16-luma-sample grid (spec 8.7.2); for
    # block=8 only every second luma edge has a chroma counterpart.
    step = 16 // block
    cey = np.arange(8, w // 2, 8, dtype=np.int32)
    cex = np.arange(8, h // 2, 8, dtype=np.int32)
    # chroma rows covered by one BS row: 4 luma = 2 chroma when seg4
    crep = 2 if seg4 else block // 2
    cm_v = jnp.repeat(jnp.asarray(bs_ver)[step - 1::step] == 2, crep, axis=1)
    cm_h = jnp.repeat(jnp.asarray(bs_hor)[step - 1::step] == 2, crep, axis=1)
    out_c = []
    for p, coff in ((rec_u, cb_qp_off), (rec_v, cr_qp_off)):
        p = _filter_ver_edges_chroma(p, cey, cqp_v, bit_depth, mask=cm_v,
                                     tc_off=tc_off, qp_off=coff)
        p = _filter_ver_edges_chroma(p.T, cex, cqp_h, bit_depth,
                                     mask=cm_h, tc_off=tc_off,
                                     qp_off=coff).T
        out_c.append(p)
    return rec_y, out_c[0], out_c[1]


def deblock_420_bs_np(rec_y, rec_u, rec_v, qp, bs_ver, bs_hor,
                      block: int = 16, bit_depth: int = 8, qp_map=None,
                      seg4: bool = False, beta_off: int = 0,
                      tc_off: int = 0, cb_qp_off: int = 0,
                      cr_qp_off: int = 0):
    out = deblock_420_bs(jnp.asarray(rec_y), jnp.asarray(rec_u),
                         jnp.asarray(rec_v), qp, bs_ver, bs_hor,
                         block, bit_depth, qp_map=qp_map, seg4=seg4,
                         beta_off=beta_off, tc_off=tc_off,
                         cb_qp_off=cb_qp_off, cr_qp_off=cr_qp_off)
    return tuple(np.asarray(o) for o in out)
