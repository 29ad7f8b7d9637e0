"""Motion estimation: batched integer search + fractional refinement.

Parity reference (behavioral, not structural): hm-16.5rc1 TEncSearch
xMotionEstimation :3663 / xPatternSearch :3786 / xPatternSearchFracDIF
:4240.  Device shape per SURVEY.md §7.1: instead of TZSearch's
data-dependent early exits, evaluate a full fixed window of candidates for
every block in one tensor op (SAD over [B, (2R+1)^2] shifts), then refine
half- and quarter-pel with batched on-the-fly MC + SATD.  All blocks of a
frame are searched simultaneously.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.utils.devconst import dev_const

from video_codecs_tpu.ops import cost as cost_ops
from video_codecs_tpu.ops import interp


def integer_search(ref: jnp.ndarray, cur: jnp.ndarray, x0, y0, n: int,
                   search_range: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full integer-pel search around (0, 0) for every block.

    ref: [H, W]; cur: [B, n, n]; returns (mvx, mvy) int-pel [B].
    """
    r = search_range
    win = interp._gather_window(ref, x0 - r, y0 - r, n + 2 * r, n + 2 * r)
    # patches for every shift: [B, (2r+1)^2, n, n]
    dy, dx = np.meshgrid(np.arange(2 * r + 1), np.arange(2 * r + 1),
                         indexing="ij")
    dy = dy.reshape(-1)
    dx = dx.reshape(-1)
    rows = dy[None, :, None, None] + np.arange(n)[None, None, :, None]
    cols = dx[None, :, None, None] + np.arange(n)[None, None, None, :]
    patches = win[:, rows[0], cols[0]]              # [B, S, n, n]
    sad = jnp.sum(jnp.abs(patches - cur[:, None].astype(jnp.int32)),
                  axis=(-2, -1))                    # [B, S]
    # small center bias like HM's mv-cost: prefer shorter MVs on ties
    mv_cost = (np.abs(dy - r) + np.abs(dx - r)).astype(np.int32)
    best = jnp.argmin(sad + mv_cost[None, :], axis=1)
    return ((dev_const(dx)[best] - r).astype(jnp.int32),
            (dev_const(dy)[best] - r).astype(jnp.int32))


def _sad_at_points(win: jnp.ndarray, cur: jnp.ndarray, pts: np.ndarray,
                   r: int, n: int) -> jnp.ndarray:
    """SAD of `cur` [B,n,n] vs window patches at integer offsets pts [P,2]
    (mvx, mvy in [-r, r]).  win: [B, n+2r, n+2r].  Returns [B, P]."""
    dx = pts[:, 0] + r
    dy = pts[:, 1] + r
    rows = dy[:, None, None] + np.arange(n)[None, :, None]   # [P, n, 1]
    cols = dx[:, None, None] + np.arange(n)[None, None, :]   # [P, 1, n]
    patches = win[:, rows, cols]                             # [B, P, n, n]
    return jnp.sum(jnp.abs(patches - cur[:, None].astype(jnp.int32)),
                   axis=(-2, -1))


def _tz_points(search_range: int) -> tuple[np.ndarray, np.ndarray]:
    """Fixed TZSearch candidate set: 8-point diamond rings at power-of-two
    distances (TEncSearch xTZ8PointDiamondSearch :332-656) plus the center.
    Returns (points [P,2], ring_distance [P])."""
    pts = [(0, 0)]
    dist = [0]
    d = 1
    while d <= search_range:
        if d == 1:
            ring = [(0, -1), (-1, 0), (1, 0), (0, 1)]
        else:
            h = d // 2
            ring = [(0, -d), (-h, -h), (h, -h), (-d, 0), (d, 0),
                    (-h, h), (h, h), (0, d)]
        for p in ring:
            pts.append(p)
            dist.append(d)
        d *= 2
    return np.array(pts, np.int32), np.array(dist, np.int32)


def tz_search(ref: jnp.ndarray, cur: jnp.ndarray, x0, y0, n: int,
              search_range: int,
              raster_stride: int = 5) -> tuple[jnp.ndarray, jnp.ndarray]:
    """TZSearch as fixed-shape masked tensor stages (device twin of
    TEncSearch::xTZSearch :3881).

    Stages, all batched over blocks with no data-dependent shapes:
      1. star: 8-point diamond rings at distances 1,2,4..SR around (0,0),
         all evaluated at once (the reference's early-exit loop becomes one
         argmin over the full candidate tensor);
      2. raster fallback: stride-5 subsampled grid, accepted only for
         blocks whose stage-1 best ring distance >= the stride (HM's
         iRaster rule) — a masked select instead of a branch;
      3. two star-refinement rounds: diamond rings at distances 1,2,4
         around the current best (HM's refinement loop, fixed trip count).

    Cost per block is ~(8*log2(SR) + (2SR/stride)^2 + 2*17) SADs instead of
    the full (2SR+1)^2 window.  Returns integer-pel (mvx, mvy) [B].
    """
    r = search_range
    win = interp._gather_window(ref, x0 - r, y0 - r, n + 2 * r, n + 2 * r)
    cur32 = cur.astype(jnp.int32)

    # --- stage 1: diamond rings around the zero MV ---
    pts1, dist1 = _tz_points(r)
    sad1 = _sad_at_points(win, cur32, pts1, r, n)
    mv_cost1 = (np.abs(pts1[:, 0]) + np.abs(pts1[:, 1])).astype(np.int32)
    best1 = jnp.argmin(sad1 + mv_cost1[None, :], axis=1)          # [B]
    bx = dev_const(pts1[:, 0])[best1]
    by = dev_const(pts1[:, 1])[best1]
    bd = dev_const(dist1)[best1]
    bcost = jnp.take_along_axis(sad1 + mv_cost1[None, :],
                                best1[:, None], axis=1)[:, 0]

    # --- stage 2: raster fallback (masked accept) ---
    grid = np.arange(-r, r + 1, raster_stride, np.int32)
    gx, gy = np.meshgrid(grid, grid, indexing="xy")
    pts2 = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    sad2 = _sad_at_points(win, cur32, pts2, r, n)
    mv_cost2 = (np.abs(pts2[:, 0]) + np.abs(pts2[:, 1])).astype(np.int32)
    best2 = jnp.argmin(sad2 + mv_cost2[None, :], axis=1)
    cost2 = jnp.take_along_axis(sad2 + mv_cost2[None, :],
                                best2[:, None], axis=1)[:, 0]
    # HM only RUNS raster when the stage-1 best distance > iRaster; here the
    # grid is computed unconditionally (fixed shape), so accepting any
    # improvement is free and strictly better than HM's gate.
    del bd
    use_raster = cost2 < bcost
    bx = jnp.where(use_raster, dev_const(pts2[:, 0])[best2], bx)
    by = jnp.where(use_raster, dev_const(pts2[:, 1])[best2], by)
    bcost = jnp.where(use_raster, cost2, bcost)

    # --- stage 3: star refinement around the running best ---
    pts3, _ = _tz_points(8)
    for _ in range(3):
        cand_x = bx[:, None] + dev_const(pts3[:, 0])[None, :]
        cand_y = by[:, None] + dev_const(pts3[:, 1])[None, :]
        cand_x = jnp.clip(cand_x, -r, r)
        cand_y = jnp.clip(cand_y, -r, r)
        # per-block gather: offsets differ per block now
        rows = (cand_y + r)[:, :, None, None] + \
            jnp.arange(n)[None, None, :, None]
        cols = (cand_x + r)[:, :, None, None] + \
            jnp.arange(n)[None, None, None, :]
        patches = win[jnp.arange(win.shape[0])[:, None, None, None],
                      rows, cols]
        sad = jnp.sum(jnp.abs(patches - cur32[:, None]), axis=(-2, -1))
        cost = sad + (jnp.abs(cand_x) + jnp.abs(cand_y))
        k = jnp.argmin(cost, axis=1)
        better = jnp.take_along_axis(cost, k[:, None], axis=1)[:, 0] < bcost
        bx = jnp.where(better,
                       jnp.take_along_axis(cand_x, k[:, None], axis=1)[:, 0],
                       bx)
        by = jnp.where(better,
                       jnp.take_along_axis(cand_y, k[:, None], axis=1)[:, 0],
                       by)
        bcost = jnp.where(
            better, jnp.take_along_axis(cost, k[:, None], axis=1)[:, 0],
            bcost)
    return bx.astype(jnp.int32), by.astype(jnp.int32)


def _sad_points_chunked(win: jnp.ndarray, cur: jnp.ndarray, pts: np.ndarray,
                        r: int, n: int, chunk: int = 64) -> jnp.ndarray:
    """_sad_at_points with bounded memory: the [B, P, n, n] patch tensor is
    materialized `chunk` points at a time (a static Python loop — the
    graph stays small because chunks reuse one fused gather+reduce)."""
    outs = []
    for s in range(0, len(pts), chunk):
        outs.append(_sad_at_points(win, cur, pts[s:s + chunk], r, n))
    return jnp.concatenate(outs, axis=1)


def _sad_best_around(ref: jnp.ndarray, cur: jnp.ndarray, x0, y0,
                     cx: jnp.ndarray, cy: jnp.ndarray, n: int, rad: int,
                     best_sad, best_x, best_y, bias: int = 0):
    """Refine (best_x, best_y) over the (2rad+1)^2 window around per-block
    centers (cx, cy); SAD + |mv| bias argmin folded into the running best."""
    dy, dx = np.meshgrid(np.arange(-rad, rad + 1), np.arange(-rad, rad + 1),
                         indexing="ij")
    pts = np.stack([dx.reshape(-1), dy.reshape(-1)], axis=1).astype(np.int32)
    win = interp._gather_window(ref, x0 + cx - rad, y0 + cy - rad,
                                n + 2 * rad, n + 2 * rad)
    cur32 = cur.astype(jnp.int32)
    for s in range(0, len(pts), 32):
        p = pts[s:s + 32]
        sad = _sad_at_points(win, cur32, p, rad, n)    # [B, P]
        mvx = cx[:, None] + dev_const(p[:, 0])[None, :]
        mvy = cy[:, None] + dev_const(p[:, 1])[None, :]
        cost = sad + jnp.abs(mvx) + jnp.abs(mvy) + bias
        k = jnp.argmin(cost, axis=1)
        c = jnp.take_along_axis(cost, k[:, None], axis=1)[:, 0]
        better = c < best_sad
        best_sad = jnp.where(better, c, best_sad)
        best_x = jnp.where(better, jnp.take_along_axis(mvx, k[:, None],
                                                       axis=1)[:, 0], best_x)
        best_y = jnp.where(better, jnp.take_along_axis(mvy, k[:, None],
                                                       axis=1)[:, 0], best_y)
    return best_sad, best_x, best_y


def _pool4(a: jnp.ndarray) -> jnp.ndarray:
    """4x4 mean pool (rounded) over the trailing two dims."""
    sh = a.shape
    a = a.reshape(sh[:-2] + (sh[-2] // 4, 4, sh[-1] // 4, 4))
    return (jnp.sum(a, axis=(-3, -1), dtype=jnp.int32) + 8) >> 4


def pyramid_search(ref: jnp.ndarray, cur: jnp.ndarray, x0, y0, n: int,
                   search_range: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Hierarchical integer search — the device large-range engine.

    Behavioral stand-in for HM's TZSearch (TEncSearch.cpp:3881) at ranges
    where the full window explodes: a quarter-resolution exhaustive search
    covers the whole +-search_range window (SADs on 4x4-pooled blocks are
    256x cheaper), then a +-3 full-resolution window around the upscaled
    winner and a +-3 window around the zero MV (HM's start-predictor set)
    resolve the final integer MV.  Fixed shapes, all blocks at once.
    """
    rq = max(1, (search_range + 3) // 4)
    ref_q = _pool4(ref.astype(jnp.int32))
    cur_q = _pool4(cur.astype(jnp.int32))
    nq = n // 4
    dy, dx = np.meshgrid(np.arange(-rq, rq + 1), np.arange(-rq, rq + 1),
                         indexing="ij")
    pts_q = np.stack([dx.reshape(-1), dy.reshape(-1)], 1).astype(np.int32)
    win_q = interp._gather_window(ref_q, x0 // 4 - rq, y0 // 4 - rq,
                                  nq + 2 * rq, nq + 2 * rq)
    sad_q = _sad_points_chunked(win_q, cur_q, pts_q + rq - rq, rq, nq)
    # scale pooled SADs to full-res magnitude for the |mv| bias to matter
    cost_q = sad_q * 16 + 4 * (np.abs(pts_q[:, 0]) +
                               np.abs(pts_q[:, 1]))[None, :]
    kq = jnp.argmin(cost_q, axis=1)
    cx = dev_const(pts_q[:, 0])[kq] * 4
    cy = dev_const(pts_q[:, 1])[kq] * 4

    big = jnp.full(cur.shape[0], 1 << 30, jnp.int32)
    zero = jnp.zeros(cur.shape[0], jnp.int32)
    best_sad, best_x, best_y = _sad_best_around(
        ref, cur, x0, y0, zero, zero, n, 3, big, zero, zero)
    best_sad, best_x, best_y = _sad_best_around(
        ref, cur, x0, y0, cx, cy, n, 3, best_sad, best_x, best_y)
    r = search_range
    return (jnp.clip(best_x, -r, r).astype(jnp.int32),
            jnp.clip(best_y, -r, r).astype(jnp.int32))


_OFFS8 = np.array([(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
                   (-1, 1), (0, 1), (1, 1)], np.int32)


def _refine(ref, cur, x0, y0, mvx, mvy, n, step):
    """One diamond refinement round at quarter-pel `step` using SATD."""
    offs8 = dev_const(_OFFS8)
    cand_x = mvx[:, None] + offs8[None, :, 0] * step   # [B, 8]
    cand_y = mvy[:, None] + offs8[None, :, 1] * step
    b = cur.shape[0]
    best = cost_ops.hadamard_satd_8x8(
        cur, interp.mc_luma(ref, x0, y0, mvx, mvy, n))  # [B]
    for k in range(8):
        pred = interp.mc_luma(ref, x0, y0, cand_x[:, k], cand_y[:, k], n)
        satd = cost_ops.hadamard_satd_8x8(cur, pred)
        better = satd < best
        best = jnp.where(better, satd, best)
        mvx = jnp.where(better, cand_x[:, k], mvx)
        mvy = jnp.where(better, cand_y[:, k], mvy)
    return mvx, mvy, best


def motion_search(ref: jnp.ndarray, cur: jnp.ndarray, x0, y0, n: int,
                  search_range: int = 8, method: str = "auto"):
    """Integer + half + quarter search; returns (mvx, mvy) quarter-pel [B]
    and the final SATD.

    method: "full" = exhaustive window (HM FastSearch:0), "tz" = TZSearch
    stages (FastSearch:1), "auto" = full for small ranges where the whole
    window is cheaper than the TZ stages, TZ beyond.
    """
    if method == "auto":
        method = "full" if search_range <= 12 else "tz"
    if method == "tz":
        imx, imy = tz_search(ref, cur.astype(jnp.int32), x0, y0, n,
                             search_range)
    else:
        imx, imy = integer_search(ref, cur.astype(jnp.int32), x0, y0, n,
                                  search_range)
    mvx, mvy = imx * 4, imy * 4
    mvx, mvy, _ = _refine(ref, cur, x0, y0, mvx, mvy, n, 2)
    mvx, mvy, satd = _refine(ref, cur, x0, y0, mvx, mvy, n, 1)
    return mvx, mvy, satd
