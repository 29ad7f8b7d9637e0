"""Sample Adaptive Offset: statistics, decision, application (spec 8.7.3).

Parity references: hm-16.5rc1/source/Lib/TLibCommon/
TComSampleAdaptiveOffset.cpp — offsetBlock :313 (EO 4 classes + BO apply),
TLibEncoder/TEncSampleAdaptiveOffset.cpp — getStatistics :285 (per-CTU
per-class diff sums), decideBlkParams / deriveModeNewRDO :566.

Classification maps for all four EO classes and the band index are
computed for the whole picture in a few vector ops; per-CTU statistics are
box reductions over them.  Application is a gather of per-category offsets.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SAO_OFF, SAO_BO, SAO_EO = 0, 1, 2

# EO class -> (neighbor offset a, neighbor offset b) as (dy, dx)
EO_NEIGHBORS = {
    0: ((0, -1), (0, 1)),     # horizontal
    1: ((-1, 0), (1, 0)),     # vertical
    2: ((-1, -1), (1, 1)),    # 135 degrees
    3: ((-1, 1), (1, -1)),    # 45 degrees
}


@dataclasses.dataclass
class SaoParam:
    """Per-CTU per-component SAO parameters."""
    type_idx: int = SAO_OFF
    eo_class: int = 0
    band_position: int = 0
    offsets: tuple[int, int, int, int] = (0, 0, 0, 0)

    def key(self):
        return (self.type_idx, self.eo_class, self.band_position,
                self.offsets)


def eo_category_map(rec: np.ndarray, eo_class: int) -> np.ndarray:
    """Per-sample EO category 0..4 (0 = no offset / invalid border)."""
    h, w = rec.shape
    (ady, adx), (bdy, bdx) = EO_NEIGHBORS[eo_class]
    cat = np.zeros((h, w), np.int32)
    ys = slice(max(0, -ady, -bdy), h - max(0, ady, bdy))
    xs = slice(max(0, -adx, -bdx), w - max(0, adx, bdx))
    c = rec[ys, xs].astype(np.int32)
    a = rec[ys.start + ady:ys.stop + ady, xs.start + adx:xs.stop + adx]
    b = rec[ys.start + bdy:ys.stop + bdy, xs.start + bdx:xs.stop + bdx]
    s = np.sign(c - a) + np.sign(c - b)
    # spec edgeIdx mapping: -2 -> cat1, -1 -> cat2, 1 -> cat3, 2 -> cat4
    m = np.zeros_like(s)
    m[s == -2] = 1
    m[s == -1] = 2
    m[s == 1] = 3
    m[s == 2] = 4
    cat[ys, xs] = m
    return cat


def ctu_stats(orig: np.ndarray, rec: np.ndarray, x0: int, y0: int,
              size: int, eo_class: int):
    """(count[5], diff_sum[5]) for one CTU region and EO class."""
    cat = eo_category_map(rec, eo_class)[y0:y0 + size, x0:x0 + size]
    diff = (orig.astype(np.int64) - rec)[y0:y0 + size, x0:x0 + size]
    count = np.bincount(cat.reshape(-1), minlength=5)
    sums = np.bincount(cat.reshape(-1), weights=diff.reshape(-1), minlength=5)
    return count, sums


def _best_offset(e: float, n: int, positive: bool, lam: float) -> tuple[int, float]:
    """argmin over |o| in 0..7 of N*o^2 - 2*o*E + lam*bits (HM estIterOffset)."""
    best_o, best_c = 0, 0.0
    sign = 1 if positive else -1
    for mag in range(8):
        o = sign * mag
        cost = n * o * o - 2 * o * e + lam * (mag + (1 if mag else 0))
        if cost < best_c:
            best_o, best_c = o, cost
    return best_o, best_c


def decide_ctu(orig: np.ndarray, rec: np.ndarray, x0: int, y0: int,
               size: int, lam: float) -> SaoParam:
    """Pick off / BO / best-EO for one CTU region of one component."""
    best = SaoParam()
    best_cost = 0.0  # cost of OFF
    for eo in range(4):
        count, sums = ctu_stats(orig, rec, x0, y0, size, eo)
        offs = [0, 0, 0, 0]
        cost = lam * 3  # type + class bits
        for cat in (1, 2, 3, 4):
            o, c = _best_offset(sums[cat], int(count[cat]), cat <= 2, lam)
            offs[cat - 1] = o
            cost += c
        if cost < best_cost:
            best = SaoParam(SAO_EO, eo, 0,
                            (abs(offs[0]), abs(offs[1]),
                             abs(offs[2]), abs(offs[3])))
            best_cost = cost
    # band offset: 4 consecutive bands with best total gain
    region_r = rec[y0:y0 + size, x0:x0 + size].astype(np.int32)
    region_d = (orig.astype(np.int64) - rec)[y0:y0 + size, x0:x0 + size]
    band = region_r >> 3
    counts = np.bincount(band.reshape(-1), minlength=32)
    sums = np.bincount(band.reshape(-1), weights=region_d.reshape(-1),
                       minlength=32)
    band_offs = np.zeros(32, np.int64)
    band_costs = np.zeros(32)
    for bnd in range(32):
        # BO offsets are signed (sign coded); search both signs
        op, cp = _best_offset(sums[bnd], int(counts[bnd]), True, lam)
        on, cn = _best_offset(sums[bnd], int(counts[bnd]), False, lam)
        band_offs[bnd], band_costs[bnd] = (op, cp) if cp <= cn else (on, cn)
    for pos in range(29):
        cost = band_costs[pos:pos + 4].sum() + lam * 7  # type + 5-bit pos
        if cost < best_cost:
            best = SaoParam(SAO_BO, 0, pos,
                            tuple(int(o) for o in band_offs[pos:pos + 4]))
            best_cost = cost
    return best


def sao_stats_dev(orig, rec, ctb: int):
    """Device batched per-CTU SAO statistics for one plane.

    Device twin of TEncSampleAdaptiveOffset::getStatistics (:285): the four
    EO class category maps and the BO band map are whole-plane vector
    ops; per-CTU per-category counts/diff-sums are box reductions.
    Plane dims must be CTB multiples (callers pad or use exact grids).

    Returns (eo_count [4,5,cy,cx] i32, eo_sum [4,5,cy,cx] f32,
             bo_count [32,cy,cx] i32, bo_sum [32,cy,cx] f32).
    """
    import jax.numpy as jnp

    h, w = rec.shape
    cy, cx = h // ctb, w // ctb
    reci = rec.astype(jnp.int32)
    diff = (orig.astype(jnp.float32) - reci.astype(jnp.float32))

    def box(a):
        return a.reshape(cy, ctb, cx, ctb).sum(axis=(1, 3))

    eo_counts, eo_sums = [], []
    for eo in range(4):
        (ady, adx), (bdy, bdx) = EO_NEIGHBORS[eo]
        pad = jnp.pad(reci, 1, mode="edge")
        c = pad[1:-1, 1:-1]
        a = pad[1 + ady:h + 1 + ady, 1 + adx:w + 1 + adx]
        b = pad[1 + bdy:h + 1 + bdy, 1 + bdx:w + 1 + bdx]
        s = jnp.sign(c - a) + jnp.sign(c - b)
        ys = jnp.arange(h)[:, None]
        xs = jnp.arange(w)[None, :]
        valid = ((ys + min(0, ady, bdy) >= 0) &
                 (ys + max(0, ady, bdy) < h) &
                 (xs + min(0, adx, bdx) >= 0) &
                 (xs + max(0, adx, bdx) < w))
        cat = jnp.where(valid,
                        jnp.take(jnp.asarray([1, 2, 0, 3, 4],
                                             jnp.int32), s + 2), 0)
        cnts = [box((cat == k).astype(jnp.int32)) for k in range(5)]
        sums = [box(jnp.where(cat == k, diff, 0.0)) for k in range(5)]
        eo_counts.append(jnp.stack(cnts))
        eo_sums.append(jnp.stack(sums))
    band = reci >> 3
    bo_count = jnp.stack([box((band == b).astype(jnp.int32))
                          for b in range(32)])
    bo_sum = jnp.stack([box(jnp.where(band == b, diff, 0.0))
                        for b in range(32)])
    return (jnp.stack(eo_counts), jnp.stack(eo_sums), bo_count, bo_sum)


def decide_from_stats(eo_count, eo_sum, bo_count, bo_sum,
                      lam: float) -> SaoParam:
    """decide_ctu twin consuming precomputed per-CTU stats (host side;
    the heavy classification ran on device via sao_stats_dev)."""
    best = SaoParam()
    best_cost = 0.0
    for eo in range(4):
        offs = [0, 0, 0, 0]
        cost = lam * 3
        for cat in (1, 2, 3, 4):
            o, c = _best_offset(float(eo_sum[eo, cat]),
                                int(eo_count[eo, cat]), cat <= 2, lam)
            offs[cat - 1] = o
            cost += c
        if cost < best_cost:
            best = SaoParam(SAO_EO, eo, 0,
                            (abs(offs[0]), abs(offs[1]),
                             abs(offs[2]), abs(offs[3])))
            best_cost = cost
    band_offs = np.zeros(32, np.int64)
    band_costs = np.zeros(32)
    for bnd in range(32):
        op, cp = _best_offset(float(bo_sum[bnd]), int(bo_count[bnd]),
                              True, lam)
        on, cn = _best_offset(float(bo_sum[bnd]), int(bo_count[bnd]),
                              False, lam)
        band_offs[bnd], band_costs[bnd] = (op, cp) if cp <= cn else (on, cn)
    for pos in range(29):
        cost = band_costs[pos:pos + 4].sum() + lam * 7
        if cost < best_cost:
            best = SaoParam(SAO_BO, 0, pos,
                            tuple(int(o) for o in band_offs[pos:pos + 4]))
            best_cost = cost
    return best


def decide_eo_from_stats(eo_count, eo_sum, eo_class: int,
                         lam: float) -> SaoParam:
    """EO decision with a FORCED class (cr follows cb's type/class)."""
    offs = []
    for cat in (1, 2, 3, 4):
        o, _ = _best_offset(float(eo_sum[eo_class, cat]),
                            int(eo_count[eo_class, cat]), cat <= 2, lam)
        offs.append(abs(o))
    return SaoParam(SAO_EO, eo_class, 0, tuple(offs))


def decide_bo_from_stats(bo_count, bo_sum, lam: float) -> SaoParam:
    """BO decision with forced type (cr follows cb's BO type; own
    band position)."""
    band_offs = np.zeros(32, np.int64)
    band_costs = np.zeros(32)
    for bnd in range(32):
        op, cp = _best_offset(float(bo_sum[bnd]), int(bo_count[bnd]),
                              True, lam)
        on, cn = _best_offset(float(bo_sum[bnd]), int(bo_count[bnd]),
                              False, lam)
        band_offs[bnd], band_costs[bnd] = (op, cp) if cp <= cn else (on, cn)
    best_pos, best_cost = 0, 1e30
    for pos in range(29):
        cost = band_costs[pos:pos + 4].sum()
        if cost < best_cost:
            best_pos, best_cost = pos, cost
    return SaoParam(SAO_BO, 0, best_pos,
                    tuple(int(o) for o in band_offs[best_pos:best_pos + 4]))


def apply_frame(pre: np.ndarray, params: list, ctb: int,
                comp_idx: int) -> np.ndarray:
    """Whole-plane SAO apply: category maps computed once per class,
    then per-CTU offset gathers (fast twin of per-CTU apply_ctu)."""
    h, w = pre.shape
    cx = (w + ctb - 1) // ctb      # params grid is ceil-w CTBs wide
    out = pre.copy()
    cat_maps = {}
    band = pre.astype(np.int32) >> 3
    for i, p3 in enumerate(params):
        p = p3[comp_idx]
        if p is None or p.type_idx == SAO_OFF:
            continue
        by, bx = divmod(i, cx)
        y0, x0 = by * ctb, bx * ctb
        region = pre[y0:y0 + ctb, x0:x0 + ctb].astype(np.int32)
        if p.type_idx == SAO_BO:
            lut = np.zeros(32, np.int32)
            for k in range(4):
                lut[(p.band_position + k) & 31] = p.offsets[k]
            res = region + lut[band[y0:y0 + ctb, x0:x0 + ctb]]
        else:
            if p.eo_class not in cat_maps:
                cat_maps[p.eo_class] = eo_category_map(pre, p.eo_class)
            cat = cat_maps[p.eo_class][y0:y0 + ctb, x0:x0 + ctb]
            lut = np.array([0, p.offsets[0], p.offsets[1],
                            -p.offsets[2], -p.offsets[3]], np.int32)
            res = region + lut[cat]
        out[y0:y0 + ctb, x0:x0 + ctb] = np.clip(res, 0, 255)
    return out


def apply_ctu(pre: np.ndarray, out: np.ndarray, x0: int, y0: int,
              size: int, p: SaoParam, bit_depth: int = 8) -> None:
    """Apply one CTU's SAO params; reads `pre` (deblocked), writes `out`."""
    if p.type_idx == SAO_OFF:
        return
    region = pre[y0:y0 + size, x0:x0 + size].astype(np.int32)
    if p.type_idx == SAO_BO:
        lut = np.zeros(32, np.int32)
        for k in range(4):
            lut[(p.band_position + k) & 31] = p.offsets[k]
        res = region + lut[region >> (bit_depth - 5)]
    else:
        cat = eo_category_map(pre, p.eo_class)[y0:y0 + size, x0:x0 + size]
        # categories 1,2 add +|o|; 3,4 add -|o| (signs implicit, spec 7.4.9.3)
        lut = np.array([0, p.offsets[0], p.offsets[1],
                        -p.offsets[2], -p.offsets[3]], np.int32)
        res = region + lut[cat]
    out[y0:y0 + size, x0:x0 + size] = np.clip(res, 0,
                                              (1 << bit_depth) - 1)
