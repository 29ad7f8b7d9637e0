"""Device-side all-intra CU-quadtree encoder (CTB 32, CUs 32/16/8) — the
device fast path for the quality operating point.

Replaces HM's recursive xCompressCU RDO (hm-16.5rc1 TEncCu.cpp:349) with
the SURVEY.md §7.1 batched design:

Pass 1 — decision (fully parallel): for every CU candidate at every size
(8/16/32), sweep all 35 intra modes as one matmul from ORIGINAL-neighbor
references, trial-code the best mode (transform -> RDOQ-lite -> recon) to
get a true rate-distortion cost J = SSE + lambda*R, then resolve the
quadtree with a bottom-up tree-DP argmin (4-children sum vs parent) — the
O(log) reduction that replaces HM's depth-first recursion.

Pass 2 — reconstruction (wavefront): CTBs on an anti-diagonal d = cx+2*cy
are dependence-free; inside each CTB the 16 8x8 Z-order quanta are
statically unrolled micro-steps, each coding the 8/16/32 CU whose origin
lands there (masked select by the decided depth map).  Reference samples
use the exact spec 6.4.1 Z-scan availability (device twin of
quadtree_codec.build_ref_z), so encoder recon == decoder recon.

Pictures need not be CTB-multiples: boundary CTBs get implicit splits
(split_cu_flag inferred, spec 7.4.9.4); picture dims must be multiples of
the 8-px min CU, which the SPS guarantees.

Outputs: depth map + per-size mode maps + coefficient PLANES (each CU's
NxN level block stored at its spatial position — total transfer is
exactly one int16 per pixel) + recon planes, feeding the host CABAC
serializer (quadtree_codec.encode_slice_qt / native C++).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.models.hevc import encoder_jax
from video_codecs_tpu.ops import cost as cost_ops
from video_codecs_tpu.ops import intra as intra_ops
from video_codecs_tpu.ops import quant as quant_ops
from video_codecs_tpu.ops import transform as tr_ops
from video_codecs_tpu.utils import rom

DC = 1
LOG2_CTB = 5
CTB = 32

# Per-CU syntax-overhead bit estimates for the tree decision (part mode,
# prev_intra flag, mpm/rem bins, chroma mode, cbf flags).  Tuned on the
# bench clip by QP-sweep BD-rate.
_CU_OVERHEAD_BITS = {8: 10.0, 16: 9.0, 32: 9.0}

# RDOQ-lite rate-model lambda calibration for the quadtree path (QP-sweep
# BD-rate tuned on the bench clip; the fixed-16 path keeps its own 2.0).
RDOQ_LAM_SCALE = float(__import__("os").environ.get("VCT_QT_RDOQ_SCALE",
                                                    "1.0"))


def _ceil_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


# ---------------------------------------------------------------------------
# Z-scan availability (device twin of quadtree_codec.z_index/build_ref_z)
# ---------------------------------------------------------------------------

def z_index_dev(x: jnp.ndarray, y: jnp.ndarray, log2_ctb: int,
                ctbs_per_row: int) -> jnp.ndarray:
    """Global Z-scan order of the 4x4 block containing (x, y) (spec 6.4.1)."""
    nbits = log2_ctb - 2
    mask = (1 << nbits) - 1
    ix = (x >> 2) & mask
    iy = (y >> 2) & mask
    m = jnp.zeros_like(x)
    for b in range(nbits):
        m = m | (((ix >> b) & 1) << (2 * b)) | (((iy >> b) & 1) << (2 * b + 1))
    ctb = (y >> log2_ctb) * ctbs_per_row + (x >> log2_ctb)
    return (ctb << (2 * nbits)) + m


def gather_refs_z(plane: jnp.ndarray, x0: jnp.ndarray, y0: jnp.ndarray,
                  n: int, log2_ctb: int, w: int, h: int) -> jnp.ndarray:
    """Substituted reference arrays [B, 4N+1] with exact Z-scan
    availability against the TRUE picture dims (w, h); `plane` may be
    padded larger for safe clipped gathers."""
    ph, pw = plane.shape
    ctbs_per_row = (w + (1 << log2_ctb) - 1) >> log2_ctb
    dy, dx = encoder_jax._ref_offsets(n)
    rows = y0[:, None] + dy[None, :]
    cols = x0[:, None] + dx[None, :]
    inb = (rows >= 0) & (cols >= 0) & (rows < h) & (cols < w)
    rc = jnp.clip(rows, 0, ph - 1)
    cc = jnp.clip(cols, 0, pw - 1)
    cur = z_index_dev(x0, y0, log2_ctb, ctbs_per_row)[:, None]
    avail = inb & (z_index_dev(cc, rc, log2_ctb, ctbs_per_row) < cur)
    samples = plane[rc, cc]
    return intra_ops.substitute_unavailable(samples.astype(jnp.int32), avail)


# ---------------------------------------------------------------------------
# Pass 1: per-size mode sweep + trial-coded cost, then tree-DP
# ---------------------------------------------------------------------------

def _grid(n: int, pw: int, ph: int):
    bw, bh = pw // n, ph // n
    xs = jnp.tile(jnp.arange(bw, dtype=jnp.int32) * n, bh)
    ys = jnp.repeat(jnp.arange(bh, dtype=jnp.int32) * n, bw)
    return xs, ys, bw, bh


def _mode_sweep(y: jnp.ndarray, qp: int, n: int,
                lam_scale: float = 1.0) -> jnp.ndarray:
    """[bh, bw] best intra mode per n-block (original-neighbor SATD sweep
    with a left-MPM-aware row scan, like encoder_jax.decide_modes_device)."""
    ph, pw = y.shape
    xs, ys, bw, bh = _grid(n, pw, ph)
    log2 = n.bit_length() - 1
    refs = encoder_jax.gather_refs(y, xs, ys, n)
    modes = jnp.broadcast_to(jnp.arange(35, dtype=jnp.int32), (bw * bh, 35))
    preds = intra_ops.predict_intra(refs, modes, log2)
    blocks = encoder_jax._extract_blocks(y, xs, ys, n)
    satd = cost_ops.hadamard_satd_8x8(blocks[:, None], preds)
    satd = satd.reshape(bh, bw, 35)

    sl = math.sqrt(lam_scale * 0.57 * 2.0 ** ((qp - 12) / 3.0))
    c_mpm0 = int(round(sl * 2.0))
    c_mpm1 = int(round(sl * 3.0))
    c_rem = int(round(sl * 6.0))

    def step(left_mode, satd_b):
        m0 = jnp.where(left_mode < 2, 0, left_mode)
        m2 = jnp.where(left_mode < 2, 26, 0)
        bits = jnp.full(35, c_rem, jnp.int32)
        bits = bits.at[1].set(c_mpm1).at[m2].set(c_mpm1).at[m0].set(c_mpm0)
        best = jnp.argmin(satd_b + bits).astype(jnp.int32)
        return best, best

    def row(satd_row):
        _, bests = jax.lax.scan(step, jnp.int32(DC), satd_row)
        return bests

    return jax.vmap(row)(satd)


def _level_rate_bits(levels: jnp.ndarray) -> jnp.ndarray:
    """Crude coefficient-rate model over [..., N, N] levels (bits)."""
    a = jnp.abs(levels).astype(jnp.float32)
    bits = jnp.where(a == 0.0, 0.0, 2.0 + jnp.log2(a + 1.0))
    return jnp.sum(bits, axis=(-2, -1))


def _trial_cost(y: jnp.ndarray, qp: int, n: int, modes: jnp.ndarray,
                lam: float, rdoq: bool) -> jnp.ndarray:
    """True-RD trial of the chosen mode per block: J = SSE + lam*R.

    With rdoq on, the rate is the device full RDOQ's own CABAC-table
    fractional-bit estimate (ops/rdoq_jax, HM TEncBinCABACCounter
    parity) — exact coefficient rates for the split decision instead of
    the old log2-magnitude proxy (VERDICT round-3/4 ask #2/#3)."""
    ph, pw = y.shape
    xs, ys, bw, bh = _grid(n, pw, ph)
    log2 = n.bit_length() - 1
    refs = encoder_jax.gather_refs(y, xs, ys, n)
    pred = intra_ops.predict_intra(refs, modes.reshape(-1, 1), log2)[:, 0]
    oblk = encoder_jax._extract_blocks(y, xs, ys, n)
    res = oblk - pred
    coeff = tr_ops.forward_transform(res, log2)
    if rdoq:
        from video_codecs_tpu.ops import rdoq_jax
        levels, bits = rdoq_jax.rdoq_dev(coeff, qp, log2, lam=lam,
                                         slice_type=2, return_rate=True)
        rate = bits + _CU_OVERHEAD_BITS[n]
    else:
        levels = quant_ops.quantize(coeff, qp, log2)
        rate = _level_rate_bits(levels) + _CU_OVERHEAD_BITS[n]
    dq = quant_ops.dequantize(levels, qp, log2)
    r = tr_ops.inverse_transform(dq, log2)
    rec = jnp.clip(pred + r, 0, 255)
    d = cost_ops.sse(oblk, rec).astype(jnp.float32)
    return (d + jnp.float32(lam) * rate).reshape(bh, bw)


def _sum2x2(a: jnp.ndarray) -> jnp.ndarray:
    h, w = a.shape
    return a.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))


def decide_qt_device(y: jnp.ndarray, qp: int, w: int, h: int, rdoq: bool,
                     lam_scale: float = 1.0):
    """Quadtree decision on the padded original luma plane.

    Returns depth8 [ph/8, pw/8] int32 (0: in a 32-CU, 1: 16, 2: 8) plus
    per-size mode maps.  Boundary CUs that do not fit the true picture are
    forced split (spec implicit split).
    """
    ph, pw = y.shape
    lam = lam_scale * 0.57 * 2.0 ** ((qp - 12) / 3.0)

    m8 = _mode_sweep(y, qp, 8, lam_scale)
    m16 = _mode_sweep(y, qp, 16, lam_scale)
    m32 = _mode_sweep(y, qp, 32, lam_scale)
    j8 = _trial_cost(y, qp, 8, m8, lam, rdoq)
    j16 = _trial_cost(y, qp, 16, m16, lam, rdoq)
    j32 = _trial_cost(y, qp, 32, m32, lam, rdoq)

    # fit masks against the true picture (dims are multiples of 8)
    def fit_mask(n, bw, bh):
        xs = jnp.arange(bw, dtype=jnp.int32) * n
        ys = jnp.arange(bh, dtype=jnp.int32) * n
        return (ys[:, None] + n <= h) & (xs[None, :] + n <= w)

    in8 = fit_mask(8, pw // 8, ph // 8)          # inside == fits for 8
    fit16 = fit_mask(16, pw // 16, ph // 16)
    fit32 = fit_mask(32, pw // 32, ph // 32)

    j8 = jnp.where(in8, j8, 0.0)                 # absent blocks cost nothing
    sum8 = _sum2x2(j8)
    split16 = (~fit16) | (sum8 < j16)
    j16t = jnp.where(split16, sum8, j16)
    sum16 = _sum2x2(j16t)
    split32 = (~fit32) | (sum16 < j32)

    chosen32 = ~split32                                          # 32-grid
    chosen16 = jnp.repeat(jnp.repeat(split32, 2, 0), 2, 1) & ~split16
    up32 = jnp.repeat(jnp.repeat(chosen32, 4, 0), 4, 1)          # 8-grid
    up16 = jnp.repeat(jnp.repeat(chosen16, 2, 0), 2, 1)
    depth8 = 2 - 2 * up32.astype(jnp.int32) - up16.astype(jnp.int32)
    return depth8, m8, m16, m32


# ---------------------------------------------------------------------------
# Pass 2: wavefront reconstruction honoring the decided tree
# ---------------------------------------------------------------------------

def _scatter(plane: jnp.ndarray, vals: jnp.ndarray, xs: jnp.ndarray,
             ys: jnp.ndarray, n: int, sel: jnp.ndarray) -> jnp.ndarray:
    rows = ys[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None, :, None]
    cols = xs[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None, None, :]
    rows = jnp.where(sel[:, None, None], rows, plane.shape[0] + 7)
    return plane.at[rows, cols].set(vals, mode="drop")


def _scan_type_dev(modes: jnp.ndarray) -> jnp.ndarray:
    """Mode-dependent scan for 4x4/8x8 TBs (rom.intra_scan_type twin)."""
    ver = (modes >= 6) & (modes <= 14)
    hor = (modes >= 22) & (modes <= 30)
    return jnp.where(ver, rom.SCAN_VER,
                     jnp.where(hor, rom.SCAN_HOR, rom.SCAN_DIAG))


def _code_tb_batch(oblk, pred, qp: int, log2: int, sbh: bool, rdoq: bool,
                   scan_t: jnp.ndarray | None, lam_scale: float = 1.0):
    """Batched TB coding; returns (levels, recon)."""
    res = oblk - pred
    coeff = tr_ops.forward_transform(res, log2)
    if rdoq:
        lam = lam_scale * 0.57 * 2.0 ** ((qp - 12) / 3.0)
        levels = quant_ops.rdoq_lite(coeff, qp, log2, lam=lam,
                                     lam_scale=RDOQ_LAM_SCALE)
    else:
        levels = quant_ops.quantize(coeff, qp, log2)
    if sbh:
        if scan_t is None:
            levels = quant_ops.apply_sbh(levels, log2, coeff, qp)
        else:
            levels = quant_ops.apply_sbh_scan(levels, log2, scan_t, coeff, qp)
    dq = quant_ops.dequantize(levels, qp, log2)
    r = tr_ops.inverse_transform(dq, log2)
    rec = jnp.clip(pred + r, 0, 255)
    return levels, rec


def encode_frame_qt_device(y, u, v, depth8, m8, m16, m32, qp: int, qp_c: int,
                           w: int, h: int, sbh: bool, rdoq: bool,
                           lam_scale: float = 1.0):
    """Wavefront recon of the decided quadtree; returns recon planes and
    coefficient planes (padded dims; caller crops)."""
    ph, pw = y.shape
    cw, ch = pw // CTB, ph // CTB
    coords, valid, steps, max_len = encoder_jax._wavefront_schedule(cw, ch)

    state = dict(
        rec_y=jnp.zeros((ph, pw), jnp.int32),
        rec_u=jnp.zeros((ph // 2, pw // 2), jnp.int32),
        rec_v=jnp.zeros((ph // 2, pw // 2), jnp.int32),
        coef_y=jnp.zeros((ph, pw), jnp.int32),
        coef_u=jnp.zeros((ph // 2, pw // 2), jnp.int32),
        coef_v=jnp.zeros((ph // 2, pw // 2), jnp.int32),
    )

    def code_cu(st, xs, ys, n, mode_map, sel):
        log2 = n.bit_length() - 1
        modes = mode_map[ys // n, xs // n]
        # luma
        refs = gather_refs_z(st["rec_y"], xs, ys, n, LOG2_CTB, w, h)
        pred = intra_ops.predict_intra(refs, modes[:, None], log2)[:, 0]
        oblk = encoder_jax._extract_blocks(y, xs, ys, n)
        scan_t = _scan_type_dev(modes) if log2 == 3 else None
        lv, rec = _code_tb_batch(oblk, pred, qp, log2, sbh, rdoq, scan_t,
                                 lam_scale)
        st["rec_y"] = _scatter(st["rec_y"], rec, xs, ys, n, sel)
        st["coef_y"] = _scatter(st["coef_y"], lv, xs, ys, n, sel)
        # chroma (DM mode, TB at half size, min 4)
        cs = max(n // 2, 4)
        clog2 = cs.bit_length() - 1
        cxs, cys = xs // 2, ys // 2
        cscan_t = _scan_type_dev(modes) if clog2 == 2 else None
        for comp, (orig_c, rk, ck) in enumerate(
                ((u, "rec_u", "coef_u"), (v, "rec_v", "coef_v"))):
            refc = gather_refs_z(st[rk], cxs, cys, cs, LOG2_CTB - 1,
                                 w // 2, h // 2)
            predc = intra_ops.predict_intra(refc, modes[:, None], clog2,
                                            is_luma=False)[:, 0]
            oc = encoder_jax._extract_blocks(orig_c, cxs, cys, cs)
            lvc, recc = _code_tb_batch(oc, predc, qp_c, clog2, sbh, rdoq,
                                       cscan_t, lam_scale)
            st[rk] = _scatter(st[rk], recc, cxs, cys, cs, sel)
            st[ck] = _scatter(st[ck], lvc, cxs, cys, cs, sel)
        return st

    def sel(vmask, xs, ys, want_depth):
        return vmask & (xs < w) & (ys < h) & \
            (depth8[ys // 8, xs // 8] == want_depth)

    def body(d, st):
        c = jax.lax.dynamic_slice(coords, (d, 0, 0), (1, max_len, 2))[0]
        vmask = jax.lax.dynamic_slice(valid, (d, 0), (1, max_len))[0]
        cx = c[:, 0] * CTB
        cy = c[:, 1] * CTB
        # Z-order micro-steps as nested scans (16 sequential 8x8 quanta per
        # CTB); each CU size is traced ONCE, keeping the XLA graph small.
        st = code_cu(st, cx, cy, 32, m32, sel(vmask, cx, cy, 0))

        def qstep(st, q):
            qx = cx + (q & 1) * 16
            qy = cy + (q >> 1) * 16
            st = code_cu(st, qx, qy, 16, m16, sel(vmask, qx, qy, 1))

            def sstep(st, s):
                x8 = qx + (s & 1) * 8
                y8 = qy + (s >> 1) * 8
                return code_cu(st, x8, y8, 8, m8,
                               sel(vmask, x8, y8, 2)), None

            st, _ = jax.lax.scan(sstep, st, jnp.arange(4, dtype=jnp.int32))
            return st, None

        st, _ = jax.lax.scan(qstep, st, jnp.arange(4, dtype=jnp.int32))
        return st

    return jax.lax.fori_loop(0, steps, body, state)


# ---------------------------------------------------------------------------
# Deblocking BS maps from the depth map (CU boundaries on the 8 grid)
# ---------------------------------------------------------------------------

def bs_maps_from_depth(depth8: jnp.ndarray, w: int, h: int):
    """BS=2 on 8-grid edges between different CUs (all-intra picture).

    Twin of quadtree_codec.bs_maps_from_cu_ids, derived from the depth map:
    two 8-cells belong to the same CU iff they share a CU origin.
    """
    w8, h8 = w // 8, h // 8
    d = depth8[:h8, :w8]
    gx = jnp.arange(w8, dtype=jnp.int32)[None, :]
    gy = jnp.arange(h8, dtype=jnp.int32)[:, None]
    size8 = (4 >> d).astype(jnp.int32)          # CU size in 8-cells: 4/2/1
    ox = gx - (gx % size8)
    oy = gy - (gy % size8)
    cu_id = oy * w8 + ox
    bs_ver = 2 * (cu_id[:, :-1] != cu_id[:, 1:]).astype(jnp.int32).T
    bs_hor = 2 * (cu_id[:-1, :] != cu_id[1:, :]).astype(jnp.int32)
    return bs_ver, bs_hor


# ---------------------------------------------------------------------------
# Full jitted pipeline
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("qp", "w", "h", "deblock",
                                             "sbh", "rdoq", "lam_scale"))
def encode_frame_qt_jit(y, u, v, qp: int, w: int, h: int,
                        deblock: bool = True, sbh: bool = True,
                        rdoq: bool = True, lam_scale: float = 1.0):
    """Decision + wavefront recon + deblock, one compiled graph."""
    from video_codecs_tpu.models.hevc.intra_codec import chroma_qp
    from video_codecs_tpu.ops import deblock as deblock_ops

    pw, ph = _ceil_to(w, CTB), _ceil_to(h, CTB)
    yi = jnp.pad(y.astype(jnp.int32), ((0, ph - h), (0, pw - w)), "edge")
    ui = jnp.pad(u.astype(jnp.int32),
                 ((0, (ph - h) // 2), (0, (pw - w) // 2)), "edge")
    vi = jnp.pad(v.astype(jnp.int32),
                 ((0, (ph - h) // 2), (0, (pw - w) // 2)), "edge")

    qp_c = chroma_qp(qp)
    depth8, m8, m16, m32 = decide_qt_device(yi, qp, w, h, rdoq, lam_scale)
    st = encode_frame_qt_device(yi, ui, vi, depth8, m8, m16, m32, qp, qp_c,
                                w, h, sbh, rdoq, lam_scale)

    rec_y = st["rec_y"][:h, :w]
    rec_u = st["rec_u"][:h // 2, :w // 2]
    rec_v = st["rec_v"][:h // 2, :w // 2]
    if deblock:
        bs_ver, bs_hor = bs_maps_from_depth(depth8, w, h)
        rec_y, rec_u, rec_v = deblock_ops.deblock_420_bs(
            rec_y, rec_u, rec_v, qp, bs_ver, bs_hor, block=8)

    out = dict(
        rec_y=rec_y.astype(jnp.uint8),
        rec_u=rec_u.astype(jnp.uint8),
        rec_v=rec_v.astype(jnp.uint8),
        # int16 is exact: levels are spec-clipped to 16 bits (7.4.9.11)
        coef_y=jnp.clip(st["coef_y"][:h, :w], -32768, 32767).astype(jnp.int16),
        coef_u=jnp.clip(st["coef_u"][:h // 2, :w // 2],
                        -32768, 32767).astype(jnp.int16),
        coef_v=jnp.clip(st["coef_v"][:h // 2, :w // 2],
                        -32768, 32767).astype(jnp.int16),
        depth8=depth8.astype(jnp.int8),
        m8=m8.astype(jnp.int8),
        m16=m16.astype(jnp.int8),
        m32=m32.astype(jnp.int8),
    )
    return out
