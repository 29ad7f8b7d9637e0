"""Device (batched) full RDOQ — the device twin of ops/rdoq.rdoq_np.

Behavioral parity: hm-16.5rc1/source/Lib/TLibCommon/TComTrQuant.cpp
xRateDistOptQuant (:2129) with xGetCodedLevel / xGetICRate /
xGetRateLast / xGetRateSigCoeffGroup, using a STATIC per-TU context
snapshot for rate estimation (exactly HM's estBits behavior, and
bit-for-bit `rdoq_np(..., adapt_ctx=False)`):

  1. per-coefficient {0, maxAbs-1, maxAbs} level choice with
     fractional-bit CABAC rates (ENTROPY_BITS table) — a nested
     lax.scan: outer over coefficient groups in reverse scan order
     (carries the decided CG-significance raster map the sig-flag
     context pattern needs, and prev_c1 for the gt1 context set),
     inner over the 16 positions of a CG (carries c1/c1_idx/c2_idx и
     the Golomb-Rice parameter) — every carried state is a [B] vector,
     so thousands of TUs run the same 256 scan steps in lockstep;
  2. CG zero-out against the coded_sub_block_flag rate (prefix sums);
  3. last-significant-position optimization + whole-block zero as
     cumulative-sum argmin over scan positions (fully parallel).

All rate tables (sig ctx per scan position x neighbor pattern, gt1/gt2
per context set, last-position prefix, CG flags) are precomputed on host
per (qp, log2, luma, slice_type) and closed over as constants — the
device sees only gathers from tiny LUTs.  Decisions affect only encoder
quality, never stream validity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.entropy import ctx as ctx_mod
from video_codecs_tpu.entropy import residual
from video_codecs_tpu.ops import quant as quant_ops
from video_codecs_tpu.ops.rdoq import ENTROPY_BITS, _SCALE_BITS
from video_codecs_tpu.utils import rom

_BYPASS = 1 << _SCALE_BITS
# plain float, NOT jnp.float32: this module is lazily imported from
# inside jitted functions, and a module-level jnp value created during
# a trace is a TRACER that poisons every later trace (buffer-count
# dispatch errors).  Never create jnp values at import time here.
_INF = 1e30


@functools.lru_cache(maxsize=None)
def _tables(qp: int, log2_size: int, is_luma: bool, slice_type: int,
            scan_type: int):
    """Host-side per-config rate tables (all numpy, hashable inputs)."""
    n = 1 << log2_size
    nn = n * n
    states = ctx_mod.init_states(slice_type, qp)
    ent = ENTROPY_BITS

    def fb(c):
        s = int(states[c])
        return (int(ent[s]), int(ent[s ^ 1]))

    scan = rom.scan_order(log2_size, scan_type)           # scan -> raster
    cg_scan = rom.cg_scan_order(log2_size, scan_type)
    inner = rom.scan_order(2, scan_type)
    cg_w = max(n >> 2, 1)
    num_cg = nn >> 4

    first_ctx = residual.first_sig_map_ctx(log2_size, scan_type, is_luma)
    single = first_ctx == residual._SIG_START[is_luma]["single"]
    sig_base = ctx_mod.off("sig_flag", 0 if is_luma else 28)

    # sig-flag (bits0, bits1) per (neighbor CG pattern, scan position)
    sig_bits = np.zeros((4, nn, 2), np.int32)
    for i in range(nn):
        cg_i = i >> 4
        cg_raster = int(cg_scan[cg_i])
        cg_y, cg_x = divmod(cg_raster, cg_w)
        r_in = int(inner[i & 15])
        py, px = divmod(r_in, 4)
        pos_x, pos_y = (cg_x << 2) + px, (cg_y << 2) + py
        for pattern in range(4):
            if single:
                sc = first_ctx
            elif pos_x + pos_y == 0:
                sc = 0
            elif log2_size == 2:
                sc = first_ctx + int(
                    residual.CTX_IND_MAP_4x4[4 * pos_y + pos_x])
            else:
                sc = residual.sig_ctx_inc(pattern, pos_x, pos_y,
                                          log2_size, is_luma, first_ctx)
            sig_bits[pattern, i] = fb(sig_base + sc)

    one_base = ctx_mod.off("one_flag", 0 if is_luma else 16)
    abs_base = ctx_mod.off("abs_flag", 0 if is_luma else 4)
    gt1_bits = np.zeros((4, 4, 2), np.int32)   # [ctx_set, c1, (b0,b1)]
    gt2_bits = np.zeros((4, 2), np.int32)
    for cs in range(4):
        for c1 in range(4):
            gt1_bits[cs, c1] = fb(one_base + cs * 4 + c1)
        gt2_bits[cs] = fb(abs_base + cs)

    cg_base = ctx_mod.off("sig_cg", 0 if is_luma else 2)
    cg_bits = np.array([fb(cg_base), fb(cg_base + 1)], np.int32)  # [ctx,2]

    # last-position rate per scan position (static)
    loff, lshift = residual._last_ctx_params(log2_size, is_luma)
    bx, by = ctx_mod.off("last_x"), ctx_mod.off("last_y")
    max_group = (log2_size << 1) - 1
    lx_bits = [fb(bx + loff + (i >> lshift)) for i in range(max_group)]
    ly_bits = [fb(by + loff + (i >> lshift)) for i in range(max_group)]

    def rate_last(pos_x, pos_y):
        gx = int(residual.GROUP_IDX[pos_x])
        gy = int(residual.GROUP_IDX[pos_y])
        rate = 0
        for i in range(gx):
            rate += lx_bits[i][1]
        if gx < max_group:
            rate += lx_bits[gx][0]
        for i in range(gy):
            rate += ly_bits[i][1]
        if gy < max_group:
            rate += ly_bits[gy][0]
        if gx > 3:
            rate += ((gx >> 1) - 1) << _SCALE_BITS
        if gy > 3:
            rate += ((gy >> 1) - 1) << _SCALE_BITS
        return rate

    rate_last_tab = np.zeros(nn, np.int32)
    for p in range(nn):
        raster = int(scan[p])
        ly_, lx_ = divmod(raster, n)
        if scan_type == rom.SCAN_VER:
            lx_, ly_ = ly_, lx_
        rate_last_tab[p] = rate_last(lx_, ly_)

    # CG raster neighbors (right / below) for the sig pattern + cg ctx
    ngh_right = np.full(num_cg, -1, np.int32)
    ngh_below = np.full(num_cg, -1, np.int32)
    for cg_raster in range(num_cg):
        cg_y, cg_x = divmod(cg_raster, cg_w)
        if cg_x + 1 < cg_w:
            ngh_right[cg_raster] = cg_raster + 1
        if cg_y + 1 < cg_w:
            ngh_below[cg_raster] = cg_raster + cg_w

    return dict(scan=scan, cg_scan=np.asarray(cg_scan, np.int32),
                sig_bits=sig_bits, gt1_bits=gt1_bits, gt2_bits=gt2_bits,
                cg_bits=cg_bits, rate_last_tab=rate_last_tab,
                ngh_right=ngh_right, ngh_below=ngh_below)


@functools.lru_cache(maxsize=None)
def _tables_np(qp: int, log2_size: int, is_luma: bool, slice_type: int,
               scan_type: int):
    """Numpy views of the rate tables in the layouts the scan wants."""
    t = _tables(qp, log2_size, is_luma, slice_type, scan_type)
    num_cg = (1 << (2 * log2_size)) >> 4
    cis_np = np.arange(num_cg - 1, -1, -1, dtype=np.int32)
    cg_np = t["cg_scan"]
    return dict(
        scan=np.asarray(t["scan"], np.int32),
        sig_cg_tab=np.ascontiguousarray(
            t["sig_bits"].reshape(4, num_cg, 16, 2)
            .transpose(1, 0, 2, 3)[cis_np]),
        gt1_flat=np.ascontiguousarray(t["gt1_bits"].reshape(16, 2)),
        gt2_tab=t["gt2_bits"],
        cg_bits=t["cg_bits"],
        rate_last=t["rate_last_tab"].astype(np.float32),
        cis=cis_np,
        cg_rev=np.ascontiguousarray(cg_np[cis_np]),
        ngr_rev=np.ascontiguousarray(t["ngh_right"][cg_np[cis_np]]),
        ngb_rev=np.ascontiguousarray(t["ngh_below"][cg_np[cis_np]]),
        js_rev=np.arange(15, -1, -1, dtype=np.int32),
        cis_np=cis_np)


def _tables_dev(qp: int, log2_size: int, is_luma: bool, slice_type: int,
                scan_type: int):
    """Per-trace jnp constants from the cached numpy tables (fresh
    conversion each call — cached CONCRETE jnp constants break jax-0.9
    cache-hit dispatch, see utils/devconst.py)."""
    t = _tables_np(qp, log2_size, is_luma, slice_type, scan_type)
    return {k: (v if k == "cis_np" else jnp.asarray(v))
            for k, v in t.items()}


def _floor_log2(x):
    """floor(log2(x)) for int32 x >= 1 without clz (f32 + exact fixup)."""
    k = jnp.floor(jnp.log2(x.astype(jnp.float32))).astype(jnp.int32)
    k = jnp.where((1 << jnp.maximum(k, 0)) > x, k - 1, k)
    k = jnp.where((2 << jnp.maximum(k, 0)) <= x, k + 1, k)
    return k


def _rate_level_dev(level, one_b, abs_b, rice, c1_idx, c2_idx):
    """Vector xGetICRate: frac bits for abs level >= 1 ([B] int32).

    one_b/abs_b: [B, 2] live gt1/gt2 context bits; rice/c1_idx/c2_idx [B].
    """
    base = jnp.where(c1_idx < 8, jnp.where(c2_idx == 0, 3, 2), 1)
    rate = jnp.full(level.shape, _BYPASS, jnp.int32)      # sign bypass

    symbol = level - base
    short = symbol < (3 << rice)
    len_short = (symbol >> rice) + 1 + rice
    value = jnp.maximum(symbol - (3 << rice), 0)
    # escape: k = floor(log2(value + 2^rice)); len = 4 + 2k - rice
    k = _floor_log2(jnp.maximum(value + (1 << rice), 1))
    len_esc = 4 + 2 * k - rice
    esc_len = jnp.where(short, len_short, len_esc)
    ge_base = level >= base
    rate += jnp.where(ge_base, esc_len << _SCALE_BITS, 0)
    in_c1 = c1_idx < 8
    rate += jnp.where(ge_base & in_c1, one_b[:, 1], 0)
    rate += jnp.where(ge_base & in_c1 & (c2_idx == 0), abs_b[:, 1], 0)
    # the ==1/==2 special cases only apply below base_level (host order)
    rate = jnp.where(~ge_base & (level == 1), _BYPASS + one_b[:, 0], rate)
    rate = jnp.where(~ge_base & (level == 2),
                     _BYPASS + one_b[:, 1] + abs_b[:, 0], rate)
    return rate


def rdoq_dev(coeff: jnp.ndarray, qp: int, log2_size: int, *, lam: float,
             scan_type: int = rom.SCAN_DIAG, is_luma: bool = True,
             slice_type: int = 2, bit_depth: int = 8,
             allow_all_zero: bool = True, return_rate: bool = False):
    """Full RDOQ of [B, N, N] int32 coefficient blocks -> levels.

    Static args: qp/log2_size/lam/flags (close over jit).  Matches
    rdoq_np(..., adapt_ctx=False) up to f32-vs-f64 cost tie-breaks.
    With return_rate=True also returns the estimated CABAC rate of the
    emitted levels per block ([B] f32 bits) — the exact-rate source for
    CU/TU tree decisions (HM TEncBinCABACCounter parity).
    """
    n = 1 << log2_size
    nn = n * n
    num_cg = nn >> 4
    t = _tables(qp, log2_size, bool(is_luma), slice_type, scan_type)
    td = _tables_dev(qp, log2_size, bool(is_luma), slice_type, scan_type)

    per, rem = qp // 6, qp % 6
    q_bits = rom.QUANT_SHIFT + per + quant_ops.transform_shift(
        log2_size, bit_depth)
    scale = int(rom.QUANT_SCALES[rem])
    lam_td = float(lam) * float(4 ** (15 - bit_depth - log2_size))
    err_scale = 1.0 / (float(scale) * float(scale))
    lam_bits = jnp.float32(lam_td / (1 << _SCALE_BITS))

    b = coeff.shape[0]
    flat = coeff.reshape(b, nn)
    c_scan = flat[:, td["scan"]].astype(jnp.int32)
    sign = jnp.sign(c_scan)
    ld = jnp.abs(c_scan) * scale                          # level_double
    max_abs = jnp.minimum((ld + (1 << (q_bits - 1))) >> q_bits, 32767)
    pos_r = jnp.arange(nn, dtype=jnp.int32)
    any_nz = jnp.any(max_abs > 0, axis=1)
    last_pos = jnp.max(jnp.where(max_abs > 0, pos_r[None], -1), axis=1)
    last_cg = last_pos >> 4

    ldf = ld.astype(jnp.float32)
    d0 = ldf * ldf * jnp.float32(err_scale)               # [B, nn]

    # reshape to CG-major [num_cg, B, 16] for the outer scan
    def cgm(a):
        return jnp.moveaxis(a.reshape(b, num_cg, 16), 0, 1)

    ma_cg = cgm(max_abs)
    ld_cg = cgm(ldf)
    d0_cg = cgm(d0)
    gt2_tab = td["gt2_tab"]
    cg_bits = td["cg_bits"]
    gt1_flat = td["gt1_flat"]

    def cg_step(carry, xs):
        cg_sig_map, prev_c1 = carry       # [B, num_cg] raster, [B]
        cg_i, ma_c, ld_c, d0_c, sig_c, cg_raster, ngr, ngb = xs
        cg_ar = jnp.arange(num_cg, dtype=jnp.int32)
        right = jnp.where(ngr >= 0, jnp.sum(
            cg_sig_map * (cg_ar == jnp.maximum(ngr, 0))[None, :],
            axis=1), 0)
        below = jnp.where(ngb >= 0, jnp.sum(
            cg_sig_map * (cg_ar == jnp.maximum(ngb, 0))[None, :],
            axis=1), 0)
        pattern = right + 2 * below                       # [B]

        base_set = 0 if not is_luma else 2
        ctx_set = (jnp.where(cg_i == 0, 0, base_set) +
                   (prev_c1 == 0).astype(jnp.int32))      # [B]
        abs_b = gt2_tab[ctx_set]                          # [B, 2]

        # inner 16 positions, reverse scan order, as a nested lax.scan
        # (an unrolled python loop multiplied compile time ~10x)
        def pos_step(pcarry, pxs):
            c1, c1_idx, c2_idx, rice = pcarry             # [B] each
            j, ma_p, ld_p, d0_p, sig_p = pxs
            p = cg_i * 16 + j
            active = p <= last_pos
            is_last = p == last_pos
            sb = sig_p[pattern]                           # [B, 2]
            sb0 = jnp.where(is_last, 0, sb[:, 0])
            sb1 = jnp.where(is_last, 0, sb[:, 1])

            one_b = gt1_flat[ctx_set * 4 + jnp.minimum(c1, 3)]

            j0 = d0_p + lam_bits * sb0.astype(jnp.float32)

            def dist(lvl):
                d = ld_p - (lvl << q_bits).astype(jnp.float32)
                return d * d * jnp.float32(err_scale)

            l_lo = jnp.maximum(1, ma_p - 1)
            l_hi = ma_p
            r_lo = _rate_level_dev(l_lo, one_b, abs_b, rice, c1_idx,
                                   c2_idx)
            r_hi = _rate_level_dev(l_hi, one_b, abs_b, rice, c1_idx,
                                   c2_idx)
            j_lo = dist(l_lo) + lam_bits * (sb1 + r_lo).astype(jnp.float32)
            j_hi = dist(l_hi) + lam_bits * (sb1 + r_hi).astype(jnp.float32)

            has = ma_p > 0
            best_l = jnp.zeros_like(ma_p)
            best_j = j0
            take_lo = has & (j_lo < best_j)
            best_l = jnp.where(take_lo, l_lo, best_l)
            best_j = jnp.where(take_lo, j_lo, best_j)
            take_hi = has & (l_hi != l_lo) & (j_hi < best_j)
            best_l = jnp.where(take_hi, l_hi, best_l)
            best_j = jnp.where(take_hi, j_hi, best_j)

            best_l = jnp.where(active, best_l, 0)
            cost_c = jnp.where(active, best_j, 0.0)
            cost_s = jnp.where(
                active,
                lam_bits * jnp.where(best_l > 0, sb1, sb0)
                .astype(jnp.float32), 0.0)

            # context-state evolution (mirrors rdoq_np exactly)
            nz = best_l > 0
            in_c1 = c1_idx < 8
            gt1 = best_l > 1
            c2_n = jnp.where(nz & in_c1 & gt1, 1, c2_idx)
            c1_n = jnp.where(nz & in_c1 & gt1, 0,
                             jnp.where(nz & in_c1 & (c1 > 0) & (c1 < 3),
                                       c1 + 1, c1))
            c1i_n = jnp.where(nz & in_c1, c1_idx + 1, c1_idx)
            rice_n = jnp.where(nz & (best_l > (3 << rice)),
                               jnp.minimum(rice + 1, 4), rice)
            return ((c1_n, c1i_n, c2_n, rice_n),
                    (best_l, cost_c, cost_s))

        zero_b = jnp.zeros(b, jnp.int32)
        init_p = (jnp.ones(b, jnp.int32), zero_b, zero_b, zero_b)
        js = td["js_rev"]
        (c1, _, _, _), outs = jax.lax.scan(
            pos_step, init_p,
            (js, ma_c[:, js].T, ld_c[:, js].T, d0_c[:, js].T,
             jnp.moveaxis(sig_c[:, js], 1, 0)))
        lv_cg = jnp.flip(outs[0], 0).T                    # [B, 16]
        cc_cg = jnp.flip(outs[1], 0).T
        cs_cg = jnp.flip(outs[2], 0).T
        cg_has = jnp.any(lv_cg > 0, axis=1)

        # CG zero-out (only 0 < cg_i < last_cg)
        cg_ctx = ((right + below) > 0).astype(jnp.int32)
        bits_pair = cg_bits[cg_ctx]                       # [B, 2]
        j_keep = jnp.sum(cc_cg, axis=1) + \
            lam_bits * bits_pair[:, 1].astype(jnp.float32)
        j_zero = jnp.sum(d0_c, axis=1) + \
            lam_bits * bits_pair[:, 0].astype(jnp.float32)
        in_range = (cg_i > 0) & (cg_i < last_cg)
        zero_out = in_range & cg_has & (j_zero < j_keep)
        lv_cg = jnp.where(zero_out[:, None], 0, lv_cg)
        cc_cg = jnp.where(zero_out[:, None], d0_c, cc_cg)
        cs_cg = jnp.where(zero_out[:, None], 0.0, cs_cg)
        cg_sig = jnp.where(zero_out, 0, cg_has.astype(jnp.int32))

        # one-hot update (dynamic .at[] indexing inside scan lowers badly)
        onehot = (jnp.arange(num_cg, dtype=jnp.int32) == cg_raster)
        cg_sig_map = jnp.where(onehot[None, :], cg_sig[:, None],
                               cg_sig_map)
        return (cg_sig_map, c1), (lv_cg, cc_cg, cs_cg)

    cis = td["cis"]
    init_carry = (jnp.zeros((b, num_cg), jnp.int32), jnp.ones(b, jnp.int32))
    _, (lv_s, cc_s, cs_s) = jax.lax.scan(
        cg_step, init_carry,
        (cis, ma_cg[cis], ld_cg[cis], d0_cg[cis],
         td["sig_cg_tab"], td["cg_rev"], td["ngr_rev"], td["ngb_rev"]))
    # stacked in reverse cg order -> restore ascending, then flatten
    levels = jnp.moveaxis(jnp.flip(lv_s, 0), 0, 1).reshape(b, nn)
    cost_coeff = jnp.moveaxis(jnp.flip(cc_s, 0), 0, 1).reshape(b, nn)
    cost_sig = jnp.moveaxis(jnp.flip(cs_s, 0), 0, 1).reshape(b, nn)

    # ---- last-position optimization ----
    prefix = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.float32), jnp.cumsum(cost_coeff, axis=1)],
        axis=1)
    suffix_zero = jnp.concatenate(
        [jnp.cumsum(d0[:, ::-1], axis=1)[:, ::-1],
         jnp.zeros((b, 1), jnp.float32)], axis=1)
    rate_last = td["rate_last"]
    totals = (prefix[:, :nn] + (cost_coeff - cost_sig) +
              lam_bits * rate_last[None] + suffix_zero[:, 1:])
    totals = jnp.where(levels > 0, totals, jnp.float32(_INF))
    # host iterates high->low with strict '<': ties keep the higher p
    best_last = nn - 1 - jnp.argmin(totals[:, ::-1], axis=1)
    best_total = jnp.min(totals, axis=1)

    keep = pos_r[None] <= best_last[:, None]
    levels = jnp.where(keep, levels, 0)
    chosen_total = best_total
    if allow_all_zero:
        total_zero = suffix_zero[:, 0]
        all_zero = total_zero < best_total
        levels = jnp.where(all_zero[:, None], 0, levels)
        chosen_total = jnp.where(all_zero, total_zero, chosen_total)
    levels = jnp.where(any_nz[:, None], levels, 0)
    chosen_total = jnp.where(any_nz, chosen_total, 0.0)

    out = jnp.zeros((b, nn), jnp.int32)
    out = out.at[:, td["scan"]].set(levels * sign)
    out = out.reshape(b, n, n)
    if not return_rate:
        return out
    # estimated CABAC rate of the chosen levels (fractional bits):
    # chosen_total = dist + lam_bits * rate  =>  rate = (J - D) / lam
    dqf = (levels << q_bits).astype(jnp.float32)
    dist_fin = jnp.where(levels > 0, (ldf - dqf) ** 2 *
                         jnp.float32(err_scale), d0)
    bits = (chosen_total - jnp.sum(dist_fin, axis=1)) / \
        (lam_bits * (1 << _SCALE_BITS))
    return out, jnp.maximum(bits, 0.0)
