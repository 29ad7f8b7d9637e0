"""Device-side H.264 P-slice engine — the device port of the JM P hot
loop (VERDICT round-4 ask #4: the host python engine was 16x slower
than single-thread JM).

Two-phase design, mirroring models/hevc/inter_jax.py:

Phase 1 (device, one jit over the whole picture): full-search integer
ME + half/quarter SATD refinement with the H.264 6-tap/bilinear
filters for every 16x16 MB AND every 8x8 sub-block, P_16x16-vs-P_8x8
mode decision on coded residual cost (4x4 integer transform + quant +
recon on device), chroma 2x2-DC + AC coding — all MBs at once.

Phase 2 (host): spec-exact median MV prediction over the FINAL motion
field (inter_codec.mv_pred_part, shared with the decoder), P_Skip
detection, and CAVLC serialization of exactly the device-decided
levels.  The device recon is the decoder recon; approximation in the
device rate model only ever costs bits.

Parity: jm18.5/lencod/src/mv_search.c:143 (ME dispatch),
md_low.c (mode decision), lcommon/src/transform.c, quant4x4_normal.c,
mc_prediction.c; conformance = ldecod decodes the streams bit-exactly
(tests/test_h264_dev.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from video_codecs_tpu.entropy import cavlc
from video_codecs_tpu.models.h264 import inter_codec as pc
from video_codecs_tpu.models.h264.inter_codec import (
    H264Encoder, NcGrid, _code_residual_16, _NCBP_INTER_420,
    bs_maps_p, mv_pred_part, _commit_part, skip_mv, deblock_frame)
from video_codecs_tpu.ops import cost as cost_ops
from video_codecs_tpu.ops import h264_jax as hj
from video_codecs_tpu.ops import h264_transform as ht
from video_codecs_tpu.ops import me as me_ops

_BLK_X = pc._BLK_X
_BLK_Y = pc._BLK_Y


def _refine_h264(ref, cur, x0, y0, mvx, mvy, n, step):
    """One 8-neighbor refinement round at quarter-pel `step` with the
    H.264 interpolator + SATD (me_ops._refine twin)."""
    offs = me_ops._OFFS8
    best = cost_ops.hadamard_satd_8x8(
        cur, hj.mc_luma_dev(ref, x0, y0, mvx, mvy, n))
    for k in range(8):
        cx = mvx + int(offs[k][0]) * step
        cy = mvy + int(offs[k][1]) * step
        satd = cost_ops.hadamard_satd_8x8(
            cur, hj.mc_luma_dev(ref, x0, y0, cx, cy, n))
        better = satd < best
        best = jnp.where(better, satd, best)
        mvx = jnp.where(better, cx, mvx)
        mvy = jnp.where(better, cy, mvy)
    return mvx, mvy, best


def _me_grid(ref, y_plane, n: int, sr: int, w: int, h: int):
    """Full ME for every aligned n-block: integer full search + half +
    quarter refinement.  Returns (mvx, mvy, satd, bits-proxy) flat [B]."""
    bw, bh = w // n, h // n
    nb = bw * bh
    x0 = jnp.tile(jnp.arange(bw, dtype=jnp.int32) * n, bh)
    y0 = jnp.repeat(jnp.arange(bh, dtype=jnp.int32) * n, bw)
    cur = hj._gather(y_plane, x0, y0, n, n)
    imx, imy = me_ops.integer_search(ref, cur, x0, y0, n, sr)
    mvx, mvy = imx * 4, imy * 4
    mvx, mvy, _ = _refine_h264(ref, cur, x0, y0, mvx, mvy, n, 2)
    mvx, mvy, satd = _refine_h264(ref, cur, x0, y0, mvx, mvy, n, 1)
    gx = mvx.reshape(bh, bw)
    gy = mvy.reshape(bh, bw)
    px = jnp.concatenate([jnp.zeros((bh, 1), jnp.int32), gx[:, :-1]],
                         axis=1).reshape(nb)
    py = jnp.concatenate([jnp.zeros((bh, 1), jnp.int32), gy[:, :-1]],
                         axis=1).reshape(nb)
    from video_codecs_tpu.models.hevc.inter_jax import mvd_bits_dev
    bits = mvd_bits_dev(mvx - px, mvy - py)
    return mvx, mvy, satd, bits, x0, y0, cur


def _lv_bits(lv):
    """Coefficient-rate proxy per block batch [..., 4, 4] (bits)."""
    a = jnp.abs(lv).astype(jnp.float32)
    return (2.0 * jnp.sum(a > 0, axis=(-2, -1)) +
            2.0 * jnp.sum(jnp.log2(1.0 + a), axis=(-2, -1)))


@functools.partial(
    jax.jit, static_argnames=("qp", "w", "h", "sr", "lam"))
def encode_p_dev(y, u, v, ref_y, ref_u, ref_v,
                 qp: int, w: int, h: int, sr: int, lam: float):
    """One P picture on device: ME (16 + 8), P16/P8x8 decision on coded
    cost, residual transform/quant/recon, chroma DC+AC.  Returns maps
    + level planes + recon (pre-deblock)."""
    qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])
    mbw, mbh = w // 16, h // 16
    nmb = mbw * mbh
    yi = y.astype(jnp.int32)
    ui = u.astype(jnp.int32)
    vi = v.astype(jnp.int32)
    ry = ref_y.astype(jnp.int32)
    ru = ref_u.astype(jnp.int32)
    rv = ref_v.astype(jnp.int32)
    sl = lam ** 0.5

    m16x, m16y, satd16, bits16, x16, y16, cur16 = _me_grid(
        ry, yi, 16, sr, w, h)
    m8x, m8y, satd8, bits8, x8, y8, cur8 = _me_grid(ry, yi, 8, sr, w, h)

    # ---- luma residual coding for both hypotheses ----
    def code_luma(pred, cur):
        res = (cur - pred)
        n = cur.shape[-1]
        b = cur.shape[0]
        k = n // 4
        blk = res.reshape(b, k, 4, k, 4).transpose(0, 1, 3, 2, 4)
        lv = hj.quant_ac_dev(hj.fwd4x4_dev(blk), qp)
        r = hj.inv4x4_dev(hj.dequant_ac_dev(lv, qp))
        rec = jnp.clip(pred + r.transpose(0, 1, 3, 2, 4)
                       .reshape(b, n, n), 0, 255)
        d = jnp.sum((cur - rec).astype(jnp.float32) ** 2, axis=(-2, -1))
        bits = jnp.sum(_lv_bits(lv), axis=(-2, -1))
        return lv, rec, d, bits

    pred16 = hj.mc_luma_dev(ry, x16, y16, m16x, m16y, 16)
    lv16, rec16, d16, rb16 = code_luma(pred16, cur16)
    pred8 = hj.mc_luma_dev(ry, x8, y8, m8x, m8y, 8)
    lv8, rec8, d8, rb8 = code_luma(pred8, cur8)

    def sum4(a):
        g = a.reshape(mbh, 2, mbw, 2)
        return jnp.sum(g, axis=(1, 3)).reshape(nmb)

    lamf = jnp.float32(lam)
    j16 = d16 + lamf * (rb16 + (bits16 + 2).astype(jnp.float32))
    j8s = sum4(d8 + lamf * (rb8 + (bits8 + 3).astype(jnp.float32))) \
        + lamf * 4.0
    split8 = j8s < j16                                   # [nmb]

    # ---- final luma recon/levels planes ----
    s8g = split8.reshape(mbh, mbw)
    sel8 = s8g[y8 // 16, x8 // 16]

    def scatter(plane, vals, xs, ys, n, sel):
        rows = ys[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None, :,
                                                                  None]
        cols = xs[:, None, None] + jnp.arange(n, dtype=jnp.int32)[None,
                                                                  None, :]
        rows = jnp.where(sel[:, None, None], rows, plane.shape[0] + 7)
        return plane.at[rows, cols].set(vals, mode="drop")

    def lv_plane(lv, n):
        b = lv.shape[0]
        k = n // 4
        return lv.transpose(0, 1, 3, 2, 4).reshape(b, n, n)

    rec_y = scatter(jnp.zeros((h, w), jnp.int32), rec16, x16, y16, 16,
                    ~sel8[0:0].reshape(0) if False else ~s8g[y16 // 16,
                                                             x16 // 16])
    rec_y = scatter(rec_y, rec8, x8, y8, 8, sel8)
    coef_y = scatter(jnp.zeros((h, w), jnp.int32), lv_plane(lv16, 16),
                     x16, y16, 16, ~s8g[y16 // 16, x16 // 16])
    coef_y = scatter(coef_y, lv_plane(lv8, 8), x8, y8, 8, sel8)

    # ---- chroma: final assembled pred, 2x2 DC + AC ----
    cx16, cy16 = x16 // 2, y16 // 2
    fin8x = jnp.where(sel8, m8x, (m16x.reshape(mbh, mbw)
                                  [y8 // 16, x8 // 16]))
    fin8y = jnp.where(sel8, m8y, (m16y.reshape(mbh, mbw)
                                  [y8 // 16, x8 // 16]))
    predu4 = hj.mc_chroma_dev(ru, x8 // 2, y8 // 2, fin8x, fin8y, 4)
    predv4 = hj.mc_chroma_dev(rv, x8 // 2, y8 // 2, fin8x, fin8y, 4)
    # assemble per-MB 8x8 chroma pred from the four 4x4 sub-preds
    pu_pl = scatter(jnp.zeros((h // 2, w // 2), jnp.int32), predu4,
                    x8 // 2, y8 // 2, 4, jnp.ones_like(sel8))
    pv_pl = scatter(jnp.zeros((h // 2, w // 2), jnp.int32), predv4,
                    x8 // 2, y8 // 2, 4, jnp.ones_like(sel8))
    cur_u = hj._gather(ui, cx16, cy16, 8, 8)
    cur_v = hj._gather(vi, cx16, cy16, 8, 8)
    pu = hj._gather(pu_pl, cx16, cy16, 8, 8)
    pv = hj._gather(pv_pl, cx16, cy16, 8, 8)

    def code_chroma(co, cp):
        cres = co - cp
        cwt = hj.fwd4x4_dev(cres.reshape(-1, 2, 4, 2, 4)
                            .transpose(0, 1, 3, 2, 4))
        cdc = cwt[:, :, :, 0, 0]
        dc_q = hj.quant_chroma_dc_dev(hj.hadamard2x2_dev(cdc), qpc)
        acq = hj.quant_ac_dev(cwt, qpc).at[:, :, :, 0, 0].set(0)
        dc_deq = hj.dequant_chroma_dc_dev(dc_q, qpc)
        d = hj.dequant_ac_dev(acq, qpc).at[:, :, :, 0, 0].set(dc_deq)
        rec = jnp.clip(cp + hj.inv4x4_dev(d).transpose(0, 1, 3, 2, 4)
                       .reshape(-1, 8, 8), 0, 255)
        return dc_q, acq, rec

    dcu, acu, rec_u_b = code_chroma(cur_u, pu)
    dcv, acv, rec_v_b = code_chroma(cur_v, pv)
    ones = jnp.ones(nmb, bool)
    rec_u = scatter(jnp.zeros((h // 2, w // 2), jnp.int32), rec_u_b,
                    cx16, cy16, 8, ones)
    rec_v = scatter(jnp.zeros((h // 2, w // 2), jnp.int32), rec_v_b,
                    cx16, cy16, 8, ones)
    coef_u = scatter(jnp.zeros((h // 2, w // 2), jnp.int32),
                     acu.transpose(0, 1, 3, 2, 4).reshape(-1, 8, 8),
                     cx16, cy16, 8, ones)
    coef_v = scatter(jnp.zeros((h // 2, w // 2), jnp.int32),
                     acv.transpose(0, 1, 3, 2, 4).reshape(-1, 8, 8),
                     cx16, cy16, 8, ones)

    return dict(
        split8=s8g,
        mv16x=m16x.reshape(mbh, mbw), mv16y=m16y.reshape(mbh, mbw),
        mv8x=m8x.reshape(2 * mbh, 2 * mbw),
        mv8y=m8y.reshape(2 * mbh, 2 * mbw),
        coef_y=coef_y.astype(jnp.int16),
        coef_u=coef_u.astype(jnp.int16),
        coef_v=coef_v.astype(jnp.int16),
        dc_u=dcu.astype(jnp.int16), dc_v=dcv.astype(jnp.int16),
        rec_y=rec_y.astype(jnp.uint8),
        rec_u=rec_u.astype(jnp.uint8),
        rec_v=rec_v.astype(jnp.uint8),
    )


class DeviceH264Encoder(H264Encoder):
    """H.264 baseline encoder with the P-slice pixel pipeline on the device
    (ME + mode decision + transforms); host CAVLC phase 2."""

    def __init__(self, width: int, height: int, qp: int = 28,
                 search_range: int = 16, **kw) -> None:
        kw.setdefault("entropy", "cavlc")
        super().__init__(width, height, qp=qp,
                         search_range=search_range, **kw)
        assert self.entropy == "cavlc", "device path: CAVLC phase 2"
        assert not self.weighted_pred and not self.transform8x8
        self.att = getattr(self, "att", None)

    def _encode_p_frame(self, y, u, v, refs, frame_num, poc=None,
                        reorder_cmds=None, mmco=None):
        if len(refs) != 1 or reorder_cmds or mmco or self.att:
            from video_codecs_tpu.models.hevc.inter_jax import \
                _warn_host_fallback
            _warn_host_fallback(self, "P slice (multi-ref/MMCO/attention)")
            return super()._encode_p_frame(y, u, v, refs, frame_num,
                                           poc, reorder_cmds, mmco)
        qp = self.qp
        qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])
        mbw, mbh = self.w // 16, self.h // 16
        w4 = mbw * 4
        lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)

        st = encode_p_dev(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
            jnp.asarray(np.asarray(refs[0][0], np.int32)),
            jnp.asarray(np.asarray(refs[0][1], np.int32)),
            jnp.asarray(np.asarray(refs[0][2], np.int32)),
            qp=qp, w=self.w, h=self.h, sr=self.sr, lam=lam)
        st = {k: np.asarray(val) for k, val in st.items()}

        # ---- host phase: spec-exact median pred + CAVLC ----
        from video_codecs_tpu.entropy.bitstream import BitWriter
        w = BitWriter()
        w.ue(0)                  # first_mb_in_slice
        w.ue(5)                  # slice_type = P
        w.ue(0)                  # pps_id
        w.write(frame_num & 0xFF, 8)
        if poc is not None:
            w.write(poc & 0xFFFF, 16)
        w.flag(0)                # num_ref_idx_active_override
        w.flag(0)                # ref_pic_list_modification
        w.flag(0)                # adaptive_ref_pic_marking
        w.se(qp - 26)
        w.ue(0)                  # disable_deblocking_filter_idc
        w.se(0)
        w.se(0)

        nc_y = NcGrid(mbw * 4, mbh * 4)
        nc_u = NcGrid(mbw * 2, mbh * 2)
        nc_v = NcGrid(mbw * 2, mbh * 2)
        mvg = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        refg = np.full((mbh * 4, mbw * 4), -1, np.int32)
        dec4 = np.zeros((mbh * 4, mbw * 4), bool)
        intra_mb = np.zeros((mbh, mbw), bool)
        zz = cavlc.ZIGZAG_4x4
        coef_y = st["coef_y"].astype(np.int32)
        coef_u = st["coef_u"].astype(np.int32)
        coef_v = st["coef_v"].astype(np.int32)
        skip_run = 0

        for mby in range(mbh):
            for mbx in range(mbw):
                x, yy = mbx * 16, mby * 16
                gx, gy = mbx * 4, mby * 4
                sp8 = bool(st["split8"][mby, mbx])
                # partitions in decode order with spec median pred
                if sp8:
                    parts = []
                    for b8 in range(4):
                        ox, oy = (b8 & 1) * 8, (b8 >> 1) * 8
                        mv = (int(st["mv8x"][2 * mby + (b8 >> 1),
                                             2 * mbx + (b8 & 1)]),
                              int(st["mv8y"][2 * mby + (b8 >> 1),
                                             2 * mbx + (b8 & 1)]))
                        pmv = mv_pred_part(mvg, refg, dec4,
                                           gx + ox // 4, gy + oy // 4,
                                           2, 2, 0, "")
                        _commit_part(mvg, refg, dec4, gx, gy, ox, oy,
                                     8, 8, 0, mv)
                        parts.append((ox, oy, 8, 8, 0, mv, pmv))
                    mb_type_sel, subs = 3, [0, 0, 0, 0]
                else:
                    mv = (int(st["mv16x"][mby, mbx]),
                          int(st["mv16y"][mby, mbx]))
                    smv = skip_mv(mvg, refg, gx, gy, w4)
                    pmv = mv_pred_part(mvg, refg, dec4, gx, gy, 4, 4,
                                       0, "")
                    _commit_part(mvg, refg, dec4, gx, gy, 0, 0, 16, 16,
                                 0, mv)
                    parts = [(0, 0, 16, 16, 0, mv, pmv)]
                    mb_type_sel, subs = 0, None

                # cbp from the level planes
                lv = np.zeros((4, 4, 4, 4), np.int32)
                for by4 in range(4):
                    for bx4 in range(4):
                        lv[by4, bx4] = coef_y[yy + by4 * 4:yy + by4 * 4
                                              + 4, x + bx4 * 4:x + bx4
                                              * 4 + 4]
                cbp_luma = 0
                for i8 in range(4):
                    ids = [4 * i8 + k for k in range(4)]
                    if any(lv[_BLK_Y[i], _BLK_X[i]].any() for i in ids):
                        cbp_luma |= 1 << i8
                cx8, cy8 = mbx * 8, mby * 8
                c_dc_q = [st["dc_u"][mby * mbw + mbx].astype(np.int32),
                          st["dc_v"][mby * mbw + mbx].astype(np.int32)]
                c_ac_q = []
                for cpl in (coef_u, coef_v):
                    acq = np.zeros((2, 2, 4, 4), np.int32)
                    for by2 in range(2):
                        for bx2 in range(2):
                            acq[by2, bx2] = cpl[
                                cy8 + by2 * 4:cy8 + by2 * 4 + 4,
                                cx8 + bx2 * 4:cx8 + bx2 * 4 + 4]
                    c_ac_q.append(acq)
                cbp_chroma = 2 if any(q.any() for q in c_ac_q) else (
                    1 if any(q.any() for q in c_dc_q) else 0)
                cbp = cbp_luma | (cbp_chroma << 4)

                if not sp8 and cbp == 0 and parts[0][5] == smv:
                    skip_run += 1
                    for bx4 in range(4):
                        for by4 in range(4):
                            nc_y.set(gx + bx4, gy + by4, 0)
                    for comp in (nc_u, nc_v):
                        for b2 in range(4):
                            comp.set(mbx * 2 + (b2 & 1),
                                     mby * 2 + (b2 >> 1), 0)
                    continue

                w.ue(skip_run)
                skip_run = 0
                w.ue(mb_type_sel)
                if mb_type_sel == 3:
                    for s in subs:
                        w.ue(s)
                for (_, _, _, _, _, mv_, pmv_) in parts:
                    w.se(mv_[0] - pmv_[0])
                    w.se(mv_[1] - pmv_[1])
                w.ue(_NCBP_INTER_420[cbp])
                if cbp:
                    w.se(0)      # mb_qp_delta
                for i8 in range(4):
                    for k in range(4):
                        idx = 4 * i8 + k
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        if cbp_luma & (1 << i8):
                            _code_residual_16(w, lv[y4, x4], nc_y,
                                              gx + x4, gy + y4)
                        else:
                            nc_y.set(gx + x4, gy + y4, 0)
                if cbp_chroma:
                    for comp in (0, 1):
                        dcs = c_dc_q[comp]
                        cavlc.encode_block(
                            w, [int(dcs[0, 0]), int(dcs[0, 1]),
                                int(dcs[1, 0]), int(dcs[1, 1])], -1, 4)
                for comp, grid in ((0, nc_u), (1, nc_v)):
                    for idx in range(4):
                        x4, y4 = idx & 1, idx >> 1
                        if cbp_chroma == 2:
                            coeffs = c_ac_q[comp][y4, x4].reshape(16)[zz][1:]
                            total = cavlc.encode_block(
                                w, [int(c) for c in coeffs],
                                grid.nc(mbx * 2 + x4, mby * 2 + y4), 15)
                        else:
                            total = 0
                        grid.set(mbx * 2 + x4, mby * 2 + y4, total)

        if skip_run:
            w.ue(skip_run)
        w.rbsp_trailing_bits()

        rec_y = st["rec_y"].astype(np.int32)
        rec_u = st["rec_u"].astype(np.int32)
        rec_v = st["rec_v"].astype(np.int32)
        bs_ver, bs_hor = bs_maps_p(intra_mb, nc_y.tc, mvg, refg)
        rec_y, rec_u, rec_v = deblock_frame(rec_y, rec_u, rec_v, qp, qpc,
                                            bs_ver, bs_hor)
        self._prev_mvg = mvg.copy()
        self._prev_refg = refg.copy()
        return w.data(), (rec_y, rec_u, rec_v)
