"""Smoke run of the codec on GPU cards, through the engines' own entry points.

    python chip_smoke.py          # one card: phases 0-3
    python chip_smoke.py --four   # four cards: phase 0 and the tiled paths

  0. Device gate: JAX must see GPU devices, or the script exits non-zero.
     Prints the card's name and power limit and which CABAC serializer runs.
  1. Op parity: every device op at the shapes the engines use, against its
     host numpy twin.  Exact, except RDOQ's float RD decisions, which are
     held to the bound of tests/test_rdoq_jax.py.
  2. Headline: HEVC random access, GOP 8, 1920x1072 QP32 CTB32 (bench.py's
     configuration), 9 frames.  The stream must decode in GeneralDecoder
     with the MD5 hash SEI OK on every picture and the recon bit-exact;
     a second encode reports whether the stream is reproducible.
  3. The other device engines at their bench sizes, 3 frames each, decoded
     bit-exactly: all-intra quadtree 416x240, low-delay P 832x480, H.264 P
     slices 176x144.
  4. (--four) The tiled all-intra encoder over 4 cards against the same
     tiles on one card, and the tile-sharded random-access engine of
     __graft_entry__.dryrun_multichip, both byte for byte.

Seconds printed here are single calls, not a benchmark.  Nothing is
caught: a failure exits non-zero before the last line, which is one JSON
object {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

PLANE = (1072, 1920)      # (h, w) of the headline picture


def device_gate(devices=None) -> list:
    """The accelerator devices to run on; exits when JAX has no GPU."""
    import jax

    devs = jax.devices() if devices is None else devices
    if not devs or devs[0].platform != "gpu":
        kind = devs[0].platform if devs else "none"
        raise SystemExit(f"chip_smoke: JAX found no GPU (default backend: "
                         f"{kind}); refusing to run on another backend")
    return devs


def card_info() -> str:
    """nvidia-smi's name and power limit, read in a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _twice(fn, *args):
    """Run a device function twice; returns (host result, first-call s,
    second-call s).  The first call includes compilation."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t2 = time.perf_counter()
    return jax.device_get(out), t1 - t0, t2 - t1


def _count(plane, n: int) -> int:
    """Blocks of n x n in a plane of (h, w) samples."""
    return (plane[0] // n) * (plane[1] // n)


def _diff(a, b) -> int:
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a - b).max()) if a.size else 0


def _row(op, shape, diff, t1, t2, checked=None, **extra) -> dict:
    r = {"op": op, "shape": list(shape), "max_abs_diff": diff,
         "first_call_s": t1, "second_call_s": t2}
    if checked is not None:
        r["host_checked"] = checked
    r.update(extra)
    return r


def _sample(b: int, k: int) -> np.ndarray:
    """k block indices spread over [0, b), always including the first and
    last (edge-clamped blocks)."""
    return np.unique(np.linspace(0, b - 1, min(k, b)).astype(np.int64))


# ---------------------------------------------------------------------------
# Phase 1: op parity.  Each op_* returns rows with max_abs_diff; plane is
# the (h, w) picture whose block counts set the batch.
# ---------------------------------------------------------------------------

def op_transform(rng, plane=PLANE) -> list:
    import jax

    from video_codecs_tpu.ops import transform as tr

    rows = []
    for log2, dst in ((2, True), (2, False), (3, False), (4, False),
                      (5, False)):
        n = 1 << log2
        res = rng.integers(-255, 256, (_count(plane, n), n, n),
                           dtype=np.int32)
        fwd = jax.jit(functools.partial(tr.forward_transform,
                                        log2_size=log2, dst=dst))
        coef, t1, t2 = _twice(fwd, res)
        want = np.stack([tr.forward_transform_np(r, log2, dst=dst)
                         for r in res])
        name = f"forward_transform N={n}{' DST' if dst else ''}"
        rows.append(_row(name, res.shape, _diff(coef, want), t1, t2))
        inv = jax.jit(functools.partial(tr.inverse_transform,
                                        log2_size=log2, dst=dst))
        rec, t1, t2 = _twice(inv, want)
        want = np.stack([tr.inverse_transform_np(c, log2, dst=dst)
                         for c in want])
        rows.append(_row(name.replace("forward", "inverse"), res.shape,
                         _diff(rec, want), t1, t2))
    return rows


def op_quant(rng, plane=PLANE, qp: int = 32) -> list:
    import jax

    from video_codecs_tpu.ops import quant

    rows = []
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        coef = rng.integers(-32768, 32768, (_count(plane, n), n, n),
                            dtype=np.int32)
        q = jax.jit(functools.partial(quant.quantize, qp=qp, log2_size=log2,
                                      intra_slice=False))
        lv, t1, t2 = _twice(q, coef)
        want = quant.quantize_np(coef, qp, log2, intra_slice=False)
        rows.append(_row(f"quantize N={n} QP{qp}", coef.shape,
                         _diff(lv, want), t1, t2))
        dq = jax.jit(functools.partial(quant.dequantize, qp=qp,
                                       log2_size=log2))
        c, t1, t2 = _twice(dq, want)
        rows.append(_row(f"dequantize N={n} QP{qp}", coef.shape,
                         _diff(c, quant.dequantize_np(want, qp, log2)),
                         t1, t2))
    return rows


def intra_refs(rng, b: int, n: int, bit_depth: int) -> np.ndarray:
    """[b, 4n+1] reference arrays: all-zero, all-max, alternating 0/max
    and max/0 first, random samples after."""
    maxv = (1 << bit_depth) - 1
    ref = rng.integers(0, maxv + 1, (max(b, 4), 4 * n + 1), dtype=np.int32)
    alt = np.arange(4 * n + 1) % 2 * maxv
    ref[0], ref[1], ref[2], ref[3] = 0, maxv, alt, maxv - alt
    return ref


def op_intra(rng, plane=PLANE, host_blocks: int = 48) -> list:
    import jax

    from video_codecs_tpu.ops import intra

    rows = []
    cases = [(log2, True, bd) for bd in (8, 10) for log2 in (2, 3, 4, 5)]
    cases += [(log2, False, 8) for log2 in (2, 3, 4)]
    for log2, luma, bd in cases:
        n = 1 << log2
        ref = intra_refs(rng, _count(plane, n), n, bd)
        modes = np.broadcast_to(np.arange(35, dtype=np.int32),
                                (ref.shape[0], 35))
        fn = jax.jit(functools.partial(intra.predict_intra, log2_size=log2,
                                       is_luma=luma, bit_depth=bd))
        pred, t1, t2 = _twice(fn, ref, modes)
        idx = np.union1d(np.arange(4), _sample(ref.shape[0], host_blocks))
        want = np.stack([np.stack([intra.predict_intra_np(
            ref[i], m, log2, is_luma=luma, bit_depth=bd)
            for m in range(35)]) for i in idx])
        rows.append(_row(
            f"predict_intra N={n} {'luma' if luma else 'chroma'} "
            f"{bd}-bit, 35 modes", pred.shape, _diff(pred[idx], want),
            t1, t2, checked=f"{len(idx)} of {ref.shape[0]} blocks"))
    return rows


def op_mc(rng, plane=PLANE, host_blocks: int = 192) -> list:
    import jax

    from video_codecs_tpu.ops import interp

    rows = []
    for luma, n, scale, name in ((True, 16, 1, "mc_luma"),
                                 (False, 8, 2, "mc_chroma")):
        h, w = plane[0] // scale, plane[1] // scale
        ref = rng.integers(0, 256, (h, w), dtype=np.int32)
        gy, gx = np.meshgrid(np.arange(0, h - n + 1, n),
                             np.arange(0, w - n + 1, n), indexing="ij")
        x0, y0 = gx.ravel().astype(np.int32), gy.ravel().astype(np.int32)
        b = x0.size
        # quarter-pel luma MVs up to the headline's 64-sample range; every
        # fractional phase occurs and edge blocks read past the picture
        mvx = rng.integers(-256, 257, b, dtype=np.int32)
        mvy = rng.integers(-256, 257, b, dtype=np.int32)
        fn = jax.jit(functools.partial(
            interp.mc_luma if luma else interp.mc_chroma, n=n))
        pred, t1, t2 = _twice(fn, ref, x0, y0, mvx, mvy)
        twin = interp.mc_luma_np if luma else interp.mc_chroma_np
        idx = _sample(b, host_blocks)
        want = np.stack([twin(ref, int(x0[i]), int(y0[i]), int(mvx[i]),
                              int(mvy[i]), n) for i in idx])
        rows.append(_row(f"{name} {n}x{n}", pred.shape,
                         _diff(pred[idx], want), t1, t2,
                         checked=f"{len(idx)} of {b} blocks"))
    return rows


def hadamard_np(n: int) -> np.ndarray:
    h = np.array([[1]], np.int64)
    while h.shape[0] < n:
        h = np.kron(np.array([[1, 1], [1, -1]], np.int64), h)
    return h


def satd_np(a, b, t: int) -> np.ndarray:
    """SATD over t x t tiles of [..., H, W] blocks, rounded per tile as
    HM's xCalcHADs8x8 ((s + 2) >> 2) and xCalcHADs4x4 ((s + 1) >> 1)."""
    d = np.asarray(a, np.int64) - np.asarray(b, np.int64)
    hh, ww = d.shape[-2:]
    d = d.reshape(d.shape[:-2] + (hh // t, t, ww // t, t))
    d = np.swapaxes(d, -3, -2)
    hm = hadamard_np(t)
    s = np.abs(hm @ d @ hm).sum(axis=(-2, -1))
    s = (s + 2) >> 2 if t == 8 else (s + 1) >> 1
    return s.sum(axis=(-2, -1))


def op_satd(rng, plane=PLANE) -> list:
    import jax

    from video_codecs_tpu.ops import cost

    rows = []
    for t, blk, fn in ((8, 16, cost.hadamard_satd_8x8),
                       (4, 8, cost.hadamard_satd_4x4)):
        shape = (_count(plane, blk), blk, blk)
        a = rng.integers(0, 256, shape, dtype=np.int32)
        b = rng.integers(0, 256, shape, dtype=np.int32)
        got, t1, t2 = _twice(jax.jit(fn), a, b)
        rows.append(_row(f"satd {t}x{t} on {blk}x{blk} blocks", shape,
                         _diff(got, satd_np(a, b, t)), t1, t2))
    return rows


def blocky_planes(rng, plane, block: int = 16):
    """Recon-like planes: a flat value per block plus mild noise, so the
    deblocking decisions take both the filtered and unfiltered paths."""
    out = []
    h, w = plane
    for (ph, pw, bk) in ((h, w, block), (h // 2, w // 2, block // 2),
                         (h // 2, w // 2, block // 2)):
        base = rng.integers(40, 216, (ph // bk + 1, pw // bk + 1))
        p = np.repeat(np.repeat(base, bk, 0), bk, 1)[:ph, :pw]
        p = p + rng.integers(-3, 4, (ph, pw))
        out.append(np.clip(p, 0, 255).astype(np.int32))
    return out


def op_deblock(rng, plane=PLANE) -> list:
    import jax

    from video_codecs_tpu.ops import deblock

    cpu = jax.devices("cpu")[0]
    rows = []
    for qp in (32, 37):
        y, u, v = blocky_planes(rng, plane)
        fn = jax.jit(functools.partial(deblock.deblock_420, qp=qp))
        got, t1, t2 = _twice(fn, y, u, v)
        with jax.default_device(cpu):
            want = deblock.deblock_420_np(y, u, v, qp)
        diff = max(_diff(g, w_) for g, w_ in zip(got, want))
        changed = int(sum((np.asarray(g) != p).sum()
                          for g, p in zip(got, (y, u, v))))
        rows.append(_row(f"deblock_420 QP{qp} (twin on the CPU backend)",
                         y.shape, diff, t1, t2, samples_changed=changed))
    return rows


def op_h264_transform(rng, plane=PLANE) -> list:
    import jax

    from video_codecs_tpu.ops import h264_jax
    from video_codecs_tpu.ops import h264_transform as ht

    b = _count(plane, 4)
    res = rng.integers(-255, 256, (b, 4, 4), dtype=np.int32)
    got, t1, t2 = _twice(jax.jit(h264_jax.fwd4x4_dev), res)
    rows = [_row("h264 forward 4x4", res.shape,
                 _diff(got, ht.forward4x4(res)), t1, t2)]
    d = rng.integers(-4096, 4097, (b, 4, 4), dtype=np.int32)
    got, t1, t2 = _twice(jax.jit(h264_jax.inv4x4_dev), d)
    rows.append(_row("h264 inverse 4x4", d.shape,
                     _diff(got, ht.inverse4x4(d)), t1, t2))
    return rows


def rdoq_blocks(rng, n: int, qp: int) -> np.ndarray:
    """tests/test_rdoq_jax.py's coefficient mix: DC-corner decay at two
    spreads plus all-zero blocks."""
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    decay = 1.0 / (1.0 + 0.6 * (xx + yy))

    def mix(count, spread):
        c = rng.normal(0, spread, (count, n, n)) * decay
        return np.round(c).astype(np.int32)

    return np.concatenate([mix(20, 40 * 2 ** ((qp - 22) / 6)),
                           mix(20, 400), np.zeros((2, n, n), np.int32)])


RDOQ_BOUND = ("at most 2 source blocks differ; in each, |level diff| <= "
              "max(2, max |host level|)  (tests/test_rdoq_jax.py:51-52)")


def op_rdoq(rng, plane=PLANE, qp: int = 32) -> list:
    """Device RDOQ at the picture's TU count (the 42 test blocks cycled)
    against rdoq_np(adapt_ctx=False) on each source block."""
    import jax

    from video_codecs_tpu.ops import rdoq, rdoq_jax

    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    rows = []
    for log2, luma in ((4, True), (3, False), (3, True), (2, True),
                       (2, False)):
        n = 1 << log2
        src = rdoq_blocks(rng, n, qp)
        b = max(_count(plane, n), src.shape[0])
        blocks = src[np.arange(b) % src.shape[0]]
        fn = jax.jit(functools.partial(rdoq_jax.rdoq_dev, qp=qp,
                                       log2_size=log2, lam=lam,
                                       is_luma=luma, slice_type=0))
        got, t1, t2 = _twice(fn, blocks)
        want = np.stack([rdoq.rdoq_np(s, qp, log2, lam=lam, is_luma=luma,
                                      slice_type=0, adapt_ctx=False)
                         for s in src])
        d = np.abs(np.asarray(got, np.int64) -
                   want[np.arange(b) % src.shape[0]])
        bad = np.unique(np.nonzero(d.reshape(b, -1).max(axis=1))[0]
                        % src.shape[0])
        within = len(bad) <= 2 and all(
            d[np.arange(b) % src.shape[0] == i].max() <=
            max(2, np.abs(want[i]).max()) for i in bad)
        rows.append(_row(
            f"rdoq_dev N={n} {'luma' if luma else 'chroma'} QP{qp}",
            blocks.shape, int(d.max()), t1, t2,
            blocks_differ=int(len(bad)), within_bound=bool(within)))
    return rows


OPS = {
    "transform": op_transform,
    "quant": op_quant,
    "intra": op_intra,
    "mc": op_mc,
    "satd": op_satd,
    "deblock": op_deblock,
    "h264_transform": op_h264_transform,
    "rdoq": op_rdoq,
}


def row_ok(r: dict) -> bool:
    if "within_bound" in r:
        return r["within_bound"]
    return r["max_abs_diff"] == 0


def matmul_precision() -> str:
    """The f32 matmul precision in effect, and whether a default-precision
    f32 product on this device rounds its inputs to TF32."""
    import jax
    import jax.numpy as jnp

    a = np.full((256, 256), 1.0 + 2.0 ** -12, np.float32)
    b = np.eye(256, dtype=np.float32)
    got = np.asarray(jax.jit(jnp.matmul)(a, b))
    tf32 = not np.array_equal(got, a)
    return (f"jax_default_matmul_precision="
            f"{jax.config.jax_default_matmul_precision}; default-precision "
            f"f32 matmul {'rounds inputs to TF32' if tf32 else 'is full f32'}"
            f" on {jax.devices()[0].device_kind}")


def phase_ops(plane=PLANE, seed: int = 0) -> list:
    print(f"[1] op parity at the engines' shapes (seconds are single "
          f"calls, not a benchmark); intra einsum: {matmul_precision()}",
          flush=True)
    rng = np.random.default_rng(seed)
    rows = []
    for name, fn in OPS.items():
        for r in fn(rng, plane):
            print("    " + json.dumps(r), flush=True)
            rows.append(r)
    print(f"    rdoq bound: {RDOQ_BOUND}", flush=True)
    bad = [r["op"] for r in rows if not row_ok(r)]
    assert not bad, f"op parity failed: {bad}"
    return rows


# ---------------------------------------------------------------------------
# Phases 2 and 3: engines end to end, each stream decoded and compared
# ---------------------------------------------------------------------------

def check_hevc(stream: bytes, recons, n_frames: int) -> None:
    """Decode in GeneralDecoder: hash SEI OK on every picture, planes
    equal to the encoder's recon."""
    from video_codecs_tpu.models.hevc import decoder

    dec = decoder.GeneralDecoder()
    out = dec.decode(stream)
    assert len(out) == n_frames, (len(out), n_frames)
    assert dec.hash_status == [True] * n_frames, dec.hash_status
    for k, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(r[c]), np.asarray(o[c]),
                                          err_msg=f"frame {k} plane {c}")


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_headline(w: int = 1920, h: int = 1072, n: int = 9,
                   search_range: int = 64, card: str = "") -> dict:
    import jax

    from bench import psnr_y, ra_config, synth_clip
    from video_codecs_tpu.models.hevc import inter_qt

    print(f"[2] HEVC RA GOP-8 {w}x{h} QP32 CTB32 sr{search_range} cu8=off, "
          f"{n} frames, hash SEI on", flush=True)
    frames = synth_clip(w, h, n)
    enc = inter_qt.QtDeviceRandomAccessEncoder(
        ra_config(w, h, hash_sei=True), search_range=search_range, cu8=False)
    t0 = time.perf_counter()
    stream, recons = enc.encode_sequence_ra(frames)
    jax.block_until_ready(recons)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream2, recons2 = enc.encode_sequence_ra(frames)
    jax.block_until_ready(recons2)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    check_hevc(stream, recons, n)
    dec_s = time.perf_counter() - t0
    res = {"bytes": len(stream),
           "kbps_at_30fps": len(stream) * 8 * 30 / n / 1000,
           "y_psnr_db": psnr_y(frames, recons),
           "sha256": hashlib.sha256(stream).hexdigest(),
           "cold_pass_s_incl_compile": cold, "warm_pass_s": warm,
           "decode_check_s": dec_s,
           "peak_bytes_in_use": _peak_bytes(),
           "second_encode_identical": stream == stream2,
           "hash_sei_ok": f"{n}/{n}", "recon_bit_exact": True,
           "card": card}
    print("    " + json.dumps(res), flush=True)
    return res


def _engine_row(name, frames, stream, recons, t_enc, t_dec) -> dict:
    from bench import psnr_y

    r = {"engine": name, "frames": len(frames), "bytes": len(stream),
         "y_psnr_db": psnr_y(frames, recons),
         "sha256": hashlib.sha256(stream).hexdigest(),
         "encode_s_incl_compile": t_enc, "decode_check_s": t_dec}
    print("    " + json.dumps(r), flush=True)
    return r


def phase_engines(n: int = 3) -> list:
    """The bench's other engines at their bench sizes and configs."""
    from bench import intra_config, ldp_config, synth_clip
    from video_codecs_tpu.models.h264.inter_codec import H264Decoder
    from video_codecs_tpu.models.h264.inter_jax import DeviceH264Encoder
    from video_codecs_tpu.models.hevc import inter_jax, quadtree_codec

    print(f"[3] other device engines, {n} frames each", flush=True)
    rows = []

    w, h = 416, 240
    frames = synth_clip(w, h, n)
    t0 = time.perf_counter()
    stream, recons = quadtree_codec.QuadtreeFastEncoder(
        intra_config(w, h)).encode_sequence(frames)
    t1 = time.perf_counter()
    check_hevc(stream, recons, n)
    rows.append(_engine_row(f"QuadtreeFastEncoder all-intra {w}x{h} QP32",
                            frames, stream, recons, t1 - t0,
                            time.perf_counter() - t1))

    w, h = 832, 480
    frames = synth_clip(w, h, n)
    t0 = time.perf_counter()
    stream, recons = inter_jax.DeviceLowDelayEncoder(
        ldp_config(w, h), search_range=64).encode_sequence_ldp(frames)
    t1 = time.perf_counter()
    check_hevc(stream, recons, n)
    rows.append(_engine_row(f"DeviceLowDelayEncoder LD-P {w}x{h} QP32",
                            frames, stream, recons, t1 - t0,
                            time.perf_counter() - t1))

    w, h = 176, 144
    frames = synth_clip(w, h, n)
    t0 = time.perf_counter()
    stream, recons = DeviceH264Encoder(w, h, qp=28,
                                       search_range=16).encode_sequence(frames)
    t1 = time.perf_counter()
    out = H264Decoder().decode(stream)
    assert len(out) == n, (len(out), n)
    for k, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            np.testing.assert_array_equal(
                np.asarray(r[c], np.uint8), np.asarray(o[c], np.uint8),
                err_msg=f"h264 frame {k} plane {c}")
    rows.append(_engine_row(f"DeviceH264Encoder P CAVLC {w}x{h} QP28 "
                            f"(no hash SEI in H.264; recon compared)",
                            frames, stream, recons, t1 - t0,
                            time.perf_counter() - t1))
    return rows


# ---------------------------------------------------------------------------
# Phase 4 (--four): tiles over four cards against one card
# ---------------------------------------------------------------------------

def phase_four(tiles_size=(1920, 1072), ra_tile_w: int = 480,
               ra_h: int = 1056, ra_frames: int = 2, n_dev: int = 4) -> dict:
    """ra_frames: the IDR and the first B picture of the GOP by default;
    every further temporal layer compiles two more large device programs
    for each side (minutes apiece on the card)."""
    import jax
    from jax.sharding import Mesh

    from bench import synth_clip
    from video_codecs_tpu.models.hevc import headers
    from video_codecs_tpu.parallel import tiles

    import __graft_entry__

    devs = jax.devices()[:n_dev]
    assert len(devs) == n_dev, f"need {n_dev} devices, have {len(devs)}"
    w, h = tiles_size
    print(f"[4a] tiled all-intra {w}x{h}, {n_dev} uniform tile columns: "
          f"{n_dev} devices vs 1", flush=True)
    cfg = headers.HevcConfig(width=w, height=h, qp=32,
                             tile_columns=n_dev)
    frames = synth_clip(w, h, 2)
    t0 = time.perf_counter()
    s_n, rec_n = tiles.encode_sequence_tiles(
        cfg, frames, Mesh(np.array(devs), ("tile",)))
    t1 = time.perf_counter()
    s_1, rec_1 = tiles.encode_sequence_tiles(
        cfg, frames, Mesh(np.array(devs[:1]), ("tile",)))
    t2 = time.perf_counter()
    assert s_n == s_1, f"tiled stream differs: {len(s_n)} vs {len(s_1)}"
    check_hevc(s_n, rec_n, len(frames))
    res = {"tiles_bytes": len(s_n), "tiles_identical": True,
           "tiles_sha256": hashlib.sha256(s_n).hexdigest(),
           "tiles_n_dev_s": t1 - t0, "tiles_1_dev_s": t2 - t1}
    print("    " + json.dumps(res), flush=True)

    print(f"[4b] tile-sharded RA engine {ra_tile_w * n_dev}x{ra_h}, "
          f"{ra_frames} frames: {n_dev} devices vs the same tiles on 1",
          flush=True)
    t0 = time.perf_counter()
    res["ra"] = __graft_entry__.dryrun_multichip(n_dev, wt=ra_tile_w,
                                                 h=ra_h, n_frames=ra_frames)
    res["ra_s"] = time.perf_counter() - t0
    print(f"    ra_s {res['ra_s']:.1f}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card tiled paths")
    args = ap.parse_args(argv)

    # The host twin of deblocking is jnp code run on JAX's CPU backend:
    # keep that backend beside the card when the platform list is pinned.
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    devs = device_gate()
    from video_codecs_tpu.entropy import native
    from video_codecs_tpu.utils import jax_cache

    cache = jax_cache.enable()
    card = card_info()
    print(f"[0] jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}; "
          f"compile cache {cache}", flush=True)
    print(f"    nvidia-smi: {card}", flush=True)
    print(f"    CABAC: intra slices "
          f"{'native C++ (csrc/cabac_enc.cpp)' if native.available() else 'Python (native build failed)'}"
          f"; inter slices Python", flush=True)
    if args.four:
        phase_four()
        count = 4
    else:
        phase_ops()
        phase_headline(card=card)
        phase_engines()
        count = 1
    # the card's name and power limit, on the line before the result
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
