"""Driver benchmark — prints the JSON line {"metric", "value", "unit",
"vs_baseline"}.

Round 5 structure (fixes the round-4 rc=124 timeout that lost every
number): the NORTH-STAR config — 1080p random-access hierarchical-B
(GOP-8) on the device CTB32 inter quadtree
(inter_qt.QtDeviceRandomAccessEncoder) — runs FIRST and its headline
JSON line is printed (and flushed) the moment it completes, so a driver
timeout can never lose the headline again.  Secondary configs
(BASELINE.md rows 1-2 + real-content foreman + JM H.264) then run one
at a time, each guarded by a wall-clock budget check, and the line is
re-printed augmented after each one finishes; the driver parses the
LAST (most complete) line in the tail, and any truncation only loses
secondaries.

A persistent XLA compilation cache (utils/jax_cache.py:
JAX_COMPILATION_CACHE_DIR, else .jax_cache/ in the checkout) makes the
warm-up pass cheap on every run after the first on a given machine.

Baseline: HM-16.5 TAppEncoderStatic single-thread
encoder_randomaccess_main.cfg on a 2-vCPU host CPU = 0.0207 fps
(BASELINE.md row 3, 2026-08-19); the HM_* / JM_* constants below are
host-CPU runs of the reference encoders.  `extra` carries kbps AND
Y-PSNR per config so quality regressions surface round-to-round.

Env knobs:
  VCT_BENCH_CONFIGS   comma list of ra,intra,ldp,foreman,jm (default all)
  VCT_BENCH_BUDGET_S  wall-clock budget in seconds (default 2100); a
                      secondary config only starts while under budget
"""

import json
import os
import sys
import time

import numpy as np

HM_RA_1080_FPS = 0.0207
HM_INTRA_FPS = 1.2505
HM_LDP_FPS = 0.103
JM_BASELINE_FPS = 22.6

T0 = time.time()


def synth_clip(w, h, n, seed=42):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    tex = rng.integers(-24, 25, (h, w))
    frames = []
    for f in range(n):
        y = np.clip(((xx * 3 + yy * 2 + f * 7) % 256) * 0.7 + tex + 30 +
                    20 * np.sin(2 * np.pi * (xx + 8 * f) / 64),
                    0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(2 * np.pi * (xx[::2, ::2] + 4 * f)
                                      / 128), 0, 255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(2 * np.pi * (yy[::2, ::2] + 4 * f)
                                      / 128), 0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def ra_config(w, h, hash_sei=False):
    """The RA GOP-8 CTB32 quadtree configuration of the headline (QP32);
    rate measurements run without the 432-bit hash SEI per picture."""
    from video_codecs_tpu.models.hevc import headers

    return headers.HevcConfig(width=w, height=h, qp=32, log2_ctb=5,
                              log2_min_cb=3, log2_max_tb=5,
                              reorder_pics=3, sign_data_hiding=True,
                              rdoq="lite", merge_cands=5, hash_sei=hash_sei,
                              temporal_mvp=True)


def intra_config(w, h):
    """All-intra device quadtree, QP32 (config 1)."""
    from video_codecs_tpu.models.hevc import headers

    return headers.HevcConfig(width=w, height=h, qp=32, log2_ctb=5,
                              log2_min_cb=3, log2_max_tb=5,
                              sign_data_hiding=True, rdoq="lite")


def ldp_config(w, h):
    """Low-delay P, 4 refs, merge-5 + TMVP, QP32 (config 2)."""
    from video_codecs_tpu.models.hevc import headers

    return headers.HevcConfig(width=w, height=h, qp=32, num_refs=4,
                              merge_cands=5, temporal_mvp=True,
                              sign_data_hiding=True)


def psnr_y(frames, recs):
    import math
    a = np.concatenate([f[0].astype(np.float64).ravel() for f in frames])
    b = np.concatenate([np.asarray(r[0], np.float64).ravel()
                        for r in recs])
    return 10 * math.log10(255 ** 2 / np.mean((a - b) ** 2))


def bench_ra_1080():
    """North star: 1080p RA GOP-8 on the device CTB32 inter quadtree
    (skip/residual CU32 tree + TU8 RQT + full RDOQ + HM lambda ladder)."""
    from video_codecs_tpu.models.hevc import inter_qt

    frames = synth_clip(1920, 1072, 9)
    cfg = ra_config(1920, 1072)
    # cu8=False on the 1080p headline: the CU8 tree is the dominant
    # new device cost (4x blocks of 8-grid ME + TU8/4x4 residual
    # trials) and measures BD-neutral on the real-content sweep
    # (foreman: identical bits with/without), so the headline runs the
    # faster operating point; the foreman quality row keeps cu8 on.
    enc = inter_qt.QtDeviceRandomAccessEncoder(cfg, search_range=64,
                                               cu8=False)
    enc.encode_sequence_ra(frames)            # compile + warm caches
    t0 = time.time()
    stream, recons = enc.encode_sequence_ra(frames)
    fps = len(frames) / (time.time() - t0)
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    return fps, kbps, psnr_y(frames, recons)


def bench_ra_foreman():
    """RA GOP-8 on real content (foreman fixture cycled to 9 frames)."""
    from video_codecs_tpu.models.hevc import inter_qt
    from video_codecs_tpu.utils import yuv

    path = "/root/reference/jm18.5/bin/foreman_part_qcif.yuv"
    ys, us, vs = yuv.read_frames(path, 176, 144)
    cyc = [0, 1, 2, 1]
    frames = [(ys[cyc[i % 4]], us[cyc[i % 4]], vs[cyc[i % 4]])
              for i in range(9)]
    enc = inter_qt.QtDeviceRandomAccessEncoder(ra_config(176, 144),
                                               search_range=16)
    stream, recons = enc.encode_sequence_ra(frames)
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    return kbps, psnr_y(frames, recons)


def bench_jm_baseline():
    """JM H.264 baseline (CAVLC, full search) on the foreman fixture —
    the DEVICE P-slice engine (ME/transform/decision on the device, host
    CAVLC); fps timed warm on a 24-frame cycle."""
    from video_codecs_tpu.models.h264.inter_jax import DeviceH264Encoder
    from video_codecs_tpu.utils import yuv

    path = "/root/reference/jm18.5/bin/foreman_part_qcif.yuv"
    ys, us, vs = yuv.read_frames(path, 176, 144)
    frames = [(ys[i], us[i], vs[i]) for i in range(3)]
    enc = DeviceH264Encoder(176, 144, qp=28, search_range=16)
    stream, recons = enc.encode_sequence(frames)   # config-4 rate point
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    p = psnr_y(frames, recons)
    long = [(ys[i % 3], us[i % 3], vs[i % 3]) for i in range(24)]
    enc = DeviceH264Encoder(176, 144, qp=28, search_range=16)
    t0 = time.time()
    enc.encode_sequence(long)
    fps = len(long) / (time.time() - t0)
    return fps, kbps, p


def bench_intra_qt():
    """All-intra device quadtree quality path, 416x240 QP32."""
    from video_codecs_tpu.models.hevc import quadtree_codec

    frames = synth_clip(416, 240, 17)
    enc = quadtree_codec.QuadtreeFastEncoder(intra_config(416, 240))
    enc.encode_frame_fast(*frames[0])
    fps = 0.0
    for _ in range(2):
        t0 = time.time()
        enc.encode_sequence(frames)
        fps = max(fps, len(frames) / (time.time() - t0))
    return fps


def bench_ldp_480():
    """Low-delay P 832x480 on the device inter engine (config 2)."""
    from video_codecs_tpu.models.hevc import inter_jax

    frames = synth_clip(832, 480, 9)
    enc = inter_jax.DeviceLowDelayEncoder(ldp_config(832, 480),
                                          search_range=64)
    enc.encode_sequence_ldp(frames)
    t0 = time.time()
    stream, recons = enc.encode_sequence_ldp(frames)
    fps = len(frames) / (time.time() - t0)
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    return fps, kbps, psnr_y(frames, recons)


def _emit(ra_fps, extra) -> None:
    print(json.dumps({
        "metric": "hevc_ra_1080p_gop8_device_encode_qp32",
        "value": round(ra_fps, 4),
        "unit": "frames/s/chip",
        "vs_baseline": round(ra_fps / HM_RA_1080_FPS, 2),
        "extra": extra,
    }))
    sys.stdout.flush()


def main() -> None:
    from video_codecs_tpu.utils import jax_cache

    jax_cache.enable()
    budget = float(os.environ.get("VCT_BENCH_BUDGET_S", "2100"))
    configs = os.environ.get("VCT_BENCH_CONFIGS",
                             "ra,intra,ldp,foreman,jm").split(",")
    extra = {}

    # --- headline FIRST; print + flush the moment it lands ---
    ra_fps, ra_kbps, ra_psnr = bench_ra_1080()
    extra["ra_1080_kbps"] = round(ra_kbps)
    extra["ra_1080_ypsnr"] = round(ra_psnr, 2)
    _emit(ra_fps, extra)

    # --- secondaries, cheapest first, each under the budget gate;
    # re-emit the augmented line after each so the LAST line in the
    # tail is always the most complete one ---
    def gated(name, fn):
        if name not in configs or time.time() - T0 > budget:
            return
        try:
            fn()
        except Exception as e:  # secondary: never sink the headline
            extra[f"{name}_error"] = f"{type(e).__name__}: {e}"
        _emit(ra_fps, extra)

    def run_jm():
        f, kbps, p = bench_jm_baseline()
        extra["jm_qcif_fps"] = round(f, 2)
        extra["jm_qcif_vs_jm"] = round(f / JM_BASELINE_FPS, 3)
        extra["jm_qcif_kbps"] = round(kbps)
        extra["jm_qcif_ypsnr"] = round(p, 2)

    def run_foreman():
        kbps, p = bench_ra_foreman()
        extra["ra_foreman_kbps"] = round(kbps)
        extra["ra_foreman_ypsnr"] = round(p, 2)

    def run_intra():
        f = bench_intra_qt()
        extra["intra_qt_416_fps"] = round(f, 2)
        extra["intra_qt_vs_hm"] = round(f / HM_INTRA_FPS, 2)

    def run_ldp():
        f, kbps, p = bench_ldp_480()
        extra["ldp_480_fps"] = round(f, 3)
        extra["ldp_480_vs_hm"] = round(f / HM_LDP_FPS, 2)
        extra["ldp_480_kbps"] = round(kbps)
        extra["ldp_480_ypsnr"] = round(p, 2)

    gated("jm", run_jm)
    gated("foreman", run_foreman)
    gated("intra", run_intra)
    gated("ldp", run_ldp)


if __name__ == "__main__":
    main()
