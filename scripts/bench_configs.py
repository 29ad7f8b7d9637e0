"""Measure the five BASELINE.json configs: reference binaries vs ours.

Produces the 'reference measured' and 'ours' columns for BASELINE.md.
Reference encoders are single-thread CPU (-O3) on this machine; ours run
on whatever JAX platform is active (the CPU unless a card is present).

Usage: python scripts/bench_configs.py [--configs 2,3,4,5] [--frames N]
Results append to scripts/bench_configs_out.json.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from video_codecs_tpu.utils import yuv  # noqa: E402

HM = "/root/repo/.refbuild/hm-16.5rc1/bin/TAppEncoderStatic"
HM_CFG = "/root/repo/.refbuild/hm-16.5rc1/cfg"
JM = "/root/repo/.refbuild/jm18.5/bin/lencod.exe"
JM_CFG = "/root/reference/jm18.5/bin"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "bench_configs_out.json")


def synth(w, h, n, seed=42):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    tex = rng.integers(-24, 25, (h, w))
    frames = []
    for f in range(n):
        y = np.clip(((xx * 3 + yy * 2 + f * 7) % 256) * 0.7 + tex + 30 +
                    20 * np.sin(2 * np.pi * (xx + 8 * f) / 64),
                    0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(
            2 * np.pi * (xx[::2, ::2] + 4 * f) / 128), 0, 255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(
            2 * np.pi * (yy[::2, ::2] + 4 * f) / 128), 0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def psnr_y(frames, recs):
    a = np.concatenate([f[0].astype(np.float64).ravel() for f in frames])
    b = np.concatenate([r[0].astype(np.float64).ravel() for r in recs])
    return 10 * math.log10(255 ** 2 / np.mean((a - b) ** 2))


def write_src(frames, path):
    yuv.write_frames(path, np.stack([f[0] for f in frames]),
                     np.stack([f[1] for f in frames]),
                     np.stack([f[2] for f in frames]))


def run_hm(cfg_name, frames, w, h, qp, tmp, extra=()):
    src = os.path.join(tmp, "src.yuv")
    write_src(frames, src)
    out = os.path.join(tmp, "o.bin")
    rec = os.path.join(tmp, "r.yuv")
    t0 = time.time()
    r = subprocess.run(
        [HM, "-c", f"{HM_CFG}/{cfg_name}", "-i", src, "-b", out, "-o", rec,
         "-wdt", str(w), "-hgt", str(h), "-f", str(len(frames)),
         "-fr", "30", "-q", str(qp), *extra],
        capture_output=True, text=True, timeout=3600)
    dt = time.time() - t0
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-500:]
    kbps = os.path.getsize(out) * 8 * 30 / len(frames) / 1000
    ry, ru, rv = yuv.read_frames(rec, w, h)
    recs = [(ry[i], ru[i], rv[i]) for i in range(len(frames))]
    return dict(fps=len(frames) / dt, kbps=kbps, ypsnr=psnr_y(frames, recs))


def config2(frames_n):
    """HM low-delay P, 832x480 (Class C size)."""
    from video_codecs_tpu.models.hevc import headers, inter_codec

    frames = synth(832, 480, frames_n)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        res["ref"] = run_hm("encoder_lowdelay_P_main.cfg", frames,
                            832, 480, 32, tmp)
    cfg = headers.HevcConfig(width=832, height=480, qp=32, num_refs=4,
                             merge_cands=5, temporal_mvp=True)
    enc = inter_codec.LowDelayEncoder(cfg, search_range=16, me_method="tz")
    t0 = time.time()
    stream, recons = enc.encode_sequence_ldp(frames)
    dt = time.time() - t0
    res["ours"] = dict(fps=len(frames) / dt,
                       kbps=len(stream) * 8 * 30 / len(frames) / 1000,
                       ypsnr=psnr_y(frames, recons))
    return res


def config3(frames_n):
    """HM random access, 1080p.  Our inter engine is the host reference
    path (device inter is the round-3 priority), far too slow for a full
    1080p GOP sweep; its per-frame time is probed on a 2-picture I+P
    encode and reported as projected fps."""
    from video_codecs_tpu.models.hevc import headers, ra_codec

    frames = synth(1920, 1080, frames_n)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        res["ref"] = run_hm("encoder_randomaccess_main.cfg", frames,
                            1920, 1080, 32, tmp)
    frames_c = [(f[0][:1072], f[1][:536], f[2][:536])
                for f in frames[:2]]
    cfg = headers.HevcConfig(width=1920, height=1072, qp=32,
                             reorder_pics=3, num_refs=4)
    enc = ra_codec.RandomAccessEncoder(cfg, search_range=8, me_method="tz")
    t0 = time.time()
    stream, recons = enc.encode_sequence_ra(frames_c)
    dt = time.time() - t0
    res["ours"] = dict(fps=len(frames_c) / dt,
                       kbps=len(stream) * 8 * 30 / len(frames_c) / 1000,
                       ypsnr=psnr_y(frames_c, recons),
                       note="2-picture host-path probe (projected fps)")
    return res


def config4(frames_n):
    """JM-18.5 H.264 baseline (CAVLC, full search), CIF-ish (qcif fixture)."""
    from video_codecs_tpu.tools import jm_encoder_app

    res = {}
    n = min(frames_n, 3)   # fixture has 3 frames
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "jm.264")
        rec = os.path.join(tmp, "jm_rec.yuv")
        t0 = time.time()
        r = subprocess.run(
            [JM, "-d", f"{JM_CFG}/encoder_baseline.cfg",
             "-p", f"InputFile={JM_CFG}/foreman_part_qcif.yuv",
             "-p", "SourceWidth=176", "-p", "SourceHeight=144",
             "-p", f"FramesToBeEncoded={n}", "-p", "QPISlice=28",
             "-p", "QPPSlice=28", "-p", f"OutputFile={out}",
             "-p", f"ReconFile={rec}", "-p", "SearchMode=0"],
            capture_output=True, text=True, timeout=600, cwd=tmp)
        dt = time.time() - t0
        assert os.path.exists(out) and os.path.getsize(out) > 0, \
            r.stdout[-1500:]
        ys, us, vs = yuv.read_frames(
            f"{JM_CFG}/foreman_part_qcif.yuv", 176, 144, n)
        frames = [(ys[i], us[i], vs[i]) for i in range(n)]
        ry, ru, rv = yuv.read_frames(rec, 176, 144)
        recs = [(ry[i], ru[i], rv[i]) for i in range(n)]
        res["ref"] = dict(fps=n / dt,
                          kbps=os.path.getsize(out) * 8 * 30 / n / 1000,
                          ypsnr=psnr_y(frames, recs))
        # ours through the JM-style CLI (baseline: CAVLC + full search)
        out2 = os.path.join(tmp, "ours.264")
        rec2 = os.path.join(tmp, "ours_rec.yuv")
        t0 = time.time()
        jm_encoder_app.main([
            "-p", f"InputFile={JM_CFG}/foreman_part_qcif.yuv",
            "-p", "SourceWidth=176", "-p", "SourceHeight=144",
            "-p", f"FramesToBeEncoded={n}", "-p", "QPPSlice=28",
            "-p", "SymbolMode=0", "-p", "SearchMode=0",
            "-p", f"OutputFile={out2}", "-p", f"ReconFile={rec2}"])
        dt = time.time() - t0
        ry2, ru2, rv2 = yuv.read_frames(rec2, 176, 144)
        recs2 = [(ry2[i], ru2[i], rv2[i]) for i in range(n)]
        res["ours"] = dict(fps=n / dt,
                           kbps=os.path.getsize(out2) * 8 * 30 / n / 1000,
                           ypsnr=psnr_y(frames, recs2))
    return res


def config5(frames_n):
    """STVSSIM perceptual RDO + rate control (research stack).

    The stvssim reference encoder needs 2010-era OpenCV DLLs and does not
    build here; only our numbers are measured (perceptual RDO + URQ RC).
    """
    from video_codecs_tpu.models.h264 import intra_codec as h264i

    frames = synth(832, 480, frames_n, seed=7)
    res = {"ref": None}
    t0 = time.time()
    enc = h264i.H264IntraEncoder(width=832, height=480, qp=32,
                                 perceptual="att+ssim")
    bits = 0
    recs = []
    for f in frames:
        rbsp, rec = enc.encode_frame(*f)
        bits += 8 * len(rbsp)
        recs.append(rec)
    dt = time.time() - t0
    res["ours"] = dict(fps=len(frames) / dt,
                       kbps=bits * 30 / len(frames) / 1000,
                       ypsnr=psnr_y(frames, recs))
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="2,3,4")
    ap.add_argument("--frames", type=int, default=9)
    args = ap.parse_args()
    results = {}
    if os.path.exists(OUT):
        results = json.load(open(OUT))
    for c in args.configs.split(","):
        fn = {"2": config2, "3": config3, "4": config4, "5": config5}[c]
        print(f"=== config {c} ===", flush=True)
        try:
            r = fn(args.frames)
        except Exception as e:  # record the failure, keep going
            r = {"error": f"{type(e).__name__}: {e}"}
        results[c] = r
        print(json.dumps(r, indent=1, default=str), flush=True)
        json.dump(results, open(OUT, "w"), indent=1, default=str)


if __name__ == "__main__":
    main()
