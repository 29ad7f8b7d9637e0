"""RA BD-rate sweep: our device CTB32 inter quadtree vs HM-16.5
encoder_randomaccess_main.cfg, multi-QP, on real content (foreman
cycle) and synthetic clips.

This is the round-5 done-criterion measurement (VERDICT ask #2): an
actual BD-rate number for the north-star RA config, recorded in
BASELINE.md.

Usage:
  python scripts/eval_ra.py --clip foreman --qps 27,32,37     # ours+HM
  python scripts/eval_ra.py --clip foreman --hm-only          # CPU side
  python scripts/eval_ra.py --clip synth832 --ours-only

HM results are cached in scripts/.hm_ra_cache.json keyed by clip+qp, so
the (slow, CPU) reference side only ever runs once per point.
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

HM = "/root/repo/.refbuild/hm-16.5rc1/bin/TAppEncoderStatic"
HM_CFG = "/root/repo/.refbuild/hm-16.5rc1/cfg/encoder_randomaccess_main.cfg"
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".hm_ra_cache.json")


def get_clip(name):
    from bench import synth_clip
    from video_codecs_tpu.utils import yuv

    if name == "foreman":
        ys, us, vs = yuv.read_frames(
            "/root/reference/jm18.5/bin/foreman_part_qcif.yuv", 176, 144)
        cyc = [0, 1, 2, 1]
        frames = [(ys[cyc[i % 4]], us[cyc[i % 4]], vs[cyc[i % 4]])
                  for i in range(9)]
        return frames, 176, 144
    if name == "synth832":
        return synth_clip(832, 480, 17), 832, 480
    if name == "synth1080":
        return synth_clip(1920, 1072, 9), 1920, 1072
    raise ValueError(name)


def psnr_y(frames, recs):
    a = np.concatenate([f[0].astype(np.float64).ravel() for f in frames])
    b = np.concatenate([np.asarray(r[0], np.float64).ravel()
                        for r in recs])
    return 10 * math.log10(255 ** 2 / np.mean((a - b) ** 2))


def run_hm(frames, w, h, qp):
    from video_codecs_tpu.utils import yuv
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src.yuv")
        yuv.write_frames(src, np.stack([f[0] for f in frames]),
                         np.stack([f[1] for f in frames]),
                         np.stack([f[2] for f in frames]))
        out = os.path.join(tmp, "o.bin")
        rec = os.path.join(tmp, "r.yuv")
        t0 = time.time()
        r = subprocess.run(
            [HM, "-c", HM_CFG, "-i", src, "-b", out, "-o", rec,
             "-wdt", str(w), "-hgt", str(h), "-f", str(len(frames)),
             "-fr", "30", "-q", str(qp)],
            capture_output=True, text=True, timeout=7200)
        dt = time.time() - t0
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-500:]
        bits = os.path.getsize(out) * 8
        ry, ru, rv = yuv.read_frames(rec, w, h)
        recs = [(ry[i], ru[i], rv[i]) for i in range(len(frames))]
        return bits, psnr_y(frames, recs), dt


def run_ours(frames, w, h, qp, search_range):
    from video_codecs_tpu.models.hevc import headers, inter_qt

    nr = int(os.environ.get("VCT_QT_REFS", "1"))
    cu8 = os.environ.get("VCT_QT_CU8", "1") not in ("0", "off")
    sao = os.environ.get("VCT_QT_SAO", "0") not in ("0", "off")
    tmvp = os.environ.get("VCT_QT_TMVP", "0") not in ("0", "off")
    cfg = headers.HevcConfig(width=w, height=h, qp=qp, log2_ctb=5,
                             log2_min_cb=3, log2_max_tb=5,
                             reorder_pics=3, sign_data_hiding=True,
                             rdoq="lite", merge_cands=5, sao=sao,
                             temporal_mvp=tmvp, hash_sei=False)
    enc = inter_qt.QtDeviceRandomAccessEncoder(
        cfg, search_range=search_range, cu8=cu8, num_refs_active=nr)
    t0 = time.time()
    stream, recons = enc.encode_sequence_ra(frames)
    dt = time.time() - t0
    return len(stream) * 8, psnr_y(frames, recons), dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", default="foreman")
    ap.add_argument("--qps", default="27,32,37")
    ap.add_argument("--hm-only", action="store_true")
    ap.add_argument("--ours-only", action="store_true")
    args = ap.parse_args()
    qps = [int(q) for q in args.qps.split(",")]

    if not args.hm_only:
        from video_codecs_tpu.utils import jax_cache
        jax_cache.enable()

    frames, w, h = get_clip(args.clip)
    sr = 16 if w <= 416 else 64
    cache = json.load(open(CACHE)) if os.path.exists(CACHE) else {}

    hm_pts, our_pts = [], []
    for qp in qps:
        key = f"{args.clip}-qp{qp}"
        if key not in cache:
            if args.ours_only:
                continue
            bits, p, dt = run_hm(frames, w, h, qp)
            cache[key] = [bits, p, dt]
            json.dump(cache, open(CACHE, "w"))
        bits, p, dt = cache[key]
        hm_pts.append((bits, p))
        print(f"HM   qp{qp}: {bits/1000:9.1f} kbit  Y-PSNR {p:6.3f}  "
              f"({dt:6.1f}s = {len(frames)/dt:6.3f} fps)", flush=True)
    if args.hm_only:
        return
    for qp in qps:
        bits, p, dt = run_ours(frames, w, h, qp, sr)
        our_pts.append((bits, p))
        print(f"ours qp{qp}: {bits/1000:9.1f} kbit  Y-PSNR {p:6.3f}  "
              f"({dt:6.1f}s = {len(frames)/dt:6.3f} fps)", flush=True)

    if len(hm_pts) == len(our_pts) >= 3:
        from video_codecs_tpu.tools import experiment
        r_a = [b for b, _ in hm_pts]
        p_a = [p for _, p in hm_pts]
        r_t = [b for b, _ in our_pts]
        p_t = [p for _, p in our_pts]
        print(f"BD-rate vs HM: "
              f"{experiment.bd_rate(r_a, p_a, r_t, p_t):+.2f}%  BD-PSNR: "
              f"{experiment.bd_psnr(r_a, p_a, r_t, p_t):+.3f} dB")


if __name__ == "__main__":
    main()
