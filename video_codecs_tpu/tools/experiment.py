"""QP-sweep experiment harness + Bjontegaard BD-rate/BD-PSNR.

Device-side replacement for the reference research harness
(stvssim_src/exp_setup/*.sh batch encodes + getAvg_all.sh summary
scraping + b_data_rdo_new/*.m MATLAB metric-vs-bitrate tables,
mserdo_plot.m): encode a sequence over a QP ladder with any encoder
variant, collect bitrate + quality metrics per point, tabulate, and
compare two variants with the standard Bjontegaard delta (the number
the MATLAB tables were produced to eyeball).

Usage (module API):
    pts = qp_sweep(lambda qp: IntraEncoder(cfg._replace(qp=qp)),
                   frames, qps=(28, 32, 36, 40), fps=30.0)
    print(format_table("mserdo", pts))
    bd = bd_rate([p.bitrate for p in a], [p.psnr_y for p in a],
                 [p.bitrate for p in b], [p.psnr_y for p in b])

CLI:
    python -m video_codecs_tpu.tools.experiment -i in.yuv -W 176 -H 144 \
        --qps 28,32,36,40 [--frames N] [--codec intra|ldp] [--fast]
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# Bjontegaard metrics (VCEG-M33 method, cubic fit in log-rate domain)
# ---------------------------------------------------------------------------

def _bd_delta(x_a, y_a, x_b, y_b):
    """Average vertical gap between cubic fits y(x) over the common x range."""
    x_a, y_a = np.asarray(x_a, float), np.asarray(y_a, float)
    x_b, y_b = np.asarray(x_b, float), np.asarray(y_b, float)
    p_a = np.polyfit(x_a, y_a, min(3, len(x_a) - 1))
    p_b = np.polyfit(x_b, y_b, min(3, len(x_b) - 1))
    lo = max(x_a.min(), x_b.min())
    hi = min(x_a.max(), x_b.max())
    if hi <= lo:
        raise ValueError("curves do not overlap")
    ia, ib = np.polyint(p_a), np.polyint(p_b)
    int_a = np.polyval(ia, hi) - np.polyval(ia, lo)
    int_b = np.polyval(ib, hi) - np.polyval(ib, lo)
    return (int_b - int_a) / (hi - lo)


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """BD-rate of test vs anchor in percent (negative = test saves bits)."""
    d = _bd_delta(psnr_anchor, np.log10(rate_anchor),
                  psnr_test, np.log10(rate_test))
    return float((10.0 ** d - 1.0) * 100.0)


def bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """BD-PSNR of test vs anchor in dB (positive = test is better)."""
    return float(_bd_delta(np.log10(rate_anchor), psnr_anchor,
                           np.log10(rate_test), psnr_test))


# ---------------------------------------------------------------------------
# QP sweep
# ---------------------------------------------------------------------------

@dataclass
class RDPoint:
    qp: int
    bitrate: float            # kbit/s
    psnr_y: float
    psnr_u: float
    psnr_v: float
    extra: dict = field(default_factory=dict)   # named quality metrics


def _plane_psnr(ref, rec):
    ref = np.stack(ref).astype(np.float64)
    rec = np.stack(rec).astype(np.float64)
    mse = np.mean((ref - rec) ** 2)
    return 99.99 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def qp_sweep(encoder_factory, frames, qps, fps: float = 30.0,
             metrics: dict | None = None) -> list[RDPoint]:
    """Encode `frames` once per QP and collect rate/quality points.

    encoder_factory(qp) must return an object with
    encode_sequence(frames) -> (stream_bytes, recons).  `metrics` maps a
    name to fn(frames, recons) -> float for extra columns (SSIM etc.),
    mirroring the 9-metric columns of the reference MATLAB tables.
    """
    pts = []
    for qp in qps:
        enc = encoder_factory(qp)
        stream, recons = enc.encode_sequence(frames)
        kbps = len(stream) * 8 * fps / max(len(frames), 1) / 1000.0
        pt = RDPoint(
            qp=qp, bitrate=kbps,
            psnr_y=_plane_psnr([f[0] for f in frames],
                               [r[0] for r in recons]),
            psnr_u=_plane_psnr([f[1] for f in frames],
                               [r[1] for r in recons]),
            psnr_v=_plane_psnr([f[2] for f in frames],
                               [r[2] for r in recons]))
        for name, fn in (metrics or {}).items():
            pt.extra[name] = float(fn(frames, recons))
        pts.append(pt)
    return pts


def format_table(name: str, pts: list[RDPoint]) -> str:
    """avgdata_all_*.m-style table: one row per QP point."""
    cols = ["QP", "kbps", "Y-PSNR", "U-PSNR", "V-PSNR"]
    cols += sorted(pts[0].extra) if pts else []
    lines = [f"# {name}", "\t".join(cols)]
    for p in pts:
        row = [f"{p.qp}", f"{p.bitrate:.2f}", f"{p.psnr_y:.4f}",
               f"{p.psnr_u:.4f}", f"{p.psnr_v:.4f}"]
        row += [f"{p.extra[k]:.6f}" for k in sorted(p.extra)]
        lines.append("\t".join(row))
    return "\n".join(lines)


def compare(anchor: list[RDPoint], test: list[RDPoint]) -> dict:
    """BD deltas of test vs anchor on the luma PSNR curve."""
    ra, pa = [p.bitrate for p in anchor], [p.psnr_y for p in anchor]
    rt, pt = [p.bitrate for p in test], [p.psnr_y for p in test]
    return {"bd_rate_pct": bd_rate(ra, pa, rt, pt),
            "bd_psnr_db": bd_psnr(ra, pa, rt, pt)}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    import argparse

    from video_codecs_tpu.models.hevc import headers, inter_codec, intra_codec
    from video_codecs_tpu.utils import yuv

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-i", required=True, dest="input")
    ap.add_argument("-W", "--width", type=int, required=True)
    ap.add_argument("-H", "--height", type=int, required=True)
    ap.add_argument("--qps", default="28,32,36,40")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--codec", choices=["intra", "ldp"], default="intra")
    ap.add_argument("--fast", action="store_true")
    a = ap.parse_args(argv)

    y, u, v = yuv.read_frames(a.input, a.width, a.height, a.frames or None)
    frames = [(y[i], u[i], v[i]) for i in range(y.shape[0])]
    qps = [int(q) for q in a.qps.split(",")]

    def factory(qp):
        cfg = headers.HevcConfig(width=a.width, height=a.height, qp=qp)
        if a.codec == "intra":
            enc = intra_codec.IntraEncoder(cfg)
            if a.fast:
                seq = enc.encode_sequence

                class _Fast:
                    encode_sequence = staticmethod(
                        lambda fr: seq(fr, fast=True))
                return _Fast()
            return enc

        class _Ldp:
            encode_sequence = staticmethod(
                inter_codec.LowDelayEncoder(cfg).encode_sequence_ldp)
        return _Ldp()

    pts = qp_sweep(factory, frames, qps, fps=a.fps)
    print(format_table(f"{a.codec} {a.input}", pts))


if __name__ == "__main__":
    main()
