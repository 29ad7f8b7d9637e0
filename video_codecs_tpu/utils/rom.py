"""Spec constant tables for HEVC (H.265) — the device analog of HM's ROM.

Everything here is a *standard-defined constant* (ITU-T H.265 / ISO 23008-2):
integer transform matrices, quantization scales, chroma QP mapping, coefficient
scan orders, intra angle tables.  Parity reference: TComRom.cpp/.h in
hm-16.5rc1/source/Lib/TLibCommon (g_aiT4/8/16/32 at TComRom.cpp:489-517,
g_quantScales/g_invQuantScales at :354-362, g_aucChromaScale at :532,
scan-order generation in initROM at :70-260).

Unlike HM we do not hand-write the 32x32 matrix: the HEVC DCT matrix has the
property T32[k][n] = sign(cos(pi*k*(2n+1)/64)) * V[fold(k*(2n+1) mod 128)]
where V[m] is the standard 33-entry magnitude table; smaller matrices are the
even-row/leading-column submatrices.  We generate all four sizes from V and
verify the embedding property in tests.
"""

from __future__ import annotations

import functools

import numpy as np

# Magnitude table V[m] ~ 64*sqrt(2)*cos(pi*m/64), hand-tuned by the standard.
# V[m] for m = 0..31 (V[32] = 0 never occurs: k*(2n+1) cannot be 32 mod 64
# for k in [0,32) except multiples handled by folding).
_DCT_MAG = np.array(
    [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
     64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0],
    dtype=np.int64,
)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """HEVC integer DCT-II matrix of size n x n (n in 4,8,16,32), int32.

    Row k of T_n equals row k*(32//n) of T_32 truncated to the first n
    columns (spec 8.6.4.2).
    """
    assert n in (4, 8, 16, 32)
    stride = 32 // n
    t = np.zeros((n, n), dtype=np.int64)
    for k in range(n):
        for col in range(n):
            m = (k * stride * (2 * col + 1)) % 128
            if m <= 32:
                t[k, col] = _DCT_MAG[m]
            elif m <= 64:
                t[k, col] = -_DCT_MAG[64 - m]
            elif m <= 96:
                t[k, col] = -_DCT_MAG[m - 64]
            else:
                t[k, col] = _DCT_MAG[128 - m]
    return t.astype(np.int32)


# 4x4 DST-VII used for 4x4 luma intra TUs (TComRom.cpp:513-517, spec 8.6.4.1).
DST4 = np.array(
    [[29, 55, 74, 84],
     [74, 74, 0, -74],
     [84, -29, -74, 55],
     [55, -84, 74, -29]],
    dtype=np.int32,
)

# Quantization scales indexed by qp % 6 (TComRom.cpp:354-362, spec 8.6.3).
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

QUANT_SHIFT = 14      # CommonDef.h:228
IQUANT_SHIFT = 6      # CommonDef.h:229
MAX_TR_DYNAMIC_RANGE = 15  # Main profile (extended precision off)

# Chroma QP mapping for 4:2:0 (g_aucChromaScale row 1, TComRom.cpp:534;
# spec Table 8-10).  Index = clipped luma-derived qp 0..57.
CHROMA_QP_TABLE_420 = np.array(
    list(range(30)) +
    [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37] +
    list(range(38, 52)),
    dtype=np.int32,
)
assert CHROMA_QP_TABLE_420.shape == (58,)

# --------------------------------------------------------------------------
# Coefficient scan orders (spec 6.5.3-6.5.5; HM initROM TComRom.cpp:70-260).
# Scan type ids match HM: 0=diag (up-right), 1=horizontal, 2=vertical.
SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


def _diag_scan(size: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan order of a size x size block: list of (x, y)."""
    order = []
    x, y = 0, 0
    while len(order) < size * size:
        while y >= 0:
            if x < size and y < size:
                order.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return order


@functools.lru_cache(maxsize=None)
def scan_order(log2_size: int, scan_type: int) -> np.ndarray:
    """Scan-position -> raster-position (y*width+x) map for a square TB.

    For blocks larger than 4x4 the scan is grouped: 4x4 coefficient groups
    are visited in the block-level scan order and coefficients inside each
    group in the same order (spec 7.3.8.11 semantics; HM grouped scans
    TComRom.cpp:209-251).
    """
    size = 1 << log2_size
    if scan_type == SCAN_HOR:
        inner = [(x, y) for y in range(min(size, 4)) for x in range(min(size, 4))]
    elif scan_type == SCAN_VER:
        inner = [(x, y) for x in range(min(size, 4)) for y in range(min(size, 4))]
    else:
        inner = _diag_scan(min(size, 4))

    if size <= 4:
        return np.array([y * size + x for (x, y) in inner], dtype=np.int32)

    ngroups = size // 4
    if scan_type == SCAN_HOR:
        groups = [(gx, gy) for gy in range(ngroups) for gx in range(ngroups)]
    elif scan_type == SCAN_VER:
        groups = [(gx, gy) for gx in range(ngroups) for gy in range(ngroups)]
    else:
        groups = _diag_scan(ngroups)

    out = []
    for (gx, gy) in groups:
        for (x, y) in inner:
            out.append((gy * 4 + y) * size + (gx * 4 + x))
    return np.array(out, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def cg_scan_order(log2_size: int, scan_type: int) -> np.ndarray:
    """Scan order of the 4x4 coefficient groups themselves: (gy*ngroups+gx)."""
    size = 1 << log2_size
    ngroups = max(size // 4, 1)
    if scan_type == SCAN_HOR:
        groups = [(gx, gy) for gy in range(ngroups) for gx in range(ngroups)]
    elif scan_type == SCAN_VER:
        groups = [(gx, gy) for gx in range(ngroups) for gy in range(ngroups)]
    else:
        groups = _diag_scan(ngroups)
    return np.array([gy * ngroups + gx for (gx, gy) in groups], dtype=np.int32)


# --------------------------------------------------------------------------
# Intra prediction angle tables (spec 8.4.4.2.6; TComPrediction.cpp:412+).
# Mode 0 planar, 1 DC, 2..34 angular.  ANGLE_TABLE[mode-2] for modes 2..34.
INTRA_PRED_ANGLES = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32,
)
# Inverse angle (8192/angle, rounded) for negative-angle modes 11..25.
INTRA_INV_ANGLES = np.array(
    [-4096, -1638, -910, -630, -482, -390, -315, -256,
     -315, -390, -482, -630, -910, -1638, -4096],
    dtype=np.int32,
)


def intra_scan_type(log2_size: int, mode: int, is_luma: bool) -> int:
    """Mode-dependent coefficient scan (spec 7.4.9.11; HM getCoefScanIdx).

    Applies to 4x4 and 8x8 luma TBs and 4x4 chroma (4:2:0): modes within
    +/-4 of horizontal (10) scan vertically, within +/-4 of vertical (26)
    scan horizontally; otherwise diagonal.
    """
    if log2_size > 3 or (not is_luma and log2_size > 2):
        return SCAN_DIAG
    if 6 <= mode <= 14:
        return SCAN_VER
    if 22 <= mode <= 30:
        return SCAN_HOR
    return SCAN_DIAG
