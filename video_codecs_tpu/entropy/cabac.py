"""HEVC CABAC arithmetic coding engine (spec 9.3), encoder + decoder.

Parity references: hm-16.5rc1/source/Lib/TLibEncoder/TEncBinCoderCABAC.cpp:187
(encodeBin, LPS table :205), TLibDecoder/TDecBinCoderCABAC.cpp (decodeBin),
TLibCommon/TComCABACTables.cpp:43 (sm_aucLPSTable),
ContextModel.cpp:67-89 (state transition tables), :193 (init from initValue).

We use HM's packed 128-state representation: state = (pStateIdx << 1) | valMPS.
The encoder implements the spec 9.3.4.4 algorithm (low/range with
bits-outstanding), which emits the identical bitstream to HM's buffered-byte
variant.

This is deliberately host-side sequential code — the serial tail of the
two-phase design (SURVEY.md §7.1): the device produces decisions/coefficients
in parallel, CABAC serializes per-substream.  A C++ twin replaces the hot
loop later; this Python version is the behavioral reference.
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu.entropy.bitstream import BitReader, BitWriter

# rangeTabLPS[pStateIdx][(range >> 6) & 3] (spec Table 9-46).
LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.int32)

# Packed-128 next-state tables (ContextModel.cpp:67-89).
NEXT_STATE_MPS = np.array([
    2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65,
    66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
    82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97,
    98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111, 112, 113,
    114, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 125, 124, 125, 126, 127,
], dtype=np.uint8)

NEXT_STATE_LPS = np.array([
    1, 0, 0, 1, 2, 3, 4, 5, 4, 5, 8, 9, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 19, 18, 19, 22, 23, 22, 23, 24, 25,
    26, 27, 26, 27, 30, 31, 30, 31, 32, 33, 32, 33, 36, 37, 36, 37,
    38, 39, 38, 39, 42, 43, 42, 43, 44, 45, 44, 45, 46, 47, 48, 49,
    48, 49, 50, 51, 52, 53, 52, 53, 54, 55, 54, 55, 56, 57, 58, 59,
    58, 59, 60, 61, 60, 61, 60, 61, 62, 63, 64, 65, 64, 65, 66, 67,
    66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71, 70, 71, 72, 73,
    72, 73, 72, 73, 74, 75, 74, 75, 74, 75, 76, 77, 76, 77, 126, 127,
], dtype=np.uint8)


def init_context_states(init_values: np.ndarray, qp: int) -> np.ndarray:
    """initValue -> packed 128-state (spec 9.3.2.2; ContextModel.cpp init)."""
    qp = max(0, min(51, qp))
    iv = init_values.astype(np.int32)
    slope = (iv >> 4) * 5 - 45
    offset = ((iv & 15) << 3) - 16
    pre = np.clip(((slope * qp) >> 4) + offset, 1, 126)
    mps = (pre > 63).astype(np.int32)
    pstate = np.where(mps == 1, pre - 64, 63 - pre)
    return ((pstate << 1) | mps).astype(np.uint8)


class CabacEncoder:
    """Spec 9.3.4 arithmetic encoder writing into a BitWriter."""

    def __init__(self, bw: BitWriter, states: np.ndarray) -> None:
        self.bw = bw
        self.states = states  # packed-128, mutable
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True

    # -- internals --
    def _put_bit(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self.bw.write(b, 1)
        while self.bits_outstanding > 0:
            self.bw.write(1 - b, 1)
            self.bits_outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self._put_bit(1)
                self.low -= 512
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.bits_outstanding += 1
                self.low -= 256
            self.low <<= 1
            self.range <<= 1

    # -- public --
    def encode_bin(self, ctx: int, bin_val: int) -> None:
        state = int(self.states[ctx])
        pstate, mps = state >> 1, state & 1
        lps = int(LPS_TABLE[pstate][(self.range >> 6) & 3])
        self.range -= lps
        if bin_val != mps:
            self.low += self.range
            self.range = lps
            self.states[ctx] = NEXT_STATE_LPS[state]
        else:
            self.states[ctx] = NEXT_STATE_MPS[state]
        self._renorm()

    def encode_bypass(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.bits_outstanding += 1
            self.low -= 512

    def encode_bypass_bins(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self) -> None:
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        self.bw.write(((self.low >> 7) & 3) | 1, 2)

    def finish_slice(self) -> None:
        """Byte-align after encode_terminate(1).

        The final '1' bit emitted by the flush (spec 9.3.4.3.5) IS the
        rbsp_stop_one_bit, so only zero padding follows (HM
        TDecBinCABAC::finish asserts exactly this pattern).
        """
        nbits = self.bw.num_bits() & 7
        if nbits:
            self.bw.write(0, 8 - nbits)


class CabacDecoder:
    """Spec 9.3.3 arithmetic decoder reading from a BitReader."""

    def __init__(self, br: BitReader, states: np.ndarray) -> None:
        self.br = br
        self.states = states
        self.range = 510
        self._seg_start = br.bit_pos()   # CABAC segment origin (aligned)
        self.offset = br.read(9)

    def begin_pcm(self) -> None:
        """Position the reader at the PCM sample bytes after a
        pcm_flag terminate bin (HM TDecBinCABAC byte-wise model: the
        engine pre-reads 2 bytes at start() and one byte per 8 renorm
        bits, so the underlying byte pointer is at
        2 + floor(renorm_bits/8) bytes past the segment origin; the
        partially-consumed lookahead is discarded)."""
        k = self.br.bit_pos() - self._seg_start - 9
        self.br._pos = self._seg_start + 8 * (2 + k // 8)

    def reinit(self) -> None:
        """Re-initialize the arithmetic engine after PCM samples
        (HM TDecBinCABAC::start at the current aligned position)."""
        assert (self.br.bit_pos() & 7) == 0
        self.range = 510
        self._seg_start = self.br.bit_pos()
        self.offset = self.br.read(9)

    def _read_bit(self) -> int:
        # Conforming streams never read past the end; tolerate overrun with 0s
        # (matches HM's behavior on truncated streams).
        return self.br.read(1) if self.br.bits_left() > 0 else 0

    def decode_bin(self, ctx: int) -> int:
        state = int(self.states[ctx])
        pstate, mps = state >> 1, state & 1
        lps = int(LPS_TABLE[pstate][(self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            bin_val = 1 - mps
            self.offset -= self.range
            self.range = lps
            self.states[ctx] = NEXT_STATE_LPS[state]
        else:
            bin_val = mps
            self.states[ctx] = NEXT_STATE_MPS[state]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return bin_val

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bins(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0
