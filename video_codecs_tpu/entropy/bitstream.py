"""Raw bitstream I/O: bit writer/reader, Exp-Golomb, RBSP/EBSP, NAL, Annex-B.

Parity reference: hm-16.5rc1/source/Lib/TLibCommon/TComBitStream.cpp (writer,
emulation prevention at NAL write), TLibDecoder/AnnexBread.cpp:61
(start-code scan), TLibEncoder/NALwrite.cpp:125 (EBSP insertion).

Host-side sequential code by nature (SURVEY.md §7.1 "entropy coding split"):
this is the thin serial tail after the parallel device passes.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer producing an RBSP byte string."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        assert nbits >= 0 and 0 <= value < (1 << nbits) if nbits else value == 0
        self._cur = (self._cur << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._cur >> self._nbits) & 0xFF)
        self._cur &= (1 << self._nbits) - 1

    def flag(self, b: int) -> None:
        self.write(1 if b else 0, 1)

    def ue(self, v: int) -> None:
        """Unsigned Exp-Golomb."""
        assert v >= 0
        code = v + 1
        nbits = code.bit_length()
        self.write(0, nbits - 1)
        self.write(code, nbits)

    def se(self, v: int) -> None:
        """Signed Exp-Golomb."""
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def rbsp_trailing_bits(self) -> None:
        self.write(1, 1)
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def byte_alignment(self) -> None:
        """alignment_bit_equal_to_one + zeros (spec 7.3.2.10)."""
        self.rbsp_trailing_bits()

    def num_bits(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def data(self) -> bytes:
        assert self._nbits == 0, "unaligned bitstream"
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader over an RBSP byte string."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def flag(self) -> int:
        return self.read(1)

    def ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
        return ((1 << zeros) | self.read(zeros)) - 1 if zeros else 0

    def se(self) -> int:
        v = self.ue()
        return (v + 1) >> 1 if (v & 1) else -(v >> 1)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def bit_pos(self) -> int:
        return self._pos

    def remaining_bytes(self) -> bytes:
        """Bytes from the current (byte-aligned) position to the end."""
        assert (self._pos & 7) == 0
        return self._data[self._pos >> 3:]

    def bits_left(self) -> int:
        return len(self._data) * 8 - self._pos

    def more_rbsp_data(self) -> bool:
        if self.bits_left() <= 0:
            return False
        # RBSP stop bit: last 1-bit in the stream.
        for i in range(len(self._data) * 8 - 1, self._pos - 1, -1):
            byte = self._data[i >> 3]
            if (byte >> (7 - (i & 7))) & 1:
                return i > self._pos
        return False


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """RBSP -> EBSP: insert 0x03 after any 00 00 before 00/01/02/03."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def strip_emulation_prevention(ebsp: bytes) -> bytes:
    """EBSP -> RBSP: remove emulation-prevention 0x03 bytes."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


# HEVC NAL unit types we emit (spec Table 7-1).
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def nal_unit(nal_type: int, rbsp: bytes, layer_id: int = 0,
             temporal_id_plus1: int = 1) -> bytes:
    """2-byte NAL header + EBSP payload."""
    h0 = (nal_type << 1) | (layer_id >> 5)
    h1 = ((layer_id & 31) << 3) | temporal_id_plus1
    return bytes([h0, h1]) + insert_emulation_prevention(rbsp)


def annexb(nals: list[bytes]) -> bytes:
    """Annex-B byte stream: 4-byte start code before parameter sets / first
    NAL of an AU, 3-byte otherwise (we conservatively use 4-byte always,
    which every conforming decoder accepts)."""
    out = bytearray()
    for nal in nals:
        if nal is None:           # disabled optional NALs (e.g. hash SEI)
            continue
        out += b"\x00\x00\x00\x01" + nal
    return bytes(out)


def split_annexb(stream: bytes) -> list[bytes]:
    """Split an Annex-B stream into NAL units (EBSP, incl. 2-byte header).

    Trailing zero bytes of each NAL are stripped: they belong to the next
    start-code prefix, and a conforming HEVC NAL never ends in 0x00 (the
    RBSP stop bit makes the last byte nonzero).
    """
    starts = []
    i = 0
    n = len(stream)
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    nals = []
    for k, s in enumerate(starts):
        end = starts[k + 1] - 3 if k + 1 < len(starts) else n
        nal = stream[s:end].rstrip(b"\x00") or stream[s:end]
        nals.append(nal)
    return nals
