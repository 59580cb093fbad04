"""Bit-level bitstream writer, exp-Golomb codes, EBSP escaping, NAL framing.

Role of the reference's hmr_bitstream.c (bit writer + ue/se + EBSP +
NAL header; homer_lib/hmr_bitstream.c:33-160) — written
host-side in Python; this is control-plane code, not a hot loop (the hot bin
loop lives in cabac.py and its native backend).
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit accumulator producing RBSP bytes."""

    __slots__ = ("_bytes", "_cur", "_nbits")

    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        assert 0 <= value < (1 << nbits), (value, nbits)
        cur = (self._cur << nbits) | value
        nb = self._nbits + nbits
        while nb >= 8:
            nb -= 8
            self._bytes.append((cur >> nb) & 0xFF)
        self._cur = cur & ((1 << nb) - 1)
        self._nbits = nb

    def write_flag(self, flag) -> None:
        self.write(1 if flag else 0, 1)

    def write_ue(self, value: int) -> None:
        """ue(v) unsigned exp-Golomb (spec 9.2)."""
        assert value >= 0
        code = value + 1
        nbits = code.bit_length()
        self.write(0, nbits - 1)
        self.write(code, nbits)

    def write_se(self, value: int) -> None:
        """se(v) signed exp-Golomb (spec 9.2.2)."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_byte(self, b: int) -> None:
        self.write(b, 8)

    def align_one(self) -> None:
        if self._nbits:
            self.write((1 << (8 - self._nbits)) - 1, 8 - self._nbits)

    def align_zero(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + alignment zeros (spec 7.3.2.11)."""
        self.write(1, 1)
        self.align_zero()

    @property
    def bit_count(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    @property
    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def get_bytes(self) -> bytes:
        assert self._nbits == 0, "stream not byte-aligned"
        return bytes(self._bytes)


def ebsp_escape(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (spec 7.4.2; role of
    hmr_bitstream_nalu_ebsp, hmr_bitstream.c:123-154)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def ebsp_segment_sizes(rbsp: bytes, boundaries: list[int]) -> list[int]:
    """Escaped byte counts of RBSP segments [b0:b1), [b1:b2), ...

    entry_point_offset values count bytes of the NAL unit payload INCLUDING
    emulation-prevention bytes (spec 7.4.7.1) — role of the reference's
    count_needed_start_codes (hmr_headers.c:586-616). The zero-run scan state
    carries continuously across segment boundaries, matching ebsp_escape.
    """
    sizes = []
    zeros = 0
    for a, b in zip(boundaries[:-1], boundaries[1:]):
        n = 0
        for byte in rbsp[a:b]:
            if zeros >= 2 and byte <= 3:
                n += 1
                zeros = 0
            n += 1
            zeros = zeros + 1 if byte == 0 else 0
        sizes.append(n)
    return sizes


def nal_unit(nal_type: int, rbsp: bytes, temporal_id: int = 0,
             layer_id: int = 0) -> bytes:
    """Two-byte NAL unit header (spec 7.3.1.2) + EBSP payload."""
    h0 = (0 << 7) | (nal_type << 1) | (layer_id >> 5)
    h1 = ((layer_id & 0x1F) << 3) | (temporal_id + 1)
    return bytes([h0, h1]) + ebsp_escape(rbsp)


def annexb_wrap(nal: bytes, long_start_code: bool) -> bytes:
    """Prefix start code (role of HOMER_enc_write_annex_b_output,
    hmr_encoder_lib.c:2196-2227)."""
    return (b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01") + nal


# NAL unit types we emit (spec Table 7-1).
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
