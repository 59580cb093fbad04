"""NAL units, RBSP bits and the CABAC decoding engine (H.265 7.3, 9.3)."""

from __future__ import annotations

import bisect

import numpy as np

NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34


class Nal:
    """One NAL unit: its type, its RBSP (emulation prevention removed) and
    the raw payload positions of the removed bytes."""

    def __init__(self, payload: bytes):
        if len(payload) < 2:
            raise ValueError("NAL unit shorter than its header")
        self.type = (payload[0] >> 1) & 0x3F
        raw = payload[2:]
        out = bytearray()
        self.removed = []          # raw index (in `raw`) of each 0x03 dropped
        zeros = 0
        for i, b in enumerate(raw):
            if zeros >= 2 and b == 3:
                self.removed.append(i)
                zeros = 0
                continue
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        self.rbsp = bytes(out)

    def rbsp_pos(self, raw_pos: int) -> int:
        """RBSP byte index of raw payload byte `raw_pos`."""
        return raw_pos - bisect.bisect_left(self.removed, raw_pos)

    def raw_pos(self, rbsp_pos: int) -> int:
        """Raw payload byte index of RBSP byte `rbsp_pos`."""
        raw = rbsp_pos
        for r in self.removed:
            if r <= raw:
                raw += 1
            else:
                break
        return raw


def split_nals(au: bytes) -> list:
    """The NAL units of an Annex-B byte stream."""
    starts = []
    i, n = 0, len(au)
    while True:
        j = au.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j + 3)
        i = j + 3
    nals = []
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        while e > s and au[e - 1] == 0:     # trailing zeros / next prefix
            e -= 1
        nals.append(Nal(au[s:e]))
    return nals


class BitReader:
    """Fixed- and variable-length codes of an RBSP (9.2)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos              # in bits

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("exp-Golomb code too long")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def byte_aligned(self) -> bool:
        return self.pos % 8 == 0


# Table 9-46 (rangeTabLPS) and 9-47 (transIdxLps)
RANGE_LPS = [
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
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2]]
TRANS_LPS = [0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15,
             15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26,
             26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34,
             34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63]
TRANS_MPS = [min(s + 1, 62) for s in range(63)] + [63]
# shifts that bring an LPS range back to at least 256, by LPS >> 3
RENORM = [6, 5, 4, 4, 3, 3, 3, 3] + [2] * 8 + [1] * 16

CNU = 154
# context layout: (name, count) and init values per initType (0 I, 1 P,
# 2 B), Tables 9-5 to 9-37
LAYOUT = (
    ("SAO_MERGE", 1, [[153], [153], [153]]),
    ("SAO_TYPE", 1, [[200], [185], [160]]),
    ("SPLIT_CU", 3, [[139, 141, 157], [107, 139, 126], [107, 139, 126]]),
    ("SKIP", 3, [[CNU] * 3, [197, 185, 201], [197, 185, 201]]),
    ("MERGE_FLAG", 1, [[CNU], [110], [154]]),
    ("MERGE_IDX", 1, [[CNU], [122], [137]]),
    ("PART_MODE", 4, [[184, CNU, CNU, CNU], [154, 139, 154, 154],
                      [154, 139, 154, 154]]),
    ("PRED_MODE", 1, [[CNU], [149], [134]]),
    ("INTRA_LUMA", 1, [[184], [154], [183]]),
    ("INTRA_CHROMA", 1, [[63], [152], [152]]),
    ("INTER_DIR", 5, [[CNU] * 5, [95, 79, 63, 31, 31],
                      [95, 79, 63, 31, 31]]),
    ("MVD", 2, [[CNU] * 2, [140, 198], [169, 198]]),
    ("REF_IDX", 2, [[CNU] * 2, [153, 153], [153, 153]]),
    ("DQP", 2, [[154, 154], [154, 154], [154, 154]]),
    ("CBF_LUMA", 2, [[111, 141], [153, 111], [153, 111]]),
    ("CBF_CHROMA", 4, [[94, 138, 182, 154], [149, 107, 167, 154],
                       [149, 92, 167, 154]]),
    ("ROOT_CBF", 1, [[CNU], [79], [79]]),
    ("LAST_X", 18, [[110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111,
                     143, 127, 111, 79, 108, 123, 63],
                    [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111,
                     111, 95, 94, 108, 123, 108],
                    [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126,
                     111, 111, 79, 108, 123, 93]]),
    ("LAST_Y", 18, None),
    ("CSBF", 4, [[91, 171, 134, 141], [121, 140, 61, 154],
                 [121, 140, 61, 154]]),
    ("SIG", 42, [[111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141,
                  179, 153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141,
                  179, 153, 125, 140, 139, 182, 182, 152, 136, 152, 136, 153,
                  136, 139, 111, 136, 139, 111],
                 [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140,
                  136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140,
                  136, 153, 154, 170, 153, 123, 123, 107, 121, 107, 121, 167,
                  151, 183, 140, 151, 183, 140],
                 [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140,
                  136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140,
                  136, 153, 154, 170, 153, 138, 138, 122, 121, 122, 121, 167,
                  151, 183, 140, 151, 183, 140]]),
    ("GT1", 24, [[140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92,
                  139, 107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
                 [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136,
                  153, 121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
                 [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136,
                  153, 121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182]]),
    ("GT2", 6, [[138, 153, 136, 167, 152, 152], [107, 167, 91, 122, 107, 167],
                [107, 167, 91, 107, 107, 167]]),
    ("MVP_FLAG", 1, [[CNU], [168], [168]]),
    ("SPLIT_TU", 3, [[153, 138, 138], [124, 138, 94], [224, 167, 122]]),
)
OFF = {}
_n = 0
for _name, _count, _ in LAYOUT:
    OFF[_name] = _n
    _n += _count
NUM_CTX = _n


def init_contexts(init_type: int, qp: int):
    """(pStateIdx list, valMps list) of every context (9.3.2.2)."""
    vals = []
    last = None
    for _, count, table in LAYOUT:
        table = table if table is not None else last
        vals += table[init_type]
        last = table
    iv = np.array(vals, dtype=np.int64)
    slope = (iv >> 4) * 5 - 45
    offset = ((iv & 15) << 3) - 16
    pre = np.clip(((slope * min(max(qp, 0), 51)) >> 4) + offset, 1, 126)
    mps = (pre > 63).astype(np.int64)
    state = np.where(mps == 1, pre - 64, 63 - pre)
    return [int(s) for s in state], [int(m) for m in mps]


class Cabac:
    """The arithmetic decoding engine (9.3.4.3), reading bytes of `data`
    from `pos`; the value register holds 7 bits beyond the offset."""

    __slots__ = ("data", "pos", "range", "value", "need", "st", "mps")

    def __init__(self, data: bytes, pos: int, st: list, mps: list):
        self.data = data
        self.pos = pos
        self.st = st
        self.mps = mps
        self.range = 510
        self.need = -8
        self.value = (self._byte() << 8) | self._byte()

    def _byte(self) -> int:
        p = self.pos
        self.pos = p + 1
        return self.data[p] if p < len(self.data) else 0

    def decode(self, ctx: int) -> int:
        st = self.st[ctx]
        lps = RANGE_LPS[st][(self.range >> 6) & 3]
        rng = self.range - lps
        scaled = rng << 7
        if self.value < scaled:
            b = self.mps[ctx]
            self.st[ctx] = TRANS_MPS[st]
            if scaled < 32768:
                self.range = rng << 1
                self.value <<= 1
                self.need += 1
                if self.need == 0:
                    self.need = -8
                    self.value += self._byte()
            else:
                self.range = rng
            return b
        nb = RENORM[lps >> 3]
        self.value = (self.value - scaled) << nb
        self.range = lps << nb
        b = 1 - self.mps[ctx]
        if st == 0:
            self.mps[ctx] = b
        self.st[ctx] = TRANS_LPS[st]
        self.need += nb
        if self.need >= 0:
            self.value += self._byte() << self.need
            self.need -= 8
        return b

    def bypass(self) -> int:
        self.value <<= 1
        self.need += 1
        if self.need >= 0:
            self.need = -8
            self.value += self._byte()
        scaled = self.range << 7
        if self.value >= scaled:
            self.value -= scaled
            return 1
        return 0

    def bypass_bins(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    def terminate(self) -> int:
        self.range -= 2
        scaled = self.range << 7
        if self.value >= scaled:
            return 1
        if scaled < 32768:
            self.range <<= 1
            self.value <<= 1
            self.need += 1
            if self.need == 0:
                self.need = -8
                self.value += self._byte()
        return 0
