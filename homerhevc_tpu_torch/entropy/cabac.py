"""CABAC binary arithmetic encoder + RD bit counter (spec 9.3).

Role of the reference's hmr_binary_encoding.c (BAC + counter twin;
homer_lib/hmr_binary_encoding.c:63-305 encoder,
:306-551 counter) and the context-init machinery of
hmr_arithmetic_encoding.c:92-230. Implemented from the ITU-T H.265 spec:
  * arithmetic core        — spec 9.3.4.3 (EncodeDecision/Bypass/Terminate)
  * state tables           — spec Tables 9-46 (rangeTabLPS), 9-47 (transIdx)
  * context initialisation — spec 9.3.2.2
The per-syntax-element init values are the normative constants of spec
Tables 9-5..9-32 (same values as HM's INIT_* tables).

This pure-Python engine is the correctness oracle; the production path uses
the native C++ backend (entropy/native) exercising identical tables.
"""

from __future__ import annotations

import math

import numpy as np

# --------------------------------------------------------------------------
# Spec Table 9-46: rangeTabLPS[pStateIdx][qRangeIdx]
# --------------------------------------------------------------------------
RANGE_TAB_LPS = np.array([
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

# Spec Table 9-47: transIdxLps (state 0 additionally flips valMps).
TRANS_IDX_LPS = np.array(
    [0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
     13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
     24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
     33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63],
    dtype=np.int32)

TRANS_IDX_MPS = np.minimum(np.arange(64) + 1, 62).astype(np.int32)
TRANS_IDX_MPS[63] = 63


# --------------------------------------------------------------------------
# Fractional-bit estimates for RD (role of g_bc_entropy_bits,
# hmr_binary_encoding.c:280-301 / FAST_BIT_EST). 15-bit fixed point.
# p_LPS(state) = 0.5 * alpha^state with alpha = (0.01875 / 0.5)^(1/63).
# --------------------------------------------------------------------------
_ALPHA = (0.01875 / 0.5) ** (1.0 / 63.0)
_P_LPS = 0.5 * _ALPHA ** np.arange(64)
# FRAC_BITS[state][0] = cost of coding the MPS, [1] = cost of the LPS.
FRAC_BITS = np.stack([
    np.round(-np.log2(1.0 - _P_LPS) * 32768),
    np.round(-np.log2(_P_LPS) * 32768),
], axis=1).astype(np.int32)
EP_BIT = 32768  # one bypass bin


def init_context_states(init_values: np.ndarray, qp: int):
    """Spec 9.3.2.2: initValue -> (pStateIdx, valMps) arrays."""
    iv = init_values.astype(np.int32)
    slope = (iv >> 4) * 5 - 45
    offset = ((iv & 15) << 3) - 16
    pre = np.clip(((slope * np.clip(qp, 0, 51)) >> 4) + offset, 1, 126)
    mps = (pre > 63).astype(np.int32)
    state = np.where(mps == 1, pre - 64, 63 - pre).astype(np.int32)
    return state, mps


# --------------------------------------------------------------------------
# Context layout. Offsets into one flat context array; counts per element.
# --------------------------------------------------------------------------
CNU = 154

_LAYOUT = [
    ("SAO_MERGE", 1), ("SAO_TYPE", 1), ("SPLIT_CU", 3), ("TQ_BYPASS", 1),
    ("SKIP", 3), ("MERGE_FLAG", 1), ("MERGE_IDX", 1), ("PART_SIZE", 4),
    ("PRED_MODE", 1), ("INTRA_LUMA", 1), ("INTRA_CHROMA", 2),
    ("INTER_DIR", 5), ("MVD", 2), ("REF_IDX", 2), ("DQP", 3),
    ("CBF_LUMA", 4), ("CBF_CHROMA", 4), ("ROOT_CBF", 1),
    ("LAST_X", 30), ("LAST_Y", 30), ("SIG_CG", 4), ("SIG", 42),
    ("ONE", 24), ("ABS", 6), ("MVP_IDX", 1), ("TRANS_SUBDIV", 3),
    ("TRANSFORM_SKIP", 2),
]

OFF = {}
_total = 0
for _name, _n in _LAYOUT:
    OFF[_name] = _total
    _total += _n
NUM_CTX = _total

# Init values indexed [init_type][ctx]; init_type: 0 = I, 1 = P, 2 = B
# (spec 9.3.2.2 initType; values from spec Tables 9-5..9-32).
_INIT = {
    "SAO_MERGE": [[153], [153], [153]],
    "SAO_TYPE": [[200], [185], [160]],
    "SPLIT_CU": [[139, 141, 157], [107, 139, 126], [107, 139, 126]],
    "TQ_BYPASS": [[154], [154], [154]],
    "SKIP": [[CNU] * 3, [197, 185, 201], [197, 185, 201]],
    "MERGE_FLAG": [[CNU], [110], [154]],
    "MERGE_IDX": [[CNU], [122], [137]],
    "PART_SIZE": [[184, CNU, CNU, CNU], [154, 139, 154, 154], [154, 139, 154, 154]],
    "PRED_MODE": [[CNU], [149], [134]],
    "INTRA_LUMA": [[184], [154], [183]],
    "INTRA_CHROMA": [[63, 139], [152, 139], [152, 139]],
    "INTER_DIR": [[CNU] * 5, [95, 79, 63, 31, 31], [95, 79, 63, 31, 31]],
    "MVD": [[CNU] * 2, [140, 198], [169, 198]],
    "REF_IDX": [[CNU] * 2, [153, 153], [153, 153]],
    "DQP": [[154] * 3] * 3,
    "CBF_LUMA": [[111, 141, CNU, CNU], [153, 111, CNU, CNU], [153, 111, CNU, CNU]],
    "CBF_CHROMA": [[94, 138, 182, 154], [149, 107, 167, 154], [149, 92, 167, 154]],
    "ROOT_CBF": [[CNU], [79], [79]],
    "LAST_X": [
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63] + [CNU] * 12,
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         108, 123, 108] + [CNU] * 12,
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93] + [CNU] * 12,
    ],
    "SIG_CG": [[91, 171, 134, 141], [121, 140, 61, 154], [121, 140, 61, 154]],
    "SIG": [
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140,
         139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140],
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140],
    ],
    "ONE": [
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
         122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
    ],
    "ABS": [
        [138, 153, 136, 167, 152, 152],
        [107, 167, 91, 122, 107, 167],
        [107, 167, 91, 107, 107, 167],
    ],
    "MVP_IDX": [[CNU], [168], [168]],
    "TRANS_SUBDIV": [[153, 138, 138], [124, 138, 94], [224, 167, 122]],
    "TRANSFORM_SKIP": [[139, 139]] * 3,
}
_INIT["LAST_Y"] = _INIT["LAST_X"]


def init_values_for(init_type: int) -> np.ndarray:
    out = np.zeros(NUM_CTX, dtype=np.int32)
    for name, n in _LAYOUT:
        vals = _INIT[name][init_type]
        assert len(vals) == n, name
        out[OFF[name]:OFF[name] + n] = vals
    return out


class ContextSet:
    """Mutable context states for one CABAC pass."""

    __slots__ = ("state", "mps")

    def __init__(self, init_type: int, qp: int):
        self.state, self.mps = init_context_states(init_values_for(init_type), qp)

    def copy(self) -> "ContextSet":
        c = object.__new__(ContextSet)
        c.state = self.state.copy()
        c.mps = self.mps.copy()
        return c

    def load(self, other: "ContextSet") -> None:
        self.state[:] = other.state
        self.mps[:] = other.mps


class CabacEncoder:
    """Spec 9.3.4.3 arithmetic encoder writing into a BitWriter."""

    __slots__ = ("bw", "low", "range", "bits_outstanding", "first_bit")

    def __init__(self, bit_writer):
        self.bw = bit_writer
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True

    # -- internals ---------------------------------------------------------
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
                self.low -= 512
                self._put_bit(1)
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.range <<= 1
            self.low <<= 1

    # -- public ------------------------------------------------------------
    def encode_bin(self, ctxs: ContextSet, ctx_idx: int, bin_val: int) -> None:
        state = int(ctxs.state[ctx_idx])
        mps = int(ctxs.mps[ctx_idx])
        lps = int(RANGE_TAB_LPS[state, (self.range >> 6) & 3])
        self.range -= lps
        if bin_val != mps:
            self.low += self.range
            self.range = lps
            if state == 0:
                ctxs.mps[ctx_idx] = 1 - mps
            ctxs.state[ctx_idx] = TRANS_IDX_LPS[state]
        else:
            ctxs.state[ctx_idx] = TRANS_IDX_MPS[state]
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
            self.low -= 512
            self.bits_outstanding += 1

    def encode_bypass_bins(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put_bit((self.low >> 9) & 1)
            self.bw.write(((self.low >> 7) & 3) | 1, 2)
        else:
            self._renorm()

    def finish(self) -> None:
        """encode_terminate(1) already flushed; caller adds rbsp trailing."""


class CabacCounter:
    """Fractional-bit counter twin for RD estimates (no output bits).

    Role of the bc_* counter environment (hmr_binary_encoding.c:306-551):
    accumulates 15-bit fractional bits and updates context states the same
    way the real encoder would.
    """

    __slots__ = ("frac_bits",)

    def __init__(self):
        self.frac_bits = 0

    def reset(self):
        self.frac_bits = 0

    def encode_bin(self, ctxs: ContextSet, ctx_idx: int, bin_val: int) -> None:
        state = int(ctxs.state[ctx_idx])
        mps = int(ctxs.mps[ctx_idx])
        is_lps = int(bin_val != mps)
        self.frac_bits += int(FRAC_BITS[state, is_lps])
        if is_lps:
            if state == 0:
                ctxs.mps[ctx_idx] = 1 - mps
            ctxs.state[ctx_idx] = TRANS_IDX_LPS[state]
        else:
            ctxs.state[ctx_idx] = TRANS_IDX_MPS[state]

    def encode_bypass(self, bin_val: int) -> None:
        self.frac_bits += EP_BIT

    def encode_bypass_bins(self, value: int, nbits: int) -> None:
        self.frac_bits += EP_BIT * nbits

    def encode_terminate(self, bin_val: int) -> None:
        self.frac_bits += EP_BIT

    @property
    def bits(self) -> float:
        return self.frac_bits / 32768.0
