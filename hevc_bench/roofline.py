"""Least device times of the port's hand-written kernels, from shapes
alone (the yardstick of PERF.md's kernel table).

Peaks of one NVIDIA H100 SXM at its full power limit: device memory
3.35 TB/s (data sheet). `me_sad`'s integer rate is derived, not a
data-sheet figure: 4 absolute differences per VABSDIFF4 instruction, 64
32-bit integer lanes per SM, 132 SMs, at the card's 1.98 GHz maximum SM
clock. Every share that uses it says so.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT_LANES_PER_SM = 64
DIFFS_PER_INSTRUCTION = 4
MAX_SM_HZ = 1.98e9
DIFF_RATE = DIFFS_PER_INSTRUCTION * INT_LANES_PER_SM * SMS * MAX_SM_HZ
# reference planes of the P stage: int16, edge-padded by 72 samples
REF_PAD = 72


def me_sad_differences(H: int, W: int, B: int, S: int) -> int:
    """Absolute differences of the full search: every block against every
    offset of the (2S+1)^2 window."""
    nb = (H // B) * (W // B)
    return nb * (2 * S + 1) ** 2 * B * B


def me_sad_bytes(H: int, W: int, B: int, S: int) -> int:
    """The current plane (uint8) and the padded reference (int16) read
    once, the offset costs read once, a cost and an index per block
    written once."""
    nb = (H // B) * (W // B)
    return (H * W + (H + 2 * REF_PAD) * (W + 2 * REF_PAD) * 2
            + (2 * S + 1) ** 2 * 4 + 2 * nb * 4)


def me_sad_least_s(H: int, W: int, B: int, S: int) -> tuple:
    """(seconds, 'operations' or 'bytes'): the larger bound."""
    ops = me_sad_differences(H, W, B, S) / DIFF_RATE
    mem = me_sad_bytes(H, W, B, S) / HBM_BYTES_PER_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def gather_bytes(H: int, W: int, B: int, G: int, planes: int) -> int:
    """One gather site: on each of `planes` int16 planes, the distinct
    samples that the G x G windows of the (H/B) x (W/B) blocks cover read
    once (the windows of one motion field overlap: their union is the
    block grid grown by G - B), every window written once."""
    nby, nbx = H // B, W // B
    covered = (nby * B + G - B) * (nbx * B + G - B)
    return planes * 2 * (covered + nby * nbx * G * G)


def gather_sites(H: int, W: int, cu_sizes, search: int) -> list:
    """(H, W, B, G, planes) of each gather site of a P stage that codes
    CUs of `cu_sizes` on an H x W luma plane: the quarter-pel luma window
    (G = B + 9) and the chroma pair (G = B/2 + 3) per CU size, and above
    search 24 the hierarchical search's refine window (G = B + 6)."""
    sites = []
    for B in cu_sizes:
        sites.append((H, W, B, B + 9, 1))
        sites.append((H // 2, W // 2, B // 2, B // 2 + 3, 2))
        if search > 24:
            sites.append((H, W, B, B + 6, 1))
    return sites


def gather_least_s(sites) -> float:
    return sum(gather_bytes(*s) for s in sites) / HBM_BYTES_PER_S
