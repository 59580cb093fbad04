"""Plain PyTorch versions of the port's two hand-written CUDA kernels held
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

  ops/me.py integer_me_plain        vs ops/me_pallas.integer_me_pallas
  ops/gather.py gather_windows_plain vs ops/gather_pallas.gather_windows_grid
                                       and p_jax._gather_win (CPU path)

Samples are 8-bit (0..255), as uint8 or int16 planes: that is the kernels'
contract. A pair of planes goes through one gather call and must equal two
calls of the Pallas gather.

Tolerance: exact equality (integer arithmetic and data movement). On the CPU
the port runs the plain versions; the CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py (phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu.ops.gather_pallas import gather_windows_grid
from homerhevc_tpu.ops.me_pallas import integer_me_pallas
from homerhevc_tpu.pipeline import p_jax
from homerhevc_tpu_torch.ops import gather, me
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

PAD = 72


def _me_inputs(kind, H=64, W=128, S=8):
    rng = np.random.default_rng(7)
    n = 2 * S + 1
    mv = rng.integers(0, 40, (n * n,)).astype(np.int32)
    if kind == "random":
        cur = rng.integers(0, 256, (H, W))
        ref = rng.integers(0, 256, (H + 2 * PAD, W + 2 * PAD))
    elif kind == "constant":                 # every offset ties
        cur = np.full((H, W), 77)
        ref = np.full((H + 2 * PAD, W + 2 * PAD), 77)
        mv = np.zeros_like(mv)
    else:                                    # repeated texture: many ties
        tile = rng.integers(0, 256, (4, 4))
        cur = np.tile(tile, (H // 4, W // 4))
        ref = np.tile(tile, ((H + 2 * PAD) // 4, (W + 2 * PAD) // 4))
        mv = np.zeros_like(mv)
    return cur.astype(np.int16), ref.astype(np.int16), mv


@pytest.mark.parametrize("kind", ["random", "constant", "texture"])
def test_integer_me_plain_matches_pallas(kind):
    cur, ref, mv = _me_inputs(kind)
    cj, ij = integer_me_pallas(jnp.asarray(cur), jnp.asarray(ref),
                               jnp.asarray(mv), B=32, search=8, pad=PAD,
                               interpret=True)
    ct, it = me.integer_me_plain(torch.as_tensor(cur), torch.as_tensor(ref),
                                 torch.as_tensor(mv), B=32, search=8,
                                 pad=PAD)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    # the dispatching wrapper takes the plain version for a CPU tensor
    cw, iw = me.integer_me(torch.as_tensor(cur), torch.as_tensor(ref),
                           torch.as_tensor(mv), B=32, search=8, pad=PAD)
    assert torch.equal(cw, ct) and torch.equal(iw, it)


@pytest.mark.parametrize("kind,dtype,search", [
    ("random", torch.uint8, 8), ("random", torch.int16, 8),
    ("constant", torch.uint8, 8), ("constant", torch.int16, 8),
    ("texture", torch.uint8, 8), ("random", torch.uint8, 16),
])
def test_integer_me_plain_dtypes_match_pallas(kind, dtype, search):
    """uint8 and int16 planes of 0..255 samples give the Pallas kernel's
    result, ties (first minimum) and a second search range included."""
    cur, ref, mv = _me_inputs(kind, S=search)
    assert cur.min() >= 0 and cur.max() <= 255
    cj, ij = integer_me_pallas(jnp.asarray(cur), jnp.asarray(ref),
                               jnp.asarray(mv), B=32, search=search, pad=PAD,
                               interpret=True)
    ct, it = me.integer_me(torch.as_tensor(cur).to(dtype),
                           torch.as_tensor(ref).to(dtype),
                           torch.as_tensor(mv), B=32, search=search, pad=PAD)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    if kind == "constant":
        assert int(it.max()) == 0            # every offset ties: the first


# call sites of the P stages at search 8 on a 128x96 frame. At CU size S:
# luma G = S+9 with rows/cols from lo = PAD - (search+7), chroma G = S/2+3
# with lo = PAD/2 - (search/2+3); the hierarchical search's refine window
# G = S+6 with lo = PAD - (search+3). The fixed-CU stage gathers at S 32,
# the quadtree stage at S 16 as well, and FULL at S 8.
SITES = {
    "luma": dict(G=41, S_row=32, mo=8 + 7, pad=PAD, shape=(96, 128)),
    "chroma": dict(G=19, S_row=16, mo=8 // 2 + 3, pad=PAD // 2,
                   shape=(48, 64)),
    "luma16": dict(G=25, S_row=16, mo=8 + 7, pad=PAD, shape=(96, 128)),
    "chroma16": dict(G=11, S_row=8, mo=8 // 2 + 3, pad=PAD // 2,
                     shape=(48, 64)),
    "refine32": dict(G=38, S_row=32, mo=8 + 3, pad=PAD, shape=(96, 128)),
    "refine16": dict(G=22, S_row=16, mo=8 + 3, pad=PAD, shape=(96, 128)),
    # FULL's 8x8 CUs: luma G 17, the chroma pair G 7, the refine window G 14
    "luma8": dict(G=17, S_row=8, mo=8 + 7, pad=PAD, shape=(96, 128)),
    "chroma8": dict(G=7, S_row=4, mo=8 // 2 + 3, pad=PAD // 2,
                    shape=(48, 64)),
    "refine8": dict(G=14, S_row=8, mo=8 + 3, pad=PAD, shape=(96, 128)),
}


def _gather_inputs(site):
    p = SITES[site]
    rng = np.random.default_rng(11)
    h, w = p["shape"]
    Hp, Wp = h + 2 * p["pad"], w + 2 * p["pad"]
    nby, nbx = h // p["S_row"], w // p["S_row"]
    lo = p["pad"] - p["mo"]
    band_h = 2 * p["mo"] + p["G"]
    r = np.arange(nby * nbx) // nbx
    c = np.arange(nby * nbx) % nbx
    span = band_h - p["G"] + 1
    by = (r * p["S_row"] + lo + rng.integers(0, span, r.shape)).astype(
        np.int32)
    bx = (c * p["S_row"] + lo + rng.integers(0, span, c.shape)).astype(
        np.int32)
    plane = rng.integers(-300, 300, (Hp, Wp)).astype(np.int16)
    return plane, by, bx, nby, nbx, lo, band_h


@pytest.mark.parametrize("site", list(SITES))
def test_gather_plain_matches_pallas(site):
    plane, by, bx, nby, nbx, lo, band_h = _gather_inputs(site)
    G = SITES[site]["G"]
    want = gather_windows_grid(jnp.asarray(plane), jnp.asarray(by),
                               jnp.asarray(bx), nby=nby, nbx=nbx, G=G,
                               S_row=SITES[site]["S_row"], lo=lo,
                               band_h=band_h, interpret=True)
    got = gather.gather_windows_plain(torch.as_tensor(plane),
                                      torch.as_tensor(by),
                                      torch.as_tensor(bx), G)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("site", list(SITES))
def test_gather_plain_matches_gather_win_clamped(site):
    """Against the JAX P stage's own gather (vmap of dynamic_slice, which
    clamps out-of-range starts), including starts outside the plane."""
    plane, by, bx, nby, nbx, lo, band_h = _gather_inputs(site)
    G = SITES[site]["G"]
    by[0], bx[1], by[2] = -7, plane.shape[1] + 5, plane.shape[0] - 3
    want = p_jax._gather_win(jnp.asarray(plane), jnp.asarray(by),
                             jnp.asarray(bx), nby=nby, nbx=nbx, G=G,
                             S_row=SITES[site]["S_row"], lo=lo,
                             band_h=band_h)                  # (G, G, nb)
    got = gather.gather_windows(torch.as_tensor(plane), torch.as_tensor(by),
                                torch.as_tensor(bx), G)
    np.testing.assert_array_equal(np.asarray(want).transpose(2, 0, 1),
                                  got.numpy())


@pytest.mark.parametrize("site", list(SITES))
def test_gather_plain_pair_matches_two_pallas_calls(site):
    """A tuple of planes of one shape -> (P, nb, G, G), equal to one Pallas
    gather per plane (the two chroma planes share their starts)."""
    plane, by, bx, nby, nbx, lo, band_h = _gather_inputs(site)
    other = np.random.default_rng(12).integers(
        -300, 300, plane.shape).astype(np.int16)
    G = SITES[site]["G"]
    want = [gather_windows_grid(jnp.asarray(p), jnp.asarray(by),
                                jnp.asarray(bx), nby=nby, nbx=nbx, G=G,
                                S_row=SITES[site]["S_row"], lo=lo,
                                band_h=band_h, interpret=True)
            for p in (plane, other)]
    pair = (torch.as_tensor(plane), torch.as_tensor(other))
    got = gather.gather_windows_plain(pair, torch.as_tensor(by),
                                      torch.as_tensor(bx), G)
    assert got.shape == (2, nby * nbx, G, G)
    np.testing.assert_array_equal(np.stack([np.asarray(w) for w in want]),
                                  got.numpy())
    # the dispatching wrapper takes the plain version for CPU tensors
    assert torch.equal(gather.gather_windows(pair, torch.as_tensor(by),
                                             torch.as_tensor(bx), G), got)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_block_sizes():
    """The CUDA wrappers launch or raise: a CPU tensor is refused, never
    handed to the plain version behind the caller's back."""
    cur, ref, mv = _me_inputs("random")
    args = (torch.as_tensor(cur), torch.as_tensor(ref), torch.as_tensor(mv))
    with pytest.raises(ValueError, match="CUDA"):
        me.integer_me_cuda(*args, B=32, search=8, pad=PAD)
    plane, by, bx, *_ = _gather_inputs("luma")
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_windows_cuda(torch.as_tensor(plane),
                                   torch.as_tensor(by), torch.as_tensor(bx),
                                   41)
    with pytest.raises(ValueError, match="planes"):
        gather.gather_windows_cuda((), torch.as_tensor(by),
                                   torch.as_tensor(bx), 41)
