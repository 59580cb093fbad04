"""The split-RDO IDR stage of the torch port (the intra CU quadtree down to
8x8 luma with NxN leaves and one level of intra TU split) against the JAX
package, on the CPU. Tolerance: exact equality.

Compared live (both packages run in this process, same numpy inputs):

  intra_torch._open_loop_maps    vs intra_jax._open_loop_maps, map by map,
                                    TU split on and off
  intra_torch._follow_unit       vs intra_jax._follow_unit on decided 16x16
                                    subtrees: whole, TU-split, split into 8x8
                                    leaves that are plain, NxN or TU-split;
                                    and the 8x8 chroma subtree
  deblock.intra_bs_from_depth_units(trd_u=)  vs the reference's
  p_torch.deblock_intra_device(trd_units=)   vs p_jax.deblock_intra_device

Compared through the committed fixture (tests/fixtures/torch_port_aus.json,
written from the JAX package by tools/make_torch_fixtures.py; the whole
reference stage compiles for minutes on a CPU per shape and transform depth):

  intra_torch.encode_frame_intra(split_rdo=True, tu_depth=0|1) at 96x64 and
  128x96 with sign hiding: levels, recon, unit maps and wire, one SHA-256
  per array.

Each test asserts that its input drives the branches it names.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu import tables as jtables
from homerhevc_tpu.ops import deblock as jdbk
from homerhevc_tpu.pipeline import intra_jax, p_jax
from homerhevc_tpu_torch.ops import deblock as tdbk
from homerhevc_tpu_torch.pipeline import intra_torch, p_torch
from homerhevc_tpu_torch.utils import fixtures as fx
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")
QP = 32
I32 = torch.int32


def _eq(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.cpu().numpy(),
                                  err_msg=msg)


@functools.lru_cache(maxsize=None)
def _port_frame(case: str):
    """The port's output dict for one of the fixture's intra cases."""
    c = fx.INTRA_CASES[case]
    frame = fx.intra_frame(c["width"], c["height"], c["seed"])
    return intra_torch.encode_frame_intra(
        *map(torch.as_tensor, frame), B=32, qp=QP, sign_hiding=True,
        split_rdo=True, tu_depth=c["tu_depth"])


# ---------------------------------------------------------------------------
# pass A
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tu_split", [True, False])
def test_open_loop_maps(tu_split):
    y = fx.intra_frame(128, 96, 5)[0]
    lam = int(jtables.LAMBDA_FX[QP])
    fn = jax.jit(intra_jax._open_loop_maps,
                 static_argnames=("B", "strong_smoothing", "rd_mode",
                                  "tu_split"))
    want = fn(jnp.asarray(y), B=32, qp=jnp.int32(QP), lam_fx=jnp.int32(lam),
              strong_smoothing=True, tu_split=tu_split)
    got = intra_torch._open_loop_maps(
        torch.as_tensor(y), B=32, qp=torch.tensor(QP, dtype=I32),
        lam_fx=torch.tensor(lam, dtype=I32), strong_smoothing=True,
        tu_split=tu_split)
    for name, a, b in zip(("mode_u", "depth_u", "part_u", "trd_u"), want,
                          got):
        _eq(a, b.to(I32), name)
    mode_u, depth_u, part_u, trd_u = got
    for d in (0, 1, 2):
        assert (depth_u == d).any(), f"no CU of depth {d}"
    assert part_u.any(), "no NxN leaf"
    assert not (part_u & (depth_u < 2)).any()
    assert bool(trd_u.any()) == tu_split
    if tu_split:
        assert ((trd_u > 0) & (depth_u == 1)).any(), "no TU split of a 16x16"
        assert ((trd_u > 0) & (depth_u == 2)).any(), "no TU split of an 8x8"
        assert not ((trd_u > 0) & part_u).any()
    # an NxN leaf holds more than one mode
    m = mode_u.numpy()
    p = part_u.numpy()
    assert any(len(set(m[y0:y0 + 2, x0:x0 + 2].ravel())) > 1
               for y0, x0 in zip(*np.nonzero(p)) if y0 % 2 == 0
               and x0 % 2 == 0)


# ---------------------------------------------------------------------------
# pass B: decided subtrees
# ---------------------------------------------------------------------------

def _subtrees(rng, L: int):
    """Decided quadtrees of L 16x16 luma CUs (depth 1 of a 32 container) as
    4x4 unit maps (mode, depth, part, trd): whole CUs, TU-split CUs, and CUs
    split into four 8x8 leaves that are plain, NxN (four modes) or
    TU-split."""
    mode = np.zeros((L, 4, 4), np.int32)
    depth = np.ones((L, 4, 4), np.int32)
    part = np.zeros((L, 4, 4), bool)
    trd = np.zeros((L, 4, 4), np.int32)
    for lane in range(L):
        kind = lane % 3
        if kind < 2:                       # a 16x16 leaf, kind 1: TU split
            mode[lane] = rng.integers(0, 35)
            trd[lane] = kind
            continue
        depth[lane] = 2
        for q, (qy, qx) in enumerate(((0, 0), (0, 2), (2, 0), (2, 2))):
            sl = (lane, slice(qy, qy + 2), slice(qx, qx + 2))
            leaf = (lane // 3 + q) % 3     # plain, NxN, TU split
            mode[sl] = rng.integers(0, 35)
            if leaf == 1:
                part[sl] = True
                mode[sl] = rng.integers(0, 35, (2, 2))
            elif leaf == 2:
                trd[sl] = 1
    return mode, depth, part, trd


def _lane_inputs(rng, L: int, size: int, W: int):
    """Random samples and neighbours of L blocks of `size` in a row of width
    W: (o, top, left, corner, has_left, has_top, trow, lcol, x0)."""
    o = rng.integers(0, 256, (L, size, size)).astype(np.int32)
    # smooth-ish content so that levels survive quantization but are sparse
    o = (o // 8 + np.linspace(60, 160, size)[None, None, :]
         + 30 * np.sin(np.arange(size) / 2.0)[None, :, None]).astype(np.int32)
    trow = rng.integers(40, 200, (L, W)).astype(np.int32)
    lcol = rng.integers(40, 200, (L, size)).astype(np.int32)
    x0 = (rng.integers(0, W // size, (L,)) * size).astype(np.int32)
    x0[0], x0[1] = 0, W - size             # picture edges: corner and clip
    ar = np.arange(2 * size)
    top = np.take_along_axis(trow, np.clip(x0[:, None] + ar, 0, W - 1), 1)
    left = np.concatenate([lcol, np.repeat(lcol[:, -1:], size, 1)], 1)
    corner = np.take_along_axis(trow, np.clip(x0 - 1, 0, W - 1)[:, None],
                                1)[:, 0]
    hl = rng.integers(0, 2, (L,)).astype(bool)
    ht = rng.integers(0, 2, (L,)).astype(bool)
    hl[:4] = [True, True, False, False]
    ht[:4] = [True, False, True, False]
    return o, top, left, corner, hl, ht, trow, lcol, x0


def _follow_both(inputs, maps, *, size, depth, min_size, c_idx, qp, W,
                 with_part, tu_split):
    """(levels, recon) of the reference (vmapped over the lanes, jitted) and
    of the port for the same decided subtrees."""
    o, top, left, corner, hl, ht, trow, lcol, x0 = inputs
    mode, dep, part, trd = maps

    def one(o, top, left, corner, hl, ht, trow, lcol, x0, mode, dep, part,
            trd):
        return intra_jax._follow_unit(
            o, (top, left, corner, hl, ht), (trow, lcol, x0, None, W), mode,
            dep, size=size, depth=depth, min_size=min_size, c_idx=c_idx,
            qp=jnp.int32(qp), lam_fx=jnp.int32(0), sign_hiding=True,
            strong_smoothing=True, f_part=(part if with_part else None),
            f_trd=(trd if tu_split else None))

    want = jax.jit(jax.vmap(one))(*map(jnp.asarray, inputs + maps))

    t = [torch.as_tensor(a) for a in inputs]
    tmode, tdep, tpart, ttrd = (torch.as_tensor(a) for a in maps)
    eff_depth, eff_nxn = intra_torch._effective_tree(tdep, tpart, ttrd,
                                                     tu_split)
    tree = intra_torch._Followed(
        tmode, eff_depth, eff_nxn if with_part else None, eff_depth.numpy(),
        eff_nxn.numpy() if with_part else None)
    got = intra_torch._follow_unit(
        t[0], tuple(t[1:6]), (t[6], t[7], t[8]), tree, 0, 0,
        np.ones((o.shape[0],), bool), size=size, depth=depth,
        min_size=min_size, c_idx=c_idx, qp=torch.tensor(qp, dtype=I32),
        sign_hiding=True, strong_smoothing=True, W=W)
    return want, got


def test_follow_unit_luma_subtree():
    rng = np.random.default_rng(7)
    L, W = 12, 64
    inputs = _lane_inputs(rng, L, 16, W)
    maps = _subtrees(rng, L)
    mode, dep, part, trd = maps
    assert (dep == 2).any() and part.any()
    assert (trd[dep == 1] > 0).any() and (trd[dep == 2] > 0).any()
    want, got = _follow_both(inputs, maps, size=16, depth=1, min_size=8,
                             c_idx=0, qp=QP, W=W, with_part=True,
                             tu_split=True)
    _eq(want[0], got[0], "levels")
    _eq(want[1], got[1], "recon")
    assert got[0].reshape(L, -1).any(dim=1).all(), "a lane coded no level"


def test_follow_unit_chroma_subtree():
    # chroma follows the luma tree sampled at every other unit: an 8x8
    # chroma block of a 16x16 luma CU that is whole, TU-split (four 4x4 TBs)
    # or split into 8x8 CUs (four 4x4 blocks with their modes)
    rng = np.random.default_rng(8)
    L, W = 12, 32
    inputs = _lane_inputs(rng, L, 8, W)
    mode, dep, part, trd = _subtrees(rng, L)
    maps = tuple(np.ascontiguousarray(a[:, ::2, ::2])
                 for a in (mode, dep, part, trd))
    want, got = _follow_both(inputs, maps, size=8, depth=1, min_size=4,
                             c_idx=1, qp=int(jtables.chroma_qp_from_luma(QP)),
                             W=W, with_part=False, tu_split=True)
    _eq(want[0], got[0], "levels")
    _eq(want[1], got[1], "recon")
    assert got[0].any()


# ---------------------------------------------------------------------------
# the whole stage, held to the fixture written from the JAX package
# ---------------------------------------------------------------------------

def test_intra_frame_is_deterministic():
    # the fixture's arrays depend on it
    y, u, v = fx.intra_frame(96, 64, 5)
    assert y.shape == (64, 96) and u.shape == v.shape == (32, 48)
    assert fx.array_digest(y) == fx.array_digest(fx.intra_frame(96, 64, 5)[0])
    assert fx.array_digest(np.arange(6).reshape(2, 3)) \
        != fx.array_digest(np.arange(6).reshape(3, 2))


@pytest.mark.parametrize("case", list(fx.INTRA_CASES))
def test_encode_frame_intra_split_matches_fixture(case):
    with open(FIXTURE) as f:
        want = json.load(f)["intra_split"][case]
    assert {k: want[k] for k in fx.INTRA_CASES[case]} == fx.INTRA_CASES[case]
    got = _port_frame(case)
    for k in fx.INTRA_KEYS:
        assert fx.array_digest(got[k].cpu().numpy()) == want["arrays"][k], k


@pytest.mark.parametrize("case", list(fx.INTRA_CASES))
def test_encode_frame_intra_split_branches(case):
    c = fx.INTRA_CASES[case]
    H, W = c["height"], c["width"]
    out = _port_frame(case)
    depth_u, part_u, trd_u = (out[k] for k in ("depth_units", "part_units",
                                               "trd_units"))
    for d in (0, 1, 2):
        assert (depth_u == d).any(), f"no CU of depth {d}"
    assert part_u.any(), "no NxN leaf"
    assert bool(trd_u.any()) == bool(c["tu_depth"])
    if c["tu_depth"]:
        assert ((trd_u > 0) & (depth_u == 1)).any()
        assert ((trd_u > 0) & (depth_u == 2)).any()
    assert out["recon_y"].dtype == torch.uint8
    assert out["recon_y"].shape == (H, W)
    assert out["lev_y"].any() and out["lev_u"].any() and out["lev_v"].any()
    # the host unpack reads the wire back
    cnt, mode_u, dep, part, trd, idx, vals = intra_torch.unpack_intra_wire(
        out["wire"].numpy(), H, W)
    assert 0 < cnt <= intra_torch.intra_wire_cap(H, W)
    np.testing.assert_array_equal(mode_u, out["mode_units"].numpy())
    np.testing.assert_array_equal(dep, depth_u.numpy())
    np.testing.assert_array_equal(part, part_u.numpy())
    np.testing.assert_array_equal(trd, trd_u.numpy())


def test_tu_depth_0_is_the_tree_without_tu_split():
    # with tu_depth 0 pass A decides without the TU-split candidates, so
    # the two trees differ and neither run leaks a trd flag
    a, b = _port_frame("96x64_tu1"), _port_frame("96x64_tu0")
    assert not b["trd_units"].any()
    assert not torch.equal(a["part_units"], b["part_units"])


# ---------------------------------------------------------------------------
# deblocking with TU-split edges
# ---------------------------------------------------------------------------

def test_intra_bs_from_depth_units_trd():
    out = _port_frame("96x64_tu1")
    depth_u, trd_u = out["depth_units"], out["trd_units"]
    want = jdbk.intra_bs_from_depth_units(depth_u.numpy(),
                                          trd_u=trd_u.numpy())
    got = tdbk.intra_bs_from_depth_units(depth_u, trd_u=trd_u)
    plain = tdbk.intra_bs_from_depth_units(depth_u)
    for a, b in zip(want, got):
        _eq(a, b)
    # a TU split of a 16x16 CU adds edges on the 8-pel grid
    assert any(not torch.equal(a, b) for a, b in zip(got, plain))


def test_deblock_intra_device_trd():
    out = _port_frame("96x64_tu1")
    rec = tuple(out[k] for k in ("recon_y", "recon_u", "recon_v"))
    want = p_jax.deblock_intra_device(
        *(jnp.asarray(p.numpy()) for p in rec), B=32, qp=QP,
        depth_units=jnp.asarray(out["depth_units"].numpy()),
        trd_units=jnp.asarray(out["trd_units"].numpy()))
    got = p_torch.deblock_intra_device(
        *rec, qp=QP, depth_units=out["depth_units"],
        trd_units=out["trd_units"])
    without = p_torch.deblock_intra_device(
        *rec, qp=QP, depth_units=out["depth_units"])
    for a, b in zip(want, got):
        _eq(a, b)
    assert not torch.equal(got[0], without[0])
    assert not torch.equal(got[0], rec[0])
