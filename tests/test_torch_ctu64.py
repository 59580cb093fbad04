"""CTU 64 in the torch port against the JAX package, on the CPU (the port
runs its kernels' plain versions; the JAX window gather takes its non-TPU
branch, the JAX integer search its XLA sweep):

  p_torch._level_encode (S 64)    vs p_jax._level_encode: implicit split to
                                     four 32-TBs (chroma 16-TBs), with and
                                     without sign hiding, padded `vis`
  p_torch._me_hier (16, 32, 64)   vs p_jax._me_hier, search 64
  p_torch.p_frame_device (B 64)   vs p_jax.p_frame_device, dense (search 16)
                                     and hierarchical (search 64) front end,
                                     deblocking with the 32-TB cbf
  p_torch.p_frame_tree_device     vs p_jax.p_frame_tree_device at ctu 64,
                                     key by key, search 16 (dense sweep) and
                                     64
  ops.deblock.inter_bs_from_blocks (qcbf) and inter_bs_from_units
                                     (ctu_log2 6) vs the reference's (numpy)
  intra_torch.encode_frame_intra (B 64, FASTEST) vs the reference's
                                     encode_frame_intra_ctu64, 128x128
  p_torch.deblock_intra_device    vs p_jax.deblock_intra_device(B=64): the
                                     FASTEST grid and a split-RDO IDR's
                                     depth units, counted from 32-blocks
  native_backend.maps_from_intra_units(depth_offset=1) vs the reference's

and the sessions of the CTU-64 configurations (FAST, the JAX package's
default, with search 16; FASTER with search 16 and 64; FASTEST; FULL with
search 64 and 16) against the AU hashes that
tools/make_torch_fixtures.py writes from the JAX package, each stream
decoded in libde265 where it loads (one test per session encodes once and
checks both). The CTU-64 split-RDO IDR compiles for many minutes in the
JAX package, so it is held to the fixture only. At CTU 64, too, every
setting outside the ported slice raises NotImplementedError.
Inputs are made from a seed with numpy. Tolerance: exact equality.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu import tables as jtables
from homerhevc_tpu.api import HomerEncoder as JaxEncoder
from homerhevc_tpu.config import BitrateMode as JaxBitrate
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.config import PerformanceMode as JaxMode
from homerhevc_tpu.ops import deblock as jdbk
from homerhevc_tpu.pipeline import intra_jax, p_jax
from homerhevc_tpu.entropy import native_backend as jnative
from homerhevc_tpu_torch.api import HomerEncoder
from homerhevc_tpu_torch.config import BitrateMode, PerformanceMode, RDMode
from homerhevc_tpu_torch.entropy import native_backend as tnative
from homerhevc_tpu_torch.ops import deblock as tdbk
from homerhevc_tpu_torch.pipeline import intra_torch, p_torch
from homerhevc_tpu_torch.utils import fixtures as fx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")

H, W = 128, 192             # padded size; the visible picture is smaller
VIS = (120, 184)
PAD = p_torch.PAD
QP = 32


def _smooth(rng, h, w, amp=60.0, cell=8):
    """Low-pass noise: random values on a coarse grid, bilinearly
    interpolated, plus fine grain."""
    g = rng.uniform(-amp, amp, (h // cell + 2, w // cell + 2))
    ys, xs = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx_ = (ys - y0)[:, None], (xs - x0)[None, :]
    a = (g[y0][:, x0] * (1 - fy) * (1 - fx_)
         + g[y0][:, x0 + 1] * (1 - fy) * fx_
         + g[y0 + 1][:, x0] * fy * (1 - fx_) + g[y0 + 1][:, x0 + 1] * fy * fx_)
    return a + rng.normal(0, 2.0, (h, w))


def _u8(a):
    return np.clip(np.rint(a), 0, 255).astype(np.uint8)


def _shift(a, dy, dx):
    """a moved by (dy, dx) with edge replication."""
    h, w = a.shape
    ys = np.clip(np.arange(h) - dy, 0, h - 1)
    xs = np.clip(np.arange(w) - dx, 0, w - 1)
    return a[ys][:, xs]


@functools.lru_cache(maxsize=None)
def make_frames(h=H, w=W, n=3, seed=11):
    """[(y, u, v), ...] uint8 at (h, w), frame 0 the reference: a smooth
    picture under a small global motion (whole 64-CUs), a band moved far
    (found by the pyramid only), 16x16 and 8x8 patches with motions of
    their own, a CTU of new smooth content, fresh detail and noise."""
    rng = np.random.default_rng(seed)
    base = [128 + _smooth(rng, h, w), 128 + _smooth(rng, h // 2, w // 2, 25),
            128 + _smooth(rng, h // 2, w // 2, 25)]
    base[0][0:32, w - 64:w] = 128 + rng.normal(0, 60, (32, 64))
    frames = [tuple(_u8(p) for p in base)]
    for k in range(1, n):
        y, u, v = (_shift(p, k, -2 * k) if i == 0 else _shift(p, k // 2, -k)
                   for i, p in enumerate(base))
        y, u, v = y.copy(), u.copy(), v.copy()
        y[32:64, w - 64:w] = _shift(base[0], 0, -40 - k)[32:64, w - 64:w]
        u[16:32, w // 2 - 32:w // 2] = _shift(base[1], 0, -20)[
            16:32, w // 2 - 32:w // 2]
        y[16:32, 32:48] = _shift(base[0], -6, 7)[16:32, 32:48]
        for py, px, dy, dx in ((0, 64, 5, -3), (8, 72, -4, 6),
                               (72, 136, 3, 5), (80, 152, -5, -7)):
            y[py:py + 8, px:px + 8] = _shift(base[0], dy, dx)[py:py + 8,
                                                             px:px + 8]
        ramp = 40 + 2 * np.arange(64)[None, :] + np.arange(64)[:, None]
        y[64:128, 0:64] = ramp + 5 * k
        u[32:64, 0:32] = 90
        v[32:64, 0:32] = 170
        y[0:16, 96:112] = 128 + rng.normal(0, 50, (16, 16))
        y[96:128, 64:96] = y[96:128, 64:96] + rng.normal(0, 10, (32, 32))
        frames.append((_u8(y), _u8(u), _u8(v)))
    return frames


def pad_refs(ref, lib):
    pads = (PAD, PAD // 2, PAD // 2)
    if lib is jnp:
        return tuple(jnp.pad(jnp.asarray(p).astype(jnp.int16), pad,
                             mode="edge") for p, pad in zip(ref, pads))
    return tuple(torch.as_tensor(np.pad(p.astype(np.int16), pad, mode="edge"))
                 for p, pad in zip(ref, pads))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a module's tests, then as it was. The port's
    CPU runs are many small tensor ops: torch's intra-op threads mostly
    wait for each other, and on a CPU that other processes keep busy (the
    test workers) they make these tests many times slower (a 128x96 IBP
    session: 27 s with 8 threads beside two busy processes, 1.2 s with
    one). Every tests/test_torch_*.py module that runs the port imports
    this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eq(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.cpu().numpy(),
                                  err_msg=msg)


def i32(v):
    return torch.tensor(v, dtype=torch.int32)


def level_encode_both(S, search, sign_hiding, vis, ints, frames):
    """p_jax._level_encode and p_torch._level_encode on frames[1] against
    frames[0] at block size S from the port's integer MVs `ints`."""
    cur, ref = frames[1], frames[0]
    ivy, ivx, _ = ints[S]
    lam = int(jtables.LAMBDA_ME_FX_P[QP])
    qp_c = int(jtables.chroma_qp_from_luma(QP))
    fn = jax.jit(p_jax._level_encode,
                 static_argnames=("S", "search", "me_precision",
                                  "sign_hiding", "tr_split", "vis"))
    want = fn(jnp.asarray(cur[0]).astype(jnp.int32), jnp.asarray(cur[1]),
              jnp.asarray(cur[2]), *pad_refs(ref, jnp),
              jnp.asarray(ivy.numpy()), jnp.asarray(ivx.numpy()), S=S,
              qp=jnp.int32(QP), qp_c=jnp.int32(qp_c), lam=jnp.int32(lam),
              search=search, me_precision=2, sign_hiding=sign_hiding,
              tr_split=True, vis=vis)
    got = p_torch._level_encode(
        torch.as_tensor(cur[0]).to(torch.int32), torch.as_tensor(cur[1]),
        torch.as_tensor(cur[2]), *pad_refs(ref, torch), ivy, ivx, S=S,
        qp=i32(QP), qp_c=i32(qp_c), lam=i32(lam), search=search,
        me_precision=2, sign_hiding=sign_hiding, tr_split=True, vis=vis)
    # the port adds each block's refined MV before the merge decision
    assert set(got) == set(want) | {"amvp"}
    for k in want:
        eq(want[k], got[k], k)
    return got


@functools.lru_cache(maxsize=None)
def hier_ints(sizes, search=64):
    frames = make_frames()
    lam = i32(int(jtables.LAMBDA_ME_FX_P[QP]))
    return p_torch._me_hier(torch.as_tensor(frames[1][0]).to(torch.int32),
                            pad_refs(frames[0], torch)[0], sizes=sizes,
                            search=search, lam=lam)


def me_hier_both(sizes, search=64):
    frames = make_frames()
    cur, ref = frames[1][0], frames[0][0]
    lam = int(jtables.LAMBDA_ME_FX_P[QP])
    want = jax.jit(p_jax._me_hier, static_argnames=("sizes", "search"))(
        jnp.asarray(cur).astype(jnp.int32), pad_refs((ref,), jnp)[0],
        sizes=sizes, search=search, lam=jnp.int32(lam))
    got = hier_ints(sizes, search)
    assert sorted(got) == sorted(want) == sorted(sizes)
    for S in sizes:
        for name, a, b in zip(("ivy", "ivx", "icost"), want[S], got[S]):
            eq(a, b, f"S={S} {name}")
    return got


TREE_KEYS = ("depth_u", "mv_u", "cbf_u", "trd_u", "pred_intra_u", "qp_ctu",
             "qp16", "sad", "lev_y", "lev_u", "lev_v", "wire", "recon_y",
             "recon_u", "recon_v", "ref_y", "ref_u", "ref_v")


def tree_both(frames, **kw):
    """p_frame_tree_device of both packages on frames[1] against frames[0],
    compared key by key; returns the port's result."""
    cur, ref = frames[1], frames[0]
    want = p_jax.p_frame_tree_device(*map(jnp.asarray, cur + ref), **kw)
    got = p_torch.p_frame_tree_device(*map(torch.as_tensor, cur + ref), **kw)
    for k in TREE_KEYS:
        eq(want[k], got[k], k)
    return got


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sign_hiding", [True, False])
def test_level_encode_s64(sign_hiding):
    got = level_encode_both(64, 64, sign_hiding, VIS, hier_ints((16, 32, 64)),
                            make_frames())
    lev = got["lev_y"]                                    # (2, 3, 64, 64)
    # the four 32-TBs of a CU are coded (and zeroed) on their own
    q = (lev.reshape(2, 3, 2, 32, 2, 32) != 0).any(5).any(3)
    assert q.any() and not q.all(1).all(1).all()
    assert not got["trd"].any()                           # TU split: S 32 only


def test_me_hier_sizes_16_32_64():
    got = me_hier_both((16, 32, 64))
    ivy, ivx, _ = got[64]
    assert ivy.shape == (H // 64, W // 64)
    assert (got[16][1].abs() > 24).any(), "no wide motion found"


@pytest.mark.parametrize("search", [16, 64])
def test_p_frame_device_b64(search):
    frames = make_frames()
    cur, ref = frames[1], frames[0]
    kw = dict(B=64, qp=QP, search=search, me_precision=2, deblock=True,
              sign_hiding=True)
    want = p_jax.p_frame_device(*map(jnp.asarray, cur + ref), **kw)
    got = p_torch.p_frame_device(*map(torch.as_tensor, cur + ref), **kw)
    for k in ("mvs", "sad", "lev_y", "lev_u", "lev_v", "wire", "recon_y",
              "recon_u", "recon_v", "ref_y", "ref_u", "ref_v"):
        eq(want[k], got[k], k)
    assert not torch.equal(got["ref_y"], got["recon_y"]), "nothing filtered"


@pytest.mark.parametrize("search,tr_split", [(16, True), (64, False)])
def test_p_frame_tree_device_ctu64(search, tr_split):
    got = tree_both(make_frames(), ctu=64, qp=QP, search=search,
                    me_precision=2, deblock=True, sign_hiding=True,
                    tr_split=tr_split, vis=VIS)
    d = got["depth_u"]
    assert (d == 0).any() and (d == 1).any() and (d == 2).any(), \
        "not every CU size of the tree chosen"
    assert not got["pred_intra_u"].any()              # intra-in-P: CTU 32
    assert bool(got["trd_u"].any()) == tr_split
    if tr_split:
        assert not got["trd_u"][d != 1].any(), "TU split outside a 32-CU"


def test_inter_bs_from_blocks_qcbf():
    rng = np.random.default_rng(7)
    nby, nbx = 3, 4
    mvs = rng.integers(-6, 7, (nby, nbx, 2)).astype(np.int32)
    mvs[1, 1] = mvs[1, 2]                     # equal MVs across an edge
    qcbf = rng.integers(0, 2, (nby, nbx, 2, 2)).astype(bool)
    qcbf[0, 0] = False
    cbf = qcbf.any(axis=(2, 3))
    want = jdbk.inter_bs_from_blocks(mvs, cbf, 64, qcbf=qcbf)
    got = tdbk.inter_bs_from_blocks(torch.as_tensor(mvs), torch.as_tensor(cbf),
                                    64, qcbf=torch.as_tensor(qcbf))
    for a, b in zip(want, got):
        assert b.shape == a.shape
        eq(a, b)
    assert (got[0][:, 4::8] == 1).any(), "no inner TU edge"
    with pytest.raises(ValueError):
        tdbk.inter_bs_from_blocks(torch.as_tensor(mvs), torch.as_tensor(cbf),
                                  64)


@pytest.mark.parametrize("with_trd,with_intra", [(False, False),
                                                 (True, True)])
def test_inter_bs_from_units_ctu64(with_trd, with_intra):
    rng = np.random.default_rng(9)
    uh, uw = H // 4, W // 4

    def up(a, k):
        return np.repeat(np.repeat(a, k, 0), k, 1)

    # depths 0..3 (64, 32, 16, 8) nested as a quadtree
    d64 = rng.integers(0, 2, (uh // 16, uw // 16))
    d32 = up(d64, 2) * rng.integers(0, 2, (uh // 8, uw // 8))
    d16 = up(d32, 2) * rng.integers(0, 2, (uh // 4, uw // 4))
    depth_u = (up(d64, 16) + up(d32, 8) + up(d16, 4)).astype(np.int32)
    assert set(np.unique(depth_u)) == {0, 1, 2, 3}
    mv8 = rng.integers(-9, 10, (uh // 2, uw // 2, 2)).astype(np.int32)
    mv_u = up(mv8, 2)
    cbf_u = up(rng.integers(0, 2, (uh // 2, uw // 2)), 2).astype(bool)
    trd_u = ((up(rng.integers(0, 2, (uh // 8, uw // 8)), 8) * (depth_u == 1))
             .astype(np.int32) if with_trd else None)
    intra_u = None
    if with_intra:                                    # one CTU, unsplit
        intra_u = np.zeros((uh, uw), np.int32)
        intra_u[:16, 16:32] = 1
        depth_u[:16, 16:32] = 0
    want = jdbk.inter_bs_from_units(depth_u, mv_u, cbf_u, 6, trd_u=trd_u,
                                    intra_u=intra_u)

    def t(a):
        return None if a is None else torch.as_tensor(a)

    got = tdbk.inter_bs_from_units(t(depth_u), t(mv_u), t(cbf_u), 6,
                                   trd_u=t(trd_u), intra_u=t(intra_u))
    for a, b in zip(want, got):
        eq(a, b)
    assert (got[0] == 1).any() and (got[1] == 1).any()
    assert bool((got[0] == 2).any()) == with_intra


INTRA64_KEYS = ("wire", "mode_units", "depth_units", "part_units",
                "trd_units", "lev_y", "lev_u", "lev_v", "recon_y", "recon_u",
                "recon_v")


def test_encode_frame_intra_ctu64_fastest():
    y, u, v = fx.intra_frame(128, 128, seed=5)
    want = intra_jax.encode_frame_intra_ctu64(
        *map(jnp.asarray, (y, u, v)), qp=QP, sign_hiding=True,
        split_rdo=False, rd_mode=1, tu_depth=0)
    got = intra_torch.encode_frame_intra(
        *map(torch.as_tensor, (y, u, v)), B=64, qp=QP, sign_hiding=True,
        split_rdo=False, tu_depth=0)
    for k in INTRA64_KEYS:
        eq(want[k], got[k], k)
    # the four 32-blocks of a CTU pick their own modes
    m = got["mode_units"][::8, ::8]
    assert len(torch.unique(m)) > 2


def _random_depth_units(rng, uh, uw):
    """Unit depths of a split-RDO IDR at CTU 64, counted from the 32-blocks
    (0: CU 32, 1: 16, 2: 8), nested as a quadtree, and TU-split flags."""
    def up(a, k):
        return np.repeat(np.repeat(a, k, 0), k, 1)

    d16 = rng.integers(0, 2, (uh // 8, uw // 8))
    d8 = up(d16, 2) * rng.integers(0, 2, (uh // 4, uw // 4))
    depth = (up(d16, 8) + up(d8, 4)).astype(np.int32)
    trd = (rng.integers(0, 2, (uh // 2, uw // 2)).repeat(2, 0).repeat(2, 1)
           * (depth < 2)).astype(np.int32)
    return depth, trd


@pytest.mark.parametrize("split", [False, True])
def test_deblock_intra_ctu64(split):
    # FASTEST codes CU = TU = 32 inside each 64-CTU: the reference takes the
    # uniform grid (depth_units None), the port all-zero depth units
    rng = np.random.default_rng(21)
    h, w = H, W
    # smooth planes with a step of a few levels at every 8-pel edge: the
    # blocking a coarse quantiser leaves, which the filter smooths where
    # the map puts an edge
    rec = tuple(
        _u8(p.astype(np.int32) + np.repeat(np.repeat(
            rng.integers(-4, 5, (p.shape[0] // 8, p.shape[1] // 8)), 8, 0),
            8, 1)) for p in make_frames()[0])
    if split:
        depth, trd = _random_depth_units(rng, h // 4, w // 4)
        kw_j = dict(depth_units=jnp.asarray(depth), trd_units=jnp.asarray(trd))
        kw_t = dict(depth_units=torch.as_tensor(depth),
                    trd_units=torch.as_tensor(trd))
    else:
        kw_j = {}
        kw_t = dict(depth_units=torch.zeros((h // 4, w // 4),
                                            dtype=torch.int32))
    want = p_jax.deblock_intra_device(*map(jnp.asarray, rec), B=64, qp=QP,
                                      **kw_j)
    got = p_torch.deblock_intra_device(*map(torch.as_tensor, rec), qp=QP,
                                       **kw_t)
    for a, b in zip(want, got):
        eq(a, b)
    assert not torch.equal(got[0], torch.as_tensor(rec[0]))
    if split:                      # the 16- and 8-CU edges were filtered
        grid = p_torch.deblock_intra_device(
            *map(torch.as_tensor, rec), qp=QP,
            depth_units=torch.zeros((h // 4, w // 4), dtype=torch.int32))
        assert not torch.equal(got[0], grid[0])


@pytest.mark.parametrize("nxn", [False, True])
def test_maps_from_intra_units_ctu64(nxn):
    # the session passes depth_offset=1: a 64-CTU's unit depths count from
    # its 32-blocks
    rng = np.random.default_rng(23)
    h, w = 128, 192
    depth, trd = _random_depth_units(rng, h // 4, w // 4)
    modes = rng.integers(0, 35, (h // 4, w // 4)).astype(np.int32)
    part = ((depth == 2) & (rng.random((h // 4, w // 4)) < 0.5)
            if nxn else None)
    lev = (rng.integers(-3, 4, (h, w)) * (rng.random((h, w)) < 0.05),
           rng.integers(-3, 4, (h // 2, w // 2))
           * (rng.random((h // 2, w // 2)) < 0.05),
           rng.integers(-3, 4, (h // 2, w // 2))
           * (rng.random((h // 2, w // 2)) < 0.05))
    lev = tuple(p.astype(np.int32) for p in lev)
    kw = dict(depth_offset=1, part_units=part, tr_depth_units=trd)
    want = jnative.maps_from_intra_units(modes, depth, *lev, **kw)
    got = tnative.maps_from_intra_units(modes, depth, *lev, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# sessions: held to the JAX package's AU hashes
SESSIONS = ("default_small", "faster64_small",
            "faster64_s64_small", "fastest64_small", "full64_small",
            "full64_s16_small")


@functools.lru_cache(maxsize=None)
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def port_run(name: str):
    """(AUs, final reference planes, StreamParams) of the port for one of
    the fixture's runs."""
    enc = HomerEncoder(fx.run_config(name), device="cpu", fetch_recon=False)
    aus = enc.encode_frames(fx.clip(name), chunk=fx.RUNS[name]["chunk"])
    ref = tuple(p.numpy() for p in enc._ref)
    enc.close()
    return aus, ref, enc.params


def check_decodes(name: str, aus, ref) -> None:
    """libde265 decodes the AUs to the port's last reference planes, where
    the library loads."""
    from homerhevc_tpu_torch.validate import de265
    if not de265.available():
        return
    r = fx.run_spec(name)
    dec = de265.decode_annexb(b"".join(aus))
    assert len(dec) == len(aus)
    h, w = r["height"], r["width"]
    for p, q, (ph, pw) in zip(dec[-1], ref, ((h, w), (h // 2, w // 2),
                                             (h // 2, w // 2))):
        np.testing.assert_array_equal(p, q[:ph, :pw])


def check_session(name: str):
    """The port's run of a fixture entry: its AU hashes equal the JAX
    package's and the stream decodes to the port's recon. Returns the
    session's StreamParams."""
    entry = fixture()[name]
    assert {k: entry[k] for k in fx.RUNS[name]} == fx.RUNS[name]
    aus, ref, params = port_run(name)
    assert fx.au_digest(aus) == entry["aus"]
    check_decodes(name, aus, ref)
    return params


@pytest.mark.parametrize("name", SESSIONS)
def test_session_matches_fixture(name):
    assert check_session(name).ctu_log2 == 6


def test_default_config_is_ctu64_fast():
    # the JAX package's defaults, which the port's EncoderConfig copies:
    # what `HomerEncoder(EncoderConfig(...))` runs with no other setting
    kw = fx.ctu64_kwargs(1280, 720)
    cfg = fx.config_from(kw)
    assert (cfg.cu_size, cfg.performance_mode, cfg.me_search_range) == (
        64, PerformanceMode.FAST_COMPUTATION, 16)
    base = dataclasses.asdict(fx.config_from(dict(width=1280, height=720,
                                                  performance_mode=(
                                                      "FAST_COMPUTATION"))))
    diff = {k for k, v in dataclasses.asdict(cfg).items() if base[k] != v}
    assert diff == {"frame_pipeline_depth"}      # 2: pipelining, same bytes
    enc = HomerEncoder(fx.config_from(dict(
        width=1280, height=720, performance_mode="FAST_COMPUTATION")),
        device="cpu")
    assert (enc.ctu64, enc.intra_b, enc.inter_split, enc.inter_cu8) == (
        True, 32, True, False)


def test_per_frame_path_matches_chunked_ctu64():
    # the chunked run's AUs are the fixture's (test_session_matches_fixture)
    name = "faster64_small"
    cfg = fx.run_config(name)
    enc = HomerEncoder(cfg, device="cpu")
    got = [enc.encode_frame(*f) for f in fx.clip(name)]
    assert fx.au_digest(got) == fixture()[name]["aus"]
    np.testing.assert_array_equal(
        enc.last_recon[0], enc._ref[0].numpy()[:cfg.height, :cfg.width])
    check_decodes(name, got, tuple(p.numpy() for p in enc._ref))


# ---------------------------------------------------------------------------
# session setup: what the port's HomerEncoder derives from a configuration
# equals the JAX session's
SETUP_CASES = {
    "fastest_ctu64": dict(cu_size=64,
                          performance_mode="FASTEST_COMPUTATION"),
    "faster_ctu64": dict(cu_size=64, performance_mode="FASTER_COMPUTATION"),
    "fast_ctu64": dict(cu_size=64, performance_mode="FAST_COMPUTATION"),
    "full_ctu64": dict(cu_size=64, performance_mode="FULL_COMPUTATION"),
    "full_ctu32": dict(cu_size=32, performance_mode="FULL_COMPUTATION"),
    "fastest_ctu64_tr0": dict(cu_size=64, max_intra_tr_depth=0,
                              max_inter_tr_depth=0,
                              performance_mode="FASTEST_COMPUTATION"),
    # rate control and WPP: cu_qp_delta on the quadtree path only
    "cbr_fast_ctu32": dict(cu_size=32, bitrate_mode="CBR",
                           performance_mode="FAST_COMPUTATION"),
    "vbr_full_ctu64": dict(cu_size=64, bitrate_mode="VBR",
                           performance_mode="FULL_COMPUTATION"),
    "cbr_fastest_ctu64": dict(cu_size=64, bitrate_mode="CBR",
                              performance_mode="FASTEST_COMPUTATION"),
    "wpp_fast_ctu64": dict(cu_size=64, wpp=True,
                           performance_mode="FAST_COMPUTATION"),
    "cbr_wpp_fast_ctu32": dict(cu_size=32, bitrate_mode="CBR", wpp=True,
                               performance_mode="FAST_COMPUTATION"),
}


@pytest.mark.parametrize("case", list(SETUP_CASES))
def test_session_setup_matches_jax(case):
    kw = fx.slice_kwargs(120, 88)
    kw.update(SETUP_CASES[case])
    port = HomerEncoder(fx.config_from(kw), device="cpu")
    ref = JaxEncoder(JaxConfig(**dict(
        kw, performance_mode=JaxMode[kw["performance_mode"]],
        **({"bitrate_mode": JaxBitrate[kw["bitrate_mode"]]}
           if "bitrate_mode" in kw else {}))), backend="jax")
    try:
        for attr in ("intra_b", "ctu64", "inter_cu8", "intra_split",
                     "inter_split", "pw", "ph", "_row_qp_on"):
            assert getattr(port, attr) == getattr(ref, attr), attr
        assert (port._rc is None) == (ref._rc is None)
        assert dataclasses.asdict(port.params) == dataclasses.asdict(
            ref.params)
    finally:
        ref.close()


@pytest.mark.parametrize("field,value", [
    ("gop_size", 2),
    ("wpp_shards", 2),
    ("rd_mode", RDMode.FAST),
    ("rd_mode", RDMode.DIST_ONLY),
    ("bit_depth", 10),
])
def test_out_of_slice_settings_raise_ctu64(field, value):
    # CTU 64 (here in FULL, the widest cell) admits nothing that CTU 32
    # refuses, and refuses B frames (the reference's B stage asks for a
    # 64-point DCT there); every rd_mode is ported at both sizes, and
    # wpp_shards (a CPU session builds no mesh: it has no CUDA devices)
    cfg = dataclasses.replace(fx.config_from(fx.ctu64_kwargs(
        192, 128, performance_mode="FULL_COMPUTATION")), **{field: value})
    if field in ("rd_mode", "wpp_shards"):
        enc = HomerEncoder(cfg, device="cpu")
        assert enc._mesh is None
        enc.close()
        return
    with pytest.raises(NotImplementedError, match=field):
        HomerEncoder(cfg, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("bitrate_mode", BitrateMode.CBR),
    ("bitrate_mode", BitrateMode.VBR),
    ("wpp", True),
])
def test_rate_control_and_wpp_admitted_ctu64(field, value):
    # CTU 64 admits what CTU 32 admits: rate control with per-CTU-row QPs
    # on the quadtree path (tests/test_torch_rc.py holds its streams), WPP
    cfg = dataclasses.replace(fx.config_from(fx.ctu64_kwargs(
        192, 128, performance_mode="FULL_COMPUTATION")), **{field: value})
    enc = HomerEncoder(cfg, device="cpu")
    rc = cfg.bitrate_mode != BitrateMode.FIXED_QP
    assert enc.params.wpp_enabled == cfg.wpp
    assert enc.params.cu_qp_delta_enabled == rc == enc._row_qp_on
