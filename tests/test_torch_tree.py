"""The inter CU quadtree P stage of the torch port against the JAX package,
array for array, on the CPU (the port runs its kernels' plain versions; the
JAX window gather takes its non-TPU branch):

  ops.blocksum.block_sum        vs ops.blocksum.block_sum
  ops.me.sad_grids (S 16)       vs p_jax._sad_grids
  p_torch._me_hier              vs p_jax._me_hier, search 64 and 32
  p_torch._level_encode         vs p_jax._level_encode, S 16 and 32, TU split
                                   on and off, padded visible size
  p_torch.p_frame_tree_device   vs p_jax.p_frame_tree_device, key by key, with
                                   the hierarchical (search 64) and the dense
                                   (search 16) front end, intra-in-P on
  ops.deblock.inter_bs_from_units vs the reference's (numpy)
  p_chunk.p_chunk_device(tree)  vs the reference's, wire word for word, K=3
  p_torch.worst_n               vs jax.lax.top_k on tied costs

Inputs are made from a seed with numpy: a smooth textured reference; the
current frame is the reference moved by a small global motion, with a
region of per-sample noise that moves along, a band moved far (beyond the
dense-search range), a 16x16 patch moved on its own, a CTU of new smooth
content, a CTU corner of fresh detail, and noise. Each test asserts that its
input drives the branch it names. Tolerance: exact equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu import tables as jtables
from homerhevc_tpu.ops import blocksum as jblocksum
from homerhevc_tpu.ops import deblock as jdbk
from homerhevc_tpu.pipeline import p_chunk as jchunk
from homerhevc_tpu.pipeline import p_jax
from homerhevc_tpu_torch.ops import blocksum as tblocksum
from homerhevc_tpu_torch.ops import deblock as tdbk
from homerhevc_tpu_torch.ops import me as tme
from homerhevc_tpu_torch.pipeline import p_chunk as tchunk
from homerhevc_tpu_torch.pipeline import p_torch
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

H, W = 96, 160              # padded size; the visible picture is smaller
VIS = (88, 152)
PAD = p_torch.PAD
QP = 32


def _smooth(rng, h, w, amp=60.0, cell=8):
    """Low-pass noise: random values on a coarse grid, bilinearly
    interpolated, plus fine grain."""
    gh, gw = h // cell + 2, w // cell + 2
    g = rng.uniform(-amp, amp, (gh, gw))
    ys = np.arange(h) / cell
    xs = np.arange(w) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    a = (g[y0][:, x0] * (1 - fy) * (1 - fx) + g[y0][:, x0 + 1] * (1 - fy) * fx
         + g[y0 + 1][:, x0] * fy * (1 - fx) + g[y0 + 1][:, x0 + 1] * fy * fx)
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
def make_frames(n=4, seed=11):
    """[(y, u, v), ...] uint8 at (H, W): frame 0 is the reference."""
    rng = np.random.default_rng(seed)
    base = [128 + _smooth(rng, H, W), 128 + _smooth(rng, H // 2, W // 2, 25),
            128 + _smooth(rng, H // 2, W // 2, 25)]
    # per-sample noise that moves with the picture: the 4:1 pooled planes
    # of the coarse search average it away, the zero anchor finds it
    base[0][0:32, 96:160] = 128 + rng.normal(0, 60, (32, 64))
    frames = [tuple(_u8(p) for p in base)]
    for k in range(1, n):
        y, u, v = (_shift(p, k, -2 * k) if i == 0 else _shift(p, k // 2, -k)
                   for i, p in enumerate(base))
        y, u, v = y.copy(), u.copy(), v.copy()
        # a band moved far: beyond the dense range, found by the pyramid
        y[32:64, 96:160] = _shift(base[0], 0, -40 - k)[32:64, 96:160]
        u[16:32, 48:80] = _shift(base[1], 0, -20)[16:32, 48:80]
        v[16:32, 48:80] = _shift(base[2], 0, -20)[16:32, 48:80]
        # a 16x16 patch with a motion of its own inside a CTU
        y[16:32, 32:48] = _shift(base[0], -6, 7)[16:32, 32:48]
        # a CTU of new smooth content (nothing like it in the reference)
        ramp = 40 + 3 * np.arange(32)[None, :] + 2 * np.arange(32)[:, None]
        y[64:96, 32:64] = ramp + 5 * k
        u[32:48, 16:32] = 90
        v[32:48, 16:32] = 170
        # fresh detail in one corner of a CTU, and noise in another CTU
        y[0:16, 64:80] = 128 + rng.normal(0, 50, (16, 16))
        y[32:64, 0:32] = y[32:64, 0:32] + rng.normal(0, 10, (32, 32))
        frames.append((_u8(y), _u8(u), _u8(v)))
    return frames


def _pad_refs(ref, lib):
    if lib is jnp:
        return tuple(jnp.pad(jnp.asarray(p).astype(jnp.int16), pad,
                             mode="edge")
                     for p, pad in zip(ref, (PAD, PAD // 2, PAD // 2)))
    return tuple(torch.as_tensor(np.pad(p.astype(np.int16), pad,
                                        mode="edge"))
                 for p, pad in zip(ref, (PAD, PAD // 2, PAD // 2)))


def _eq(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.cpu().numpy(),
                                  err_msg=msg)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("by,bx,lead", [(4, 4, ()), (16, 16, (3,)),
                                        (2, 2, (5,)), (32, 32, ())])
def test_block_sum(by, bx, lead):
    rng = np.random.default_rng(by)
    x = rng.integers(0, 256, lead + (64, 96)).astype(np.int32)
    want = jblocksum.block_sum(x, by, bx)
    got = tblocksum.block_sum(torch.as_tensor(x), by, bx)
    assert got.dtype == torch.int32
    _eq(want, got)


@pytest.mark.parametrize("search", [3, 8])
def test_sad_grids_s16(search):
    cur, ref = make_frames()[1][0], make_frames()[0][0]
    ry = _pad_refs((ref,), jnp)[0]
    want = jax.jit(p_jax._sad_grids, static_argnames=("S", "search"))(
        jnp.asarray(cur).astype(jnp.int16), ry, S=16, search=search)
    got = tme.sad_grids(torch.as_tensor(cur),
                        _pad_refs((ref,), torch)[0], S=16, search=search,
                        pad=PAD)
    assert got.shape == ((2 * search + 1) ** 2, H // 16, W // 16)
    _eq(want, got)


@pytest.mark.parametrize("search", [64, 32])
def test_me_hier(search):
    cur, ref = make_frames()[1][0], make_frames()[0][0]
    lam = int(jtables.LAMBDA_ME_FX_P[QP])
    want = jax.jit(p_jax._me_hier, static_argnames=("sizes", "search"))(
        jnp.asarray(cur).astype(jnp.int32), _pad_refs((ref,), jnp)[0],
        sizes=(16, 32), search=search, lam=jnp.int32(lam))
    tcur = torch.as_tensor(cur).to(torch.int32)
    try_ = _pad_refs((ref,), torch)[0]
    tlam = torch.tensor(lam, dtype=torch.int32)
    got = p_torch._me_hier(tcur, try_, sizes=(16, 32), search=search,
                           lam=tlam)
    coarse = p_torch._me_hier_coarse(tcur, try_, sizes=(16, 32),
                                     search=search, lam=tlam)
    zero_picks = 0
    for S in (16, 32):
        for name, a, b in zip(("ivy", "ivx", "icost"), want[S], got[S]):
            _eq(a, b, f"S={S} {name}")
        ivy, ivx = (t.reshape(-1) for t in got[S][:2])
        cy, cx, _ = coarse[S]
        # beyond +-3 only the pyramid seed reaches (candidate j >= 49); a
        # pick more than 3 from the seed can only be the zero anchor's
        assert ((ivy.abs() > 3) | (ivx.abs() > 3)).any(), S
        zero_picks += int((((ivy - cy).abs() > 3)
                           | ((ivx - cx).abs() > 3)).sum())
        if search == 64:
            assert (ivx.abs() > 24).any(), "no wide motion found"
    assert zero_picks, "no pick came from the zero anchor"


@functools.lru_cache(maxsize=None)
def _level_inputs():
    frames = make_frames()
    cur, ref = frames[1], frames[0]
    lam = int(jtables.LAMBDA_ME_FX_P[QP])
    tcur = torch.as_tensor(cur[0]).to(torch.int32)
    tref = _pad_refs(ref, torch)
    ints = p_torch._me_hier(tcur, tref[0], sizes=(16, 32), search=64,
                            lam=torch.tensor(lam, dtype=torch.int32))
    return cur, ref, lam, tcur, tref, ints


@pytest.mark.parametrize("S,tr_split", [(16, False), (32, False), (32, True)])
def test_level_encode(S, tr_split):
    cur, ref, lam, tcur, tref, ints = _level_inputs()
    ivy, ivx, _ = ints[S]
    qp_c = int(jtables.chroma_qp_from_luma(QP))
    fn = jax.jit(p_jax._level_encode,
                 static_argnames=("S", "search", "me_precision",
                                  "sign_hiding", "tr_split", "vis"))
    want = fn(jnp.asarray(cur[0]).astype(jnp.int32), jnp.asarray(cur[1]),
              jnp.asarray(cur[2]), *_pad_refs(ref, jnp),
              jnp.asarray(ivy.numpy()), jnp.asarray(ivx.numpy()), S=S,
              qp=jnp.int32(QP), qp_c=jnp.int32(qp_c), lam=jnp.int32(lam),
              search=64, me_precision=2, sign_hiding=True, tr_split=tr_split,
              vis=VIS)
    got = p_torch._level_encode(
        tcur, torch.as_tensor(cur[1]), torch.as_tensor(cur[2]), *tref, ivy,
        ivx, S=S, qp=torch.tensor(QP, dtype=torch.int32),
        qp_c=torch.tensor(qp_c, dtype=torch.int32),
        lam=torch.tensor(lam, dtype=torch.int32), search=64, me_precision=2,
        sign_hiding=True, tr_split=tr_split, vis=VIS)
    # the port adds each block's refined MV before the merge decision
    assert set(got) == set(want) | {"amvp"}
    for k in want:
        _eq(want[k], got[k], k)
    # the padding carries no residual
    assert not got["lev_y"].permute(0, 2, 1, 3).reshape(H, W)[VIS[0]:].any()
    assert got["lev_y"].any()
    if tr_split:
        assert got["trd"].any(), "no CU chose the TU split"
    else:
        assert not got["trd"].any()


TREE_KEYS = ("depth_u", "mv_u", "cbf_u", "trd_u", "pred_intra_u", "qp_ctu",
             "qp16", "sad", "lev_y", "lev_u", "lev_v", "wire", "recon_y",
             "recon_u", "recon_v", "ref_y", "ref_u", "ref_v")


@pytest.mark.parametrize("search,tr_split", [(64, True), (16, False)])
def test_p_frame_tree_device(search, tr_split):
    frames = make_frames()
    cur, ref = frames[1], frames[0]
    kw = dict(ctu=32, qp=QP, search=search, me_precision=2, deblock=True,
              sign_hiding=True, tr_split=tr_split, intra_in_p=True, vis=VIS)
    want = p_jax.p_frame_tree_device(*map(jnp.asarray, cur + ref), **kw)
    got = p_torch.p_frame_tree_device(*map(torch.as_tensor, cur + ref), **kw)
    for k in TREE_KEYS:
        _eq(want[k], got[k], k)
    assert (got["depth_u"] == 1).any(), "no CU split"
    assert (got["depth_u"] == 0).any()
    assert got["pred_intra_u"].any(), "no intra CU accepted"
    assert bool(got["trd_u"].any()) == tr_split
    assert got["cbf_u"].any()


@pytest.mark.parametrize("with_trd,with_intra", [(False, False), (True, False),
                                                 (True, True)])
def test_inter_bs_from_units(with_trd, with_intra):
    rng = np.random.default_rng(5)
    uh, uw = H // 4, W // 4

    def up(a, k):
        return np.repeat(np.repeat(a, k, 0), k, 1)

    depth_u = up(rng.integers(0, 2, (uh // 8, uw // 8)), 8).astype(np.int32)
    mv16 = rng.integers(-9, 10, (uh // 4, uw // 4, 2)).astype(np.int32)
    mv_u = np.where(depth_u[..., None] == 0, up(mv16[::2, ::2], 8),
                    up(mv16, 4))
    cbf_u = up(rng.integers(0, 2, (uh // 4, uw // 4)), 4).astype(bool)
    trd_u = (up(rng.integers(0, 2, (uh // 8, uw // 8)), 8)
             * (depth_u == 0)).astype(np.int32) if with_trd else None
    intra_u = (up(rng.integers(0, 4, (uh // 8, uw // 8)) == 0, 8)
               .astype(np.int32)) if with_intra else None
    want = jdbk.inter_bs_from_units(depth_u, mv_u, cbf_u, 5, trd_u=trd_u,
                                    intra_u=intra_u)

    def t(a):
        return None if a is None else torch.as_tensor(a)

    got = tdbk.inter_bs_from_units(t(depth_u), t(mv_u), t(cbf_u), 5,
                                   trd_u=t(trd_u), intra_u=t(intra_u))
    for a, b in zip(want, got):
        _eq(a, b)
    assert (got[0] == 1).any() and (got[1] == 1).any()
    assert bool((got[0] == 2).any()) == with_intra


def test_tree_chunk_wire_k3():
    frames = make_frames()
    ys, us, vs = (np.stack([f[k] for f in frames[1:4]]) for k in range(3))
    qps = np.array([32, 30, 34], np.int32)
    cap = 1024
    kw = dict(ctu=32, search=64, me_precision=2, sign_hiding=True,
              deblock=True, sao=True, cap=cap, tree=True, tr_split=True,
              intra_in_p=True, vis=VIS)
    want = jchunk.p_chunk_device(
        *map(jnp.asarray, (ys, us, vs) + frames[0]), jnp.asarray(qps), **kw)
    got = tchunk.p_chunk_device(
        *map(torch.as_tensor, (ys, us, vs) + frames[0]),
        torch.as_tensor(qps), **kw)
    for name, a, b in zip(("wires", "denses", "ref_y", "ref_u", "ref_v"),
                          want, got):
        _eq(a, b, name)
    # the copied host unpack reads the port's wire, and every frame of the
    # chunk drives all three branches
    for k in range(3):
        w = tchunk.unpack_wire(got[0][k].numpy(), H, W, 32, cap)
        assert 0 < int(w["cnt"][0]) <= cap
        assert (w["depth16"] == 1).any(), f"frame {k}: no CU split"
        assert w["trd16"].any(), f"frame {k}: no TU split"
        assert w["intra16"].any(), f"frame {k}: no intra CU"


@pytest.mark.parametrize("kind", ["tied", "all_tie", "random"])
def test_worst_n_is_stable_top_k(kind):
    rng = np.random.default_rng(3)
    n = 920                                   # CTUs of a 720p frame
    cost = {"tied": rng.integers(0, 12, n) * 1000,
            "all_tie": np.full(n, 7),
            "random": rng.integers(0, 1 << 20, n)}[kind].astype(np.int32)
    n_sel = min(n, max(128, n // 8))
    assert n_sel < n
    _, want = jax.lax.top_k(jnp.asarray(cost), n_sel)
    got = p_torch.worst_n(torch.as_tensor(cost), n_sel)
    _eq(want, got)
    if kind != "random":
        # the boundary falls inside a run of equal costs
        assert cost[int(got[-1])] == np.sort(cost)[::-1][n_sel]
