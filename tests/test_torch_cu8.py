"""8x8 inter CUs (FULL_COMPUTATION) in the torch port against the JAX
package, on the CPU (plain kernel versions on the port's side):

  p_torch._level_encode (S 8)     vs p_jax._level_encode: 4x4 chroma TBs and
                                     the 7x7 chroma window, padded `vis`
  p_torch._me_hier (8, 16, 32)    vs p_jax._me_hier, search 64: each 8-block
                                     seeded from its parent 16's MV
  p_torch.p_frame_tree_device     vs p_jax.p_frame_tree_device with cu8, key
                                     by key: CTU 32 with the hierarchical and
                                     the dense front end, CTU 64
  the fine chunk wire             the port's 8-granular decision grid, read
                                     back by the port's and the JAX package's
                                     unpack_wire

and the FULL sessions at CTU 32 (search 64 and 16) against the AU hashes
tools/make_torch_fixtures.py writes from the JAX package, decoded in
libde265 where it loads, in one test per session (FULL at CTU 64 is in
tests/test_torch_ctu64.py).
Inputs are made from a seed with numpy (the frames of
tests/test_torch_ctu64.py). Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from homerhevc_tpu.pipeline import p_chunk as jchunk
from homerhevc_tpu_torch.pipeline import p_chunk as tchunk
from homerhevc_tpu_torch.pipeline import p_torch
from test_torch_ctu64 import (QP, VIS, check_session, fixture, hier_ints,
                              level_encode_both, make_frames, me_hier_both,
                              tree_both)
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)


def test_level_encode_s8():
    got = level_encode_both(8, 64, True, VIS, hier_ints((8, 16, 32)),
                            make_frames())
    assert got["lev_u"].shape[-2:] == (4, 4)
    assert got["lev_u"].any() and got["lev_y"].any()


def test_me_hier_sizes_8_16_32():
    got = me_hier_both((8, 16, 32))
    ivy8, ivx8, _ = got[8]
    ivy16, ivx16, _ = got[16]
    # the 8x8 patches with motions of their own leave their parent's MV
    up = ivx16.repeat_interleave(2, 0).repeat_interleave(2, 1)
    assert (ivx8 != up).any()
    assert (ivx8.abs() > 24).any(), "no wide motion reached the 8-level"


@pytest.mark.parametrize("ctu,search", [(32, 64), (32, 16), (64, 64)])
def test_p_frame_tree_device_cu8(ctu, search):
    got = tree_both(make_frames(), ctu=ctu, qp=QP, search=search,
                    me_precision=2, deblock=True, sign_hiding=True,
                    tr_split=True, intra_in_p=ctu == 32, cu8=True, vis=VIS)
    d8 = 2 if ctu == 32 else 3
    assert (got["depth_u"] == d8).any(), "no 8x8 CU chosen"
    assert (got["depth_u"] < d8).any()


def test_fine_wire_round_trip():
    frames = make_frames()
    ys, us, vs = (np.stack([f[k] for f in frames[1:3]]) for k in range(3))
    H, W = ys.shape[1:]
    cap = 1024
    wires, _, *_ = tchunk.p_chunk_device(
        *map(torch.as_tensor, (ys, us, vs) + frames[0]),
        torch.as_tensor(np.array([32, 30], np.int32)), ctu=32, search=64,
        me_precision=2, sign_hiding=True, deblock=True, sao=True, cap=cap,
        tree=True, tr_split=True, intra_in_p=True, cu8=True, vis=VIS)
    n_words = sum(int(np.prod(s)) for _, s in tchunk.wire_layout(
        H, W, 32, cap, fine=True))
    assert wires.shape == (2, n_words)
    # frame 1 alone, through the per-frame path: its maps at 8x8 blocks
    res = p_torch.p_frame_tree_device(
        *map(torch.as_tensor, frames[1] + frames[0]), ctu=32, qp=32,
        search=64, me_precision=2, deblock=True, sign_hiding=True,
        tr_split=True, intra_in_p=True, cu8=True, vis=VIS)
    for unpack in (tchunk.unpack_wire, jchunk.unpack_wire):
        w = unpack(wires[0].numpy(), H, W, 32, cap, fine=True)
        assert w["gran"] == 2
        g = w["gran"]
        for key, name in (("depth16", "depth_u"), ("trd16", "trd_u"),
                          ("intra16", "pred_intra_u"), ("mv16", "mv_u")):
            up = np.repeat(np.repeat(w[key], g, 0), g, 1)
            np.testing.assert_array_equal(up, res[name].numpy(), key)
        assert (w["depth16"] == 2).any() and int(w["cnt"][0]) > 0


# ---------------------------------------------------------------------------
SESSIONS = ("full32_small", "full32_s16_small")


@pytest.mark.parametrize("name", SESSIONS)
def test_full_session_matches_fixture(name):
    params = check_session(name)
    assert (params.ctu_log2, params.min_cu_log2) == (5, 3)
    entry = fixture()[name]
    # FULL codes the same IDR as FAST; its P frames differ
    fast = fixture()["fast_small"]["aus"] if name == "full32_small" else \
        fixture()["fast_s16_small"]["aus"]
    assert entry["aus"][0] == fast[0]
    assert entry["aus"][1:] != fast[1:len(entry["aus"])]
