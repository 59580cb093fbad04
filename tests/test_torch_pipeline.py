"""Frame pipelines of the torch port against the JAX package, output by
output, at 128x96 on the CPU (the port runs its kernels' plain versions):

  intra_torch.encode_frame_intra  vs intra_jax.encode_frame_intra
                                     (FASTEST: CU 32, no split RDO)
  p_torch.p_frame_device          vs p_jax.p_frame_device, search 8 and 16
  p_chunk.p_chunk_device          vs p_chunk.p_chunk_device(tree=False), K=3

Tolerance: exact equality of every output, the wires included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu.pipeline import intra_jax, p_jax
from homerhevc_tpu.pipeline import p_chunk as jchunk
from homerhevc_tpu.utils.synth import synth_clip
from homerhevc_tpu_torch.pipeline import intra_torch, p_torch
from homerhevc_tpu_torch.pipeline import p_chunk as tchunk
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

W, H = 128, 96


@pytest.fixture(scope="module")
def frames():
    return list(synth_clip(W, H, 4, seed=3))


def _cmp(want: dict, got: dict, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(want[k]),
                                      got[k].cpu().numpy(), err_msg=k)


def test_encode_frame_intra(frames):
    y, u, v = frames[0]
    want = intra_jax.encode_frame_intra(
        *map(jnp.asarray, (y, u, v)), B=32, qp=32, sign_hiding=True,
        split_rdo=False, rd_mode=1, tu_depth=0)
    got = intra_torch.encode_frame_intra(*map(torch.as_tensor, (y, u, v)),
                                         B=32, qp=32, sign_hiding=True)
    _cmp(want, got, ("wire", "modes", "mode_units", "depth_units", "lev_y",
                     "lev_u", "lev_v", "recon_y", "recon_u", "recon_v"))
    # and the port's host unpack reads the reference wire
    cnt, mode_u, depth_u, _, _, idx, vals = intra_torch.unpack_intra_wire(
        np.asarray(want["wire"]), H, W)
    assert cnt > 0 and np.array_equal(mode_u, np.asarray(want["mode_units"]))


@pytest.mark.parametrize("search", [8, 16])
def test_p_frame_device(frames, search):
    cur, ref = frames[1], frames[0]
    want = p_jax.p_frame_device(*map(jnp.asarray, cur + ref), B=32, qp=32,
                                search=search, me_precision=2, deblock=True,
                                sign_hiding=True)
    got = p_torch.p_frame_device(*map(torch.as_tensor, cur + ref), B=32,
                                 qp=32, search=search, me_precision=2,
                                 deblock=True, sign_hiding=True)
    _cmp(want, got, ("wire", "mvs", "sad", "lev_y", "lev_u", "lev_v",
                     "recon_y", "recon_u", "recon_v", "ref_y", "ref_u",
                     "ref_v"))


def test_p_chunk_device_k3(frames):
    ys, us, vs = (np.stack([f[k] for f in frames[1:4]]) for k in range(3))
    qps = np.array([32, 30, 34], np.int32)
    cap = 1024
    want = jchunk.p_chunk_device(
        *map(jnp.asarray, (ys, us, vs) + frames[0]), jnp.asarray(qps),
        ctu=32, search=16, me_precision=2, sign_hiding=True, deblock=True,
        sao=True, cap=cap, tree=False)
    got = tchunk.p_chunk_device(
        *map(torch.as_tensor, (ys, us, vs) + frames[0]),
        torch.as_tensor(qps), ctu=32, search=16, me_precision=2,
        sign_hiding=True, deblock=True, sao=True, cap=cap)
    for name, a, b in zip(("wires", "denses", "ref_y", "ref_u", "ref_v"),
                          want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    # the copied host unpack reads the port's wire
    w = tchunk.unpack_wire(got[0][0].numpy(), H, W, 32, cap)
    assert int(w["cnt"][0]) > 0 and w["vals"].shape == (cap, 16)
