"""rd_mode FAST and DIST_ONLY in the IDR, and all-intra sessions, in the
torch port against the JAX package, on the CPU:

  intra_torch._open_loop_maps     vs intra_jax._open_loop_maps in rd_mode 0
                                  (lambda 0) and 2 (the 11-mode battery, the
                                  +-2/+-1 refinement, the TU-split cost
                                  vectors mapped through the mode list),
                                  map by map, at 128x96
  intra_torch.encode_frame_intra  vs intra_jax.encode_frame_intra without
                                  split RDO (the FASTEST IDR's closed-loop
                                  search over the lane's mode set) in
                                  rd_mode 0 and 2, array by array, at 96x64
  all-intra sessions              intra_period 1 in rd_mode 0, 1 and 2 at
                                  CTU 32 (split RDO, and FASTEST in 0 and 2)
                                  and CTU 64 (split RDO), against the JAX
                                  package's AU hashes, each decoding in
                                  libde265 to the port's reconstruction; the
                                  JAX package's split-RDO IDR compiles for
                                  minutes per shape and rd_mode on a CPU
                                  (about 40 at CTU 64), so these are held to
                                  the fixture
  check_slice                     admits every rd_mode at CTU 32 and 64,
                                  and wpp_shards > 1 (no mesh on the CPU);
                                  refuses FAST at cu_size 16 and
                                  bit_depth != 8 by name

rd_mode acts on the intra path only: neither package's P stage reads it.
Inputs are made from a seed with numpy. Tolerance: exact equality.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu import tables as jtables
from homerhevc_tpu.pipeline import intra_jax, p_jax
from homerhevc_tpu_torch.api import HomerEncoder, check_slice
from homerhevc_tpu_torch.config import RDMode
from homerhevc_tpu_torch.pipeline import intra_torch, p_chunk, p_torch
from homerhevc_tpu_torch.utils import fixtures as fx
from test_torch_ctu64 import check_decodes, fixture
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

QP = 32
I32 = torch.int32
ALLINTRA = ([f"allintra_rd{rd}_small" for rd in (0, 1, 2)]
            + [f"allintra_fastest_rd{rd}_small" for rd in (0, 2)]
            + [f"allintra64_rd{rd}_small" for rd in (0, 1, 2)])
MAP_NAMES = ("mode_u", "depth_u", "part_u", "trd_u")



@functools.lru_cache(maxsize=None)
def open_loop_both(rd_mode):
    """(JAX maps as numpy, port maps) of pass A on a 128x96 frame that
    drives every split branch."""
    y = fx.intra_frame(128, 96, 5)[0]
    lam = int(jtables.LAMBDA_FX[QP])
    fn = jax.jit(intra_jax._open_loop_maps,
                 static_argnames=("B", "strong_smoothing", "rd_mode",
                                  "tu_split"))
    want = fn(jnp.asarray(y), B=32, qp=jnp.int32(QP), lam_fx=jnp.int32(lam),
              strong_smoothing=True, rd_mode=rd_mode, tu_split=True)
    got = intra_torch._open_loop_maps(
        torch.as_tensor(y), B=32, qp=torch.tensor(QP, dtype=I32),
        lam_fx=torch.tensor(lam, dtype=I32), strong_smoothing=True,
        rd_mode=rd_mode, tu_split=True)
    return tuple(np.asarray(a) for a in want), tuple(g.to(I32) for g in got)


@pytest.mark.parametrize("rd_mode", [0, 2])
def test_open_loop_maps_rd_mode(rd_mode):
    want, got = open_loop_both(rd_mode)
    for name, a, b in zip(MAP_NAMES, want, got):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    mode_u, depth_u, part_u, trd_u = (g.numpy() for g in got)
    assert (depth_u == 2).any() and part_u.any() and trd_u.any()
    # the port's rd FULL maps on the same frame: each rd_mode decides
    # differently
    full = [m.numpy() for m in intra_torch._open_loop_maps(
        torch.as_tensor(fx.intra_frame(128, 96, 5)[0]), B=32,
        qp=torch.tensor(QP, dtype=I32),
        lam_fx=torch.tensor(int(jtables.LAMBDA_FX[QP]), dtype=I32),
        strong_smoothing=True, rd_mode=1, tu_split=True)]
    assert not np.array_equal(mode_u, full[0])
    if rd_mode == 0:
        # without a rate term a split costs nothing: more and smaller CUs
        assert (depth_u == 2).sum() > (full[1] == 2).sum()
        assert (depth_u <= 1).sum() < (full[1] <= 1).sum()
    else:
        for d in (0, 1, 2):
            assert (depth_u == d).any(), f"no CU of depth {d}"
    if rd_mode == 2:
        # the refinement moves winners off the 11-mode list, and the
        # TU-split picks map back through it
        off = ~np.isin(mode_u, intra_torch._FAST_MODES)
        assert off.any(), "no refined mode"
        assert (off & (trd_u == 0)).any()


@functools.lru_cache(maxsize=None)
def fixed_cu_both(rd_mode):
    frame = fx.intra_frame(96, 64, 5)
    kw = dict(B=32, qp=QP, sign_hiding=True, split_rdo=False,
              rd_mode=rd_mode, tu_depth=0)
    want = intra_jax.encode_frame_intra(*map(jnp.asarray, frame), **kw)
    got = intra_torch.encode_frame_intra(*map(torch.as_tensor, frame), **kw)
    return {k: np.asarray(want[k]) for k in fx.INTRA_KEYS}, got


@pytest.mark.parametrize("rd_mode", [0, 2])
def test_encode_frame_intra_fixed_cu_rd_mode(rd_mode):
    want, got = fixed_cu_both(rd_mode)
    for k in fx.INTRA_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    modes = got["modes"].numpy()
    if rd_mode == 2:
        assert np.isin(modes, intra_torch._FAST_MODES).all()
    assert got["lev_y"].any()


@functools.lru_cache(maxsize=None)
def allintra_run(name):
    enc = HomerEncoder(fx.run_config(name), device="cpu", fetch_recon=False)
    aus = enc.encode_frames(fx.clip(name), chunk=fx.RUNS[name]["chunk"])
    ref = tuple(p.numpy() for p in enc._ref)
    enc.close()
    return aus, ref


@pytest.mark.parametrize("name", ALLINTRA)
def test_allintra_session_matches_fixture(name):
    entry = fixture()[name]
    assert {k: entry[k] for k in fx.RUNS[name]} == fx.RUNS[name]
    cfg = fx.run_config(name)
    assert cfg.intra_period == 1
    aus, ref = allintra_run(name)
    assert fx.au_digest(aus) == entry["aus"]
    # every frame an IDR with its parameter sets (VPS first)
    assert [a[4] >> 1 & 0x3F for a in aus] == [32] * len(aus)
    check_decodes(name, aus, ref)


def test_rd_modes_write_different_streams():
    for prefix in ("allintra_rd", "allintra64_rd"):
        hashes = [tuple(a["sha256"] for a in fixture()[f"{prefix}{rd}_small"]
                        ["aus"]) for rd in (0, 1, 2)]
        assert len(set(hashes)) == 3, prefix


def test_rd_mode_acts_on_the_intra_path_only():
    for mod in (p_jax, p_torch, p_chunk):
        assert "rd_mode" not in inspect.getsource(mod), mod.__name__
    assert "rd_mode" in inspect.getsource(intra_torch.encode_frame_intra)


@pytest.mark.parametrize("cu_size", [32, 64])
@pytest.mark.parametrize("rd_mode", list(RDMode))
def test_check_slice_admits_every_rd_mode(cu_size, rd_mode):
    kw = (fx.ctu64_kwargs if cu_size == 64 else fx.fast_kwargs)(
        128, 128, rd_mode=rd_mode.name)
    cfg = fx.config_from(kw)
    check_slice(cfg.validate())
    HomerEncoder(cfg, device="cpu").close()


@pytest.mark.parametrize("over, what", [
    # FAST at CTU 16 stays refused (fault 1 of the reference); FASTEST and
    # FASTER are ported there
    (dict(cu_size=16, performance_mode="FAST_COMPUTATION"), "cu_size=16"),
    (dict(wpp_shards=2), "wpp_shards=2"),
    (dict(bit_depth=10), "bit_depth=10"),
])
def test_check_slice_refuses_by_name(over, what):
    cfg = fx.config_from(fx.slice_kwargs(128, 128, **over))
    if "wpp_shards" in over:
        # admitted since the band mesh is ported; a CPU session has no
        # CUDA devices for one, so it builds none
        check_slice(cfg.validate())
        assert HomerEncoder(cfg, device="cpu")._mesh is None
        return
    with pytest.raises(NotImplementedError, match=what):
        HomerEncoder(cfg, device="cpu")
