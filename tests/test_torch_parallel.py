"""The port's multi-device modules (homerhevc_tpu_torch/parallel/sharded.py
and the session's band mesh) against the JAX package on the CPU.

  * the band- and lane-sharded P step (make_p_frame_sharded) on a (2, 4)
    mesh of "cpu" devices equals, output for output and element for
    element, the JAX package's make_p_frame_sharded on the conftest's 8
    virtual CPU devices at the shape of the JAX package's own dryrun;
  * at B 32 with search 16 and with the hierarchical search (search 64,
    bands of 96 rows, halo 72) it equals the port's single-device stage,
    lane by lane, and the JAX package's sharded step (SHA-256 per output in
    tests/fixtures/torch_port_aus.json, "sharded");
  * where the JAX package's sharded step differs from its own single-device
    stage ("merge_top": a band's first block row gets no merge candidate
    from the row above), the port's equals the single-device stage;
  * the halo of every band equals the rows of the globally edge-padded
    plane, for bands taller and shorter than the halo;
  * the step refuses what the JAX package's shard_map asserts (ValueError);
  * sessions with a band mesh of 4 (tests/test_multichip.py's
    configurations, an uneven cut, CTU 64, IBP) and with wpp_shards 4 write
    the JAX package's AUs (fixture hashes, recorded from the JAX session
    with and without its mesh), and the fixed-CU stages ran in bands;
  * check_slice admits wpp_shards > 1; without the devices the session
    builds no mesh; a mesh of another device type raises;
  * a kernel launch makes the tensors' device current around the launcher.

Tolerance: exact (integer arithmetic, bytes).
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from homerhevc_tpu.parallel import sharded as jax_sharded
from homerhevc_tpu_torch.api import HomerEncoder, check_slice
from homerhevc_tpu_torch.kernels.build import CudaKernel
from homerhevc_tpu_torch.parallel import sharded
from homerhevc_tpu_torch.pipeline import p_torch
from homerhevc_tpu_torch.utils import fixtures as fx
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")
MESH_RUNS = [n for n in fx.RUNS if n.startswith("mesh_")]


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def _port_step(name):
    """The port's sharded step on one of SHARDED_CASES on a mesh of "cpu"
    devices: its seven outputs and the input planes (torch)."""
    c = fx.SHARDED_CASES[name]
    cur, ref = (tuple(torch.as_tensor(p) for p in planes)
                for planes in fx.sharded_frames(name))
    mesh = [["cpu"] * c["bands"]] * c["lanes"]
    step = sharded.make_p_frame_sharded(mesh, B=c["B"], search=c["search"],
                                        me_precision=2)
    return step(*cur, *ref, [32] * c["lanes"]), cur, ref


def test_band_stage_matches_jax_sharded_at_dryrun_shape():
    c = fx.SHARDED_CASES["dryrun"]
    G, nb = c["lanes"], c["bands"]
    devs = jax.devices()
    assert len(devs) >= G * nb, "tests/conftest.py gives JAX 8 devices"
    mesh = Mesh(np.array(devs[:G * nb]).reshape(G, nb), ("gop", "band"))
    cur, ref = fx.sharded_frames("dryrun")
    gb = NamedSharding(mesh, P("gop", "band"))
    args = [jax.device_put(jnp.asarray(a), gb) for a in cur + ref]
    qp = jax.device_put(jnp.full((G,), 32, jnp.int32),
                        NamedSharding(mesh, P("gop")))
    want = jax_sharded.make_p_frame_sharded(
        mesh, B=c["B"], search=c["search"], me_precision=2)(*args, qp)
    got, _, _ = _port_step("dryrun")
    assert len(got) == len(want) == 7
    for key, g, w in zip(fx.SHARDED_KEYS, got, want):
        assert tuple(g.shape) == tuple(w.shape), key
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)
    # the port's own dryrun (every lane and output against p_frame_device)
    assert sharded.dryrun([["cpu"] * nb] * G)


@pytest.mark.parametrize("name", ["b32_s16", "b32_s64"])
def test_band_stage_matches_single_device_and_jax(name, fixture):
    c = fx.SHARDED_CASES[name]
    got, cur, ref = _port_step(name)
    for g in range(c["lanes"]):
        single = p_torch.p_frame_device(
            *(p[g] for p in cur), *(p[g] for p in ref), B=c["B"], qp=32,
            search=c["search"], me_precision=2)
        for key, out in zip(fx.SHARDED_KEYS, got):
            assert torch.equal(out[g], single[key]), (key, g)
    rec = fixture["sharded"][name]
    assert rec["sharded"] == rec["single"]        # the JAX package's too
    digests = {k: fx.array_digest(o.numpy())
               for k, o in zip(fx.SHARDED_KEYS, got)}
    assert digests == rec["sharded"]


def test_band_stage_takes_the_merge_candidate_above_the_band(fixture):
    """The JAX package's band function gives a band's first block row no
    'top' merge candidate, so its sharded step differs from its
    single-device stage here; the port's band stage passes the refined MVs
    of the row above on and equals the single-device stage."""
    rec = fixture["sharded"]["merge_top"]
    assert rec["sharded"]["mvs"] != rec["single"]["mvs"]
    got, cur, ref = _port_step("merge_top")
    digests = {k: fx.array_digest(o.numpy())
               for k, o in zip(fx.SHARDED_KEYS, got)}
    assert digests == rec["single"]
    c = fx.SHARDED_CASES["merge_top"]
    single = p_torch.p_frame_device(
        *(p[0] for p in cur), *(p[0] for p in ref), B=c["B"], qp=32,
        search=c["search"], me_precision=2)
    assert torch.equal(got[0][0], single["mvs"])


@pytest.mark.parametrize("heights", [(32, 32, 32, 32), (2, 1, 1, 1),
                                     (5, 3, 1, 7), (40,)])
@pytest.mark.parametrize("pad", [1, 16, 24, 72])
def test_halo_extend_equals_global_edge_padding(heights, pad):
    rng = np.random.default_rng(sum(heights) + pad)
    plane = rng.integers(0, 256, (sum(heights), 6)).astype(np.int16)
    want = np.pad(plane, ((pad, pad), (0, 0)), mode="edge")
    starts = np.cumsum((0,) + heights)
    bands = [torch.as_tensor(plane[a:b]) for a, b in zip(starts, starts[1:])]
    for band, a, h in zip(sharded._halo_extend(bands, pad), starts, heights):
        np.testing.assert_array_equal(band.numpy(), want[a:a + h + 2 * pad])


def test_band_heights_cut_ctu_rows_evenly():
    assert sharded.band_heights(23, 4) == [6, 6, 6, 5]
    assert sharded.band_heights(5, 4) == [2, 1, 1, 1]
    assert sharded.band_heights(3, 4) == [1, 1, 1]
    assert sharded.band_heights(12, 4) == [3, 3, 3, 3]
    assert sharded.halo_rows(8) == 16
    assert sharded.halo_rows(16) == 24
    assert sharded.halo_rows(64) == p_torch.PAD


@pytest.mark.parametrize("mesh,hw,B,search,lanes,match", [
    ([["cpu"] * 3], (128, 64), 16, 8, 1, "not divisible"),
    ([["cpu"] * 2], (96, 64), 32, 8, 1, "not a multiple"),
    ([["cpu"] * 4], (192, 64), 32, 8, 1, "not a multiple"),
    ([["cpu"] * 4], (64, 64), 16, 16, 1, "halo"),
    ([["cpu"] * 2], (128, 64), 16, 64, 1, "halo"),
    ([["cpu"] * 2] * 2, (128, 64), 16, 8, 1, "lanes"),
])
def test_sharded_step_refusals(mesh, hw, B, search, lanes, match):
    h, w = hw
    planes = [torch.zeros((lanes, h, w), dtype=torch.uint8)] + [
        torch.zeros((lanes, h // 2, w // 2), dtype=torch.uint8)] * 2
    step = sharded.make_p_frame_sharded(mesh, B=B, search=search,
                                        me_precision=2)
    with pytest.raises(ValueError, match=match):
        step(*planes, *planes, [32] * lanes)


def test_sharded_mesh_rows_must_be_equal():
    with pytest.raises(ValueError, match="one device per band"):
        sharded.make_p_frame_sharded([["cpu"] * 2, ["cpu"]], B=16, search=8,
                                     me_precision=2)


@pytest.mark.parametrize("name", MESH_RUNS)
def test_mesh_session_matches_jax_fixture(name, fixture, monkeypatch):
    r = fx.RUNS[name]
    calls = []
    band_p_stage = sharded.band_p_stage

    def counted(devs, *args, **kw):
        calls.append(len(devs))
        return band_p_stage(devs, *args, **kw)

    monkeypatch.setattr(sharded, "band_p_stage", counted)
    mesh = ["cpu"] * r["mesh"] if r.get("mesh") else None
    enc = HomerEncoder(fx.run_config(name), device="cpu", mesh=mesh)
    aus = fx.encode_run(enc, name)
    enc.close()
    assert fx.au_digest(aus) == fixture[name]["aus"]
    fixed_cu = fx.run_config(name).performance_mode.name in (
        "FASTEST_COMPUTATION", "FASTER_COMPUTATION")
    if mesh and fixed_cu:
        # every fixed-CU P stage ran in bands (P frames, explicit P frames)
        assert calls and set(calls) == {r["mesh"]}
    else:
        # the quadtree stage runs on one device; no mesh without devices
        assert not calls


def test_check_slice_admits_wpp_shards_and_no_mesh_without_devices():
    cfg = fx.run_config("mesh_wpp_shards_small")
    assert cfg.wpp_shards == 4
    check_slice(cfg)
    enc = HomerEncoder(cfg, device="cpu")
    assert enc._mesh is None           # a CPU session has no CUDA devices
    assert HomerEncoder(cfg, device="cpu", mesh=["cpu"])._mesh is None
    enc = HomerEncoder(cfg, mesh=["cpu"] * 2)
    assert enc.device == torch.device("cpu")
    assert enc._mesh == [torch.device("cpu")] * 2


def test_mesh_of_another_device_type_raises():
    cfg = fx.run_config("mesh_fastest_small")
    with pytest.raises(ValueError, match="another type"):
        HomerEncoder(cfg, device="cpu", mesh=["cpu", "meta"])
    with pytest.raises(ValueError, match="another type"):
        HomerEncoder(cfg, device="cpu", mesh=["meta", "meta"])


def test_kernel_launch_makes_the_tensors_device_current(monkeypatch):
    """launch_on (what ops/me.py and ops/gather.py call) enters
    torch.cuda.device(device) around the launcher and passes that device's
    current stream; no CUDA is needed: the launcher, the device context and
    the stream are fakes."""
    current = []

    class FakeDevice:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    streams = {}
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: streams.setdefault(
                            d, SimpleNamespace(cuda_stream=1000 + d.index)))
    seen = []
    kernel = CudaKernel("me_sad", [], [])
    monkeypatch.setattr(kernel, "load", lambda: lambda *args: seen.append(
        (current[-1] if current else None, args)) or 0)
    dev = torch.device("cuda", 3)
    kernel.launch_on(dev, 7, 8)
    assert seen == [(dev, (7, 8, 1003))]
    assert current == [] and kernel.launches == 1
