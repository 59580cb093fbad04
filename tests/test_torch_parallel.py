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
    configurations, an uneven cut, CTU 64, IBP; the quadtree at the
    defaults' CTU 64, FULL, the hierarchical search on bands shorter than
    its halo, CBR without WPP, CTU 32 with a band at an odd CTU row) and
    with wpp_shards 4 write the JAX package's AUs (fixture hashes, recorded
    from the JAX session with and without its mesh), and every P frame ran
    in bands, fixed-CU or quadtree; so do IBP in FAST (the split-RDO IDR
    and the hierarchical B search in bands shorter than its halo),
    all-intra in rd_mode FAST and IBP with a scene cut beside a waiting B,
    and every IDR (scene cuts included) and every B frame of a mesh run
    went through the band functions (parallel/intra_bands.py,
    sharded.b_frame_bands), none through the single-device ones;
  * the quadtree stage in bands equals p_frame_tree_device on every output
    (CTU 32 and 64, FULL, search 8, 16 and 64, row QPs with and without
    WPP, intra-in-P), and so does the chunk in bands (p_chunk_device on a
    mesh) on every wire word and reference sample, for both stages;
  * the loop filter in bands (deblocking, SAO with the parameters derived
    on the host or on the first device) equals the whole-frame filter for
    both stages, and its halos are the least that do;
  * the P stage's halo covers every reference row the search and the
    level encodes read: rows beyond it filled with 0 or with 255 change
    nothing (search 8, 24, 32, 64);
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
from homerhevc_tpu_torch import tables
from homerhevc_tpu_torch.api import HomerEncoder, check_slice
from homerhevc_tpu_torch.kernels.build import CudaKernel
from homerhevc_tpu_torch.ops import deblock as dbk
from homerhevc_tpu_torch.ops import sao as sao_ops
from homerhevc_tpu_torch.parallel import intra_bands, sharded
from homerhevc_tpu_torch.pipeline import (b_torch, intra_torch, p_chunk,
                                           p_torch)
from homerhevc_tpu_torch.utils.synth import synth_clip
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


def _is_idr(au: bytes) -> bool:
    """Whether an AU's coded slice is an IDR (NAL type IDR_W_RADL)."""
    i = 0
    while True:
        i = au.index(b"\x00\x00\x01", i) + 3
        nal_type = (au[i] >> 1) & 63
        if nal_type < 32:                      # the first VCL NAL unit
            return nal_type == 19


@pytest.mark.parametrize("name", MESH_RUNS)
def test_mesh_session_matches_jax_fixture(name, fixture, monkeypatch):
    r = fx.RUNS[name]
    cfg = fx.run_config(name)
    calls, outs, starts = [], [], []
    stages = {"fixed": sharded._band_stage, "tree": sharded._band_stage_tree}
    finish = p_torch.tree_finish
    # the IDR and the B stage: in bands, or on one device
    frame_calls = []
    for mod, fn, kind in ((intra_bands, "intra_frame_bands", "idr bands"),
                          (intra_torch, "encode_frame_intra", "idr one"),
                          (sharded, "b_frame_bands", "b bands"),
                          (b_torch, "b_frame_device", "b one")):
        def frame_fn(*args, _f=getattr(mod, fn), _k=kind, **kw):
            frame_calls.append((_k, args[0] if _k.endswith("bands")
                                else None))
            return _f(*args, **kw)
        monkeypatch.setattr(mod, fn, frame_fn)
    b_frames = []
    encode_b = HomerEncoder._encode_b
    monkeypatch.setattr(HomerEncoder, "_encode_b", lambda self, *a: (
        b_frames.append(a[0][0]), encode_b(self, *a))[1])

    def counted(kind):
        def stage(cur, *args, **kw):
            calls.append((kind, len(cur)))
            out = stages[kind](cur, *args, **kw)
            outs.append((kw.get("qp_rows"), [c[0].shape[0] for c in cur],
                         out))
            return out
        return stage

    def finish_start(st, **kw):
        starts.append((kw.get("qp_start"), st["qp"]))
        return finish(st, **kw)

    monkeypatch.setattr(sharded, "_band_stage", counted("fixed"))
    monkeypatch.setattr(sharded, "_band_stage_tree", counted("tree"))
    monkeypatch.setattr(p_torch, "tree_finish", finish_start)
    mesh = ["cpu"] * r["mesh"] if r.get("mesh") else None
    enc = HomerEncoder(cfg, device="cpu", mesh=mesh)
    aus = fx.encode_run(enc, name)
    enc.close()
    assert fx.au_digest(aus) == fixture[name]["aus"]
    n_idr = sum(map(_is_idr, aus))
    if not mesh:
        assert not calls                 # no mesh without the devices
        assert [k for k, _ in frame_calls] == ["idr one"] * n_idr
        return
    # every IDR (scene cuts included) and every B frame ran in bands, on the
    # session's mesh, and none on one device
    kinds = [k for k, _ in frame_calls]
    assert kinds.count("idr bands") == n_idr
    assert n_idr or r.get("seeded")
    assert kinds.count("b bands") == len(b_frames)
    assert len(kinds) == n_idr + len(b_frames)
    assert all(len(m) == r["mesh"] for _, m in frame_calls)
    if r.get("push") and cfg.gop_size >= 2:
        assert b_frames
    # every P frame's stage ran in bands: the quadtree in FAST and FULL,
    # the fixed-CU grid in FASTEST and FASTER and in IBP's explicit P
    # frames
    kind = ("fixed" if cfg.performance_mode.name in (
        "FASTEST_COMPUTATION", "FASTER_COMPUTATION") else "tree")
    bands = len(sharded.band_heights(cfg.padded_height // cfg.cu_size,
                                     r["mesh"]))
    if cfg.intra_period == 1:                  # all-intra: no P frame
        assert not calls and n_idr == len(aus)
        return
    explicit = {("fixed", bands)} if r.get("push") else set()
    assert {(kind, bands)} <= set(calls) <= {(kind, bands)} | explicit
    if r.get("seeded") and not r.get("push"):
        assert len(calls) == r["frames"] - 1       # no IDR, no scene cut
    if name == "mesh_hier_small":
        assert cfg.me_search_range > p_torch.HIER_THRESHOLD
        assert max(outs[0][1]) < sharded.halo_rows(cfg.me_search_range)
    if name == "mesh_intra_p_odd_small":
        heights = outs[0][1]
        band_starts = np.cumsum([0] + heights[:-1]) // cfg.cu_size
        assert any(b % 2 for b in band_starts)
        # an intra-in-P CU accepted in the first CTU row of a band below
        # the first
        assert any(bool(o["pred_intra_u"][:cfg.cu_size // 4].any())
                   for _, _, out in outs for o in out[1:])
    if name == "mesh_cbr_tree_small":
        # row QPs that differ within a frame, and a band whose decoded-QP
        # start came from the band above and is not the slice QP
        assert any(len(set(rows.tolist())) > 1 for rows, _, _ in outs)
        assert any(s is not None and int(s) != int(q) for s, q in starts)


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


def _tree_case(W, H, seed, rows=None):
    """(current, reference) uint8 planes of synth_clip(W, H) frames 1 and 0,
    and the row QPs `rows` as a tensor."""
    fr = list(synth_clip(W, H, 2, seed=seed))
    cur = [torch.as_tensor(p) for p in fr[1]]
    ref = [torch.as_tensor(p) for p in fr[0]]
    qp_rows = None if rows is None else torch.tensor(rows, dtype=torch.int32)
    return cur, ref, qp_rows


# (width, height, bands, seed, stage keywords): CTU 32 with intra-in-P
# accepted in a band's first row; bands of 2, 1, 1, 1 CTU rows (one starting
# at the odd row 3); CTU 64 with conformance padding; FULL (8x8 CUs) through
# the hierarchical search at CTU 32 and 64 (bands shorter than its halo);
# row QPs without and with WPP at search 8
TREE_CASES = {
    "ctu32_intra": (128, 128, 4, 1, dict(ctu=32, search=16, tr_split=True,
                                         intra_in_p=True)),
    "ctu32_odd": (160, 160, 4, 0, dict(ctu=32, search=16, tr_split=True,
                                       intra_in_p=True)),
    "ctu64_vis": (128, 256, 4, 1, dict(ctu=64, search=16, tr_split=True,
                                       vis=(250, 120))),
    "full32_s64": (128, 160, 4, 1, dict(ctu=32, search=64, tr_split=True,
                                        intra_in_p=True, cu8=True)),
    "full64_s64": (128, 256, 3, 1, dict(ctu=64, search=64, tr_split=True,
                                        cu8=True)),
    "rows_s8": (128, 128, 4, 1, dict(ctu=32, search=8, tr_split=True,
                                     intra_in_p=True, rows=[30, 36, 33, 40])),
    "rows_wpp_s8": (128, 128, 4, 1, dict(ctu=32, search=8, tr_split=True,
                                         intra_in_p=True, wpp=True,
                                         rows=[30, 36, 33, 40])),
}


def _tree_kw(case):
    W, H, nb, seed, kw = TREE_CASES[case]
    kw = dict(kw)
    cur, ref, qp_rows = _tree_case(W, H, seed, kw.pop("rows", None))
    kw.setdefault("vis", (H, W))
    return cur, ref, nb, dict(kw, qp=32, me_precision=2, sign_hiding=True,
                              qp_rows=qp_rows, kernels=False)


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_stage_in_bands_equals_single_device(case):
    cur, ref, nb, kw = _tree_kw(case)
    want = p_torch.p_frame_tree_device(*cur, *ref, deblock=True, **kw)
    got = sharded.p_frame_tree_bands(["cpu"] * nb, *cur, *ref, deblock=True,
                                     **kw)
    assert set(want) <= set(got)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    if case in ("ctu32_intra", "ctu32_odd", "rows_s8", "rows_wpp_s8"):
        assert want["pred_intra_u"].any()          # intra-in-P was accepted


def test_intra_in_p_selects_the_worst_n_over_the_frame():
    """A frame of 18 x 8 CTUs (more than intra-in-P's 128) whose every CTU
    codes better as intra (a smooth picture over a noise reference): the
    bands, 36 CTUs each, must try the frame's worst 128 and accept as the
    frame's cascade does; each band's own worst N would try them all."""
    H, W = 256, 576
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[:H, :W]
    cur = [torch.as_tensor((60 + yy // 4 + xx // 6).astype(np.uint8)),
           torch.full((H // 2, W // 2), 120, dtype=torch.uint8),
           torch.full((H // 2, W // 2), 130, dtype=torch.uint8)]
    ref = [torch.as_tensor(rng.integers(0, 256, (h, w), dtype=np.uint8))
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    nb = (H // 32) * (W // 32)
    assert p_torch.intra_sel_count(nb) < nb // 4 * 4
    kw = dict(ctu=32, search=8, qp=32, me_precision=2, sign_hiding=True,
              intra_in_p=True, vis=(H, W), kernels=False)
    want = p_torch.p_frame_tree_device(*cur, *ref, **kw)
    got = sharded.p_frame_tree_bands(["cpu"] * 4, *cur, *ref, **kw)
    for key in sharded.TREE_KEYS:
        assert torch.equal(got[key], want[key]), key
    assert int(want["pred_intra_u"][::8, ::8].sum()) > nb // 8


def _sao_whole(cur, rec, ctu):
    """The session's whole-frame SAO (host derivation) of deblocked
    planes."""
    return sao_ops.sao_stage_device(
        [p.to(torch.int32) for p in cur], [p.to(torch.int32) for p in rec],
        ctu, 32, int(tables.chroma_qp_from_luma(32)), slice_p=True)


def _same_info(a, b):
    for key in ("luma", "cb", "cr"):
        for k in a[key]:
            np.testing.assert_array_equal(np.asarray(a[key][k]),
                                          np.asarray(b[key][k]))
    np.testing.assert_array_equal(a["merge_left"], b["merge_left"])
    np.testing.assert_array_equal(a["merge_up"], b["merge_up"])


@pytest.mark.parametrize("case", ["ctu32_intra", "ctu64_vis"])
def test_loop_filter_in_bands_equals_whole_frame_tree(case):
    cur, ref, nb, kw = _tree_kw(case)
    want = p_torch.p_frame_tree_device(*cur, *ref, deblock=True, **kw)
    info, filt = _sao_whole(cur, [want[k] for k in ("ref_y", "ref_u",
                                                    "ref_v")], kw["ctu"])
    got = sharded.p_frame_tree_bands(["cpu"] * nb, *cur, *ref, deblock=True,
                                     sao=True, **kw)
    for k, f in zip(("ref_y", "ref_u", "ref_v"), filt):
        assert torch.equal(got[k], f), k
    _same_info(got["sao_info"], info)
    assert any(info["luma"]["type"].ravel())       # SAO filters something


@pytest.mark.parametrize("B,H", [(32, 128), (64, 256)])
def test_loop_filter_in_bands_equals_whole_frame_fixed(B, H):
    cur, ref, _ = _tree_case(128, H, 2)
    kw = dict(B=B, qp=32, search=16, me_precision=2, sign_hiding=True,
              kernels=False)
    want = p_torch.p_frame_device(*cur, *ref, deblock=True, **kw)
    got = sharded.p_frame_bands(["cpu"] * 4, *cur, *ref, deblock=True, **kw)
    for key in want.keys() - {"amvp"}:        # the MVs before the merge
        assert torch.equal(got[key], want[key]), key
    info, filt = _sao_whole(cur, [want[k] for k in ("ref_y", "ref_u",
                                                    "ref_v")], B)
    got = sharded.p_frame_bands(["cpu"] * 4, *cur, *ref, deblock=True,
                                sao=True, **kw)
    for k, f in zip(("ref_y", "ref_u", "ref_v"), filt):
        assert torch.equal(got[k], f), k
    _same_info(got["sao_info"], info)


@pytest.mark.parametrize("tree", [False, True])
def test_chunk_in_bands_equals_single_device(tree):
    """p_chunk_device on a mesh (bands keep their filtered reference rows
    from frame to frame; SAO derived on the first device) against one
    device: every wire word, dense level and reference sample."""
    W, H, K = 128, 128, 3
    fr = list(synth_clip(W, H, K + 1, seed=4))
    ys, us, vs = (torch.as_tensor(np.stack([f[k] for f in fr[1:]]))
                  for k in range(3))
    ref = [torch.as_tensor(p) for p in fr[0]]
    qps = torch.tensor([32, 34, 31], dtype=torch.int32)
    kw = dict(ctu=32, search=16, me_precision=2, sign_hiding=True,
              deblock=True, sao=True, cap=1024, tree=tree, kernels=False)
    if tree:
        kw.update(tr_split=True, intra_in_p=True, vis=(H, W),
                  qp_rows=torch.tensor([[30, 36, 33, 40]] * K,
                                       dtype=torch.int32))
    want = p_chunk.p_chunk_device(ys, us, vs, *ref, qps, **kw)
    got = p_chunk.p_chunk_device(ys, us, vs, *ref, qps, mesh=["cpu"] * 4,
                                 **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _filter_inputs(H, W, ctu, seed):
    """Per-band stage results for the tree stage's loop filter, made up:
    pre-deblock planes of smooth ramps with a small step per 8x8 block (so
    that strong and weak luma filters and the chroma filter all run), and
    unit maps drawn at random (CU depth per 16x16, MVs, cbf, TU split,
    intra CUs, per-CTU QPs)."""
    rng = np.random.default_rng(seed)
    uh, uw = H // 4, W // 4

    def up(a, k):
        return np.repeat(np.repeat(a, k, 0), k, 1)

    def plane(h, w):
        yy, xx = np.mgrid[:h, :w]
        steps = up(rng.integers(-6, 7, (h // 8, w // 8)), 8)
        return torch.as_tensor(np.clip(100 + yy // 3 + xx // 4 + steps, 0,
                                       255).astype(np.int32))

    res = dict(
        recon_y=plane(H, W), recon_u=plane(H // 2, W // 2),
        recon_v=plane(H // 2, W // 2),
        depth_u=torch.as_tensor(up(rng.integers(0, 3, (H // 16, W // 16)),
                                   4).astype(np.int32)),
        mv_u=torch.as_tensor(up(rng.integers(-6, 7, (H // 8, W // 8, 2)),
                                2).astype(np.int32)),
        cbf_u=torch.as_tensor(up(rng.random((H // 8, W // 8)) < 0.3, 2)),
        trd_u=torch.as_tensor(up(rng.random((H // 16, W // 16)) < 0.2,
                                 4).astype(np.int32)),
        pred_intra_u=torch.as_tensor(up(rng.random((H // 16, W // 16))
                                        < 0.3, 4).astype(np.int32)),
        qp_u=torch.as_tensor(up(rng.integers(28, 40, (H // ctu, W // ctu)),
                                ctu // 4).astype(np.int32)))
    assert res["depth_u"].shape == (uh, uw)
    return res


@pytest.mark.parametrize("halos", [
    (dbk.HALO_Y, dbk.HALO_C, dbk.HALO_UNITS),
    (dbk.HALO_Y - 1, dbk.HALO_C, dbk.HALO_UNITS),
    (dbk.HALO_Y, dbk.HALO_C - 1, dbk.HALO_UNITS),
    (dbk.HALO_Y, dbk.HALO_C, (dbk.HALO_UNITS[0] - 1, dbk.HALO_UNITS[1])),
    (dbk.HALO_Y, dbk.HALO_C, (dbk.HALO_UNITS[0], dbk.HALO_UNITS[1] - 1)),
])
def test_deblocking_halo_is_the_least(halos, monkeypatch):
    """With the halos of ops/deblock.py the bands' rows of the deblocking
    filter equal the whole frame's (tree_deblock), on real stage output
    (the quadtree with intra-in-P CUs by band edges) and on made-up planes
    and unit maps; with one row fewer of any halo they do not."""
    H, W, ctu = 192, 128, 32
    rows = [64, 32, 64, 32]
    whole = _filter_inputs(H, W, ctu, 7)
    cuts = np.cumsum([0] + rows)
    outs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        o = {}
        for k, t in whole.items():
            s = 1 if k == "recon_y" else 2 if k.startswith("recon") else 4
            o[k] = t[a // s:b // s]
        outs.append(o)
    rec = tuple(whole[k] for k in ("recon_y", "recon_u", "recon_v"))
    want = p_torch.tree_deblock(rec, whole, ctu)
    cur, ref, nb, kw = _tree_kw("ctu32_intra")
    want_real = p_torch.p_frame_tree_device(*cur, *ref, deblock=True, **kw)
    hy, hc, hu = halos
    monkeypatch.setattr(dbk, "HALO_Y", hy)
    monkeypatch.setattr(dbk, "HALO_C", hc)
    monkeypatch.setattr(dbk, "HALO_UNITS", hu)
    got, _ = sharded.band_loop_filter([None] * 4, outs, tree=True, ctu=ctu,
                                      qp=32, deblock=True, sao=False)
    got = [torch.cat([g[k] for g in got]) for k in range(3)]
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    real = sharded.p_frame_tree_bands(["cpu"] * nb, *cur, *ref,
                                      deblock=True, **kw)
    same_real = all(torch.equal(real[k], want_real[k])
                    for k in ("ref_y", "ref_u", "ref_v"))
    least = halos == (4, 2, (2, 1))
    assert same == least
    assert same_real or not least


@pytest.mark.parametrize("search", [8, 24, 32, 64])
def test_p_stage_halo_covers_every_reference_row_read(search, monkeypatch):
    """Each band's padded reference with every row beyond halo_rows(search)
    filled with 0, and then with 255: the quadtree stage in bands (the
    dense sweep up to search 24, the hierarchical search above it, every
    level's encode at |mv| <= search + 3 with the 8-tap support) still
    equals the single-device stage. Bands of 64 and 32 rows, shorter than
    the halo at search 64."""
    cur, ref, _ = _tree_case(128, 160, 1)
    kw = dict(ctu=32, search=search, qp=32, me_precision=2,
              sign_hiding=True, tr_split=True, cu8=True, kernels=False)
    want = p_torch.p_frame_tree_device(*cur, *ref, **kw)
    ref_bands = sharded._ref_bands
    # padding rows beyond the halo, luma and chroma
    beyond = [(p_torch.PAD - sharded.halo_rows(search)) >> (k > 0)
              for k in range(3)]

    for fill in (0, 255):
        def poisoned(bands, s, fill=fill):
            out = []
            for planes in ref_bands(bands, s):
                filled = []
                for p, e in zip(planes, beyond):
                    p = p.clone()
                    p[:e] = fill
                    p[p.shape[0] - e:] = fill
                    filled.append(p)
                out.append(tuple(filled))
            return out

        monkeypatch.setattr(sharded, "_ref_bands", poisoned)
        got = sharded.p_frame_tree_bands(["cpu"] * 4, *cur, *ref, **kw)
        for key in sharded.TREE_KEYS:
            assert torch.equal(got[key], want[key]), (fill, key)
