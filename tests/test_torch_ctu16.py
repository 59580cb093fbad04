"""CTU 16 (cu_size=16, FASTEST and FASTER) of the torch port against the JAX
package, on the CPU. Tolerance: exact equality of every integer array and
every AU byte.

Compared live (both packages in this process, the same numpy inputs; few
and small, since each JAX function compiles on first use):

  intra_torch._open_loop_maps(B=16)  vs intra_jax._open_loop_maps, rd_mode
                                        FULL with the TU split (every
                                        decision of the quadtree)
  me.integer_me_plain at B 16        vs me_pallas.integer_me_pallas in
                                        interpret mode, search 8 and 16
  p_torch.p_frame_device(B=16)       vs p_jax.p_frame_device, deblocked
  b_torch.b_frame_device(B=16)       vs b_jax.b_frame_device, padded picture

Compared through tests/fixtures/torch_port_aus.json (written from the JAX
package by tools/make_torch_fixtures.py):

  intra_torch.encode_frame_intra(B=16): the split-RDO IDR in every rd_mode
  with and without the TU split (pass A's unit maps, pass B's levels,
  reconstruction and wire) and the fixed-CU IDR in rd_mode FULL and FAST,
  one SHA-256 per output array (fixtures.INTRA16_CASES);
  every small CTU-16 session run (fixtures.CTU16_RUNS) on one device; their
  twins on a band mesh of 4 (the `mesh_` runs) are held to the fixture by
  tests/test_torch_parallel.py::test_mesh_session_matches_jax_fixture,
  which also asserts that every frame ran in bands;
  the port's CLI at -cu_size 16 -performance_mode 3 against the JAX CLI's
  .265 and -o-raw files.

Band functions at B 16 against the port's single-device functions: pass A
(and its source-row halo, which is the least), the wavefront of both IDRs
with the IDR's deblocking and SAO (a band starting 16 rows off the IDR's
32-row TU grid), the fixed-CU P stage with its loop filter, the B stage.

Fault 2 of the reference (ROADMAP.md): at CTU 16 the all-intra deblocking
takes the TU size as 32 >> depth, with depths counted from a 16-CU, so the
encoder filters the IDR on a grid twice as coarse as a decoder's. The
port writes the JAX package's bytes, and `test_fault2_*` records that its
FASTEST and FASTER streams decode in libde265 to pictures that differ from
its own reconstruction (skipped only where libde265 does not load).
"""

import contextlib
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu import tables as jtables
from homerhevc_tpu.ops.me_pallas import integer_me_pallas
from homerhevc_tpu.pipeline import b_jax, intra_jax, p_jax
from homerhevc_tpu_torch import app, tables
from homerhevc_tpu_torch.api import HomerEncoder, check_slice
from homerhevc_tpu_torch.ops import intra as intra_ops
from homerhevc_tpu_torch.ops import me
from homerhevc_tpu_torch.ops import sao as sao_ops
from homerhevc_tpu_torch.parallel import intra_bands, sharded
from homerhevc_tpu_torch.pipeline import b_torch, intra_torch, p_torch
from homerhevc_tpu_torch.utils import fixtures as fx
from homerhevc_tpu_torch.utils.synth import synth_clip
from homerhevc_tpu_torch.validate import de265
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")
QP = 32
QP_C = int(tables.chroma_qp_from_luma(QP))
I32 = torch.int32
PAD = p_torch.PAD


@functools.lru_cache(maxsize=None)
def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def _frame(W, H, seed=5):
    return tuple(torch.as_tensor(p) for p in fx.intra_frame(W, H, seed))


def _lam(qp=QP):
    return torch.as_tensor(tables.LAMBDA_FX)[qp]


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["FASTEST_COMPUTATION",
                                  "FASTER_COMPUTATION"])
@pytest.mark.parametrize("over", [{}, dict(wpp_shards=4), dict(gop_size=2),
                                  dict(bitrate_mode="CBR", wpp=True)])
def test_check_slice_admits_fastest_and_faster_at_ctu16(mode, over):
    cfg = fx.config_from(fx.slice_kwargs(128, 96, cu_size=16,
                                         performance_mode=mode, **over))
    check_slice(cfg.validate())
    enc = HomerEncoder(cfg, device="cpu")
    assert enc._mesh is None           # a CPU session has no CUDA devices
    assert enc.ctu == 16 and enc.params.max_tu_log2 == 4
    assert enc.params.min_cu_log2 == (3 if mode == "FASTER_COMPUTATION"
                                      else 4)
    enc.close()


@pytest.mark.parametrize("mode", ["FAST_COMPUTATION", "FULL_COMPUTATION"])
def test_check_slice_refuses_fast_and_full_at_ctu16_naming_fault1(mode):
    cfg = fx.config_from(fx.slice_kwargs(128, 96, cu_size=16,
                                         performance_mode=mode))
    with pytest.raises(NotImplementedError,
                       match=f"cu_size=16 with {mode} \\(fault 1"):
        HomerEncoder(cfg, device="cpu")


def test_check_slice_refuses_bit_depth_at_ctu16():
    cfg = fx.config_from(fx.slice_kwargs(128, 96, cu_size=16, bit_depth=10))
    with pytest.raises(NotImplementedError, match="bit_depth=10"):
        HomerEncoder(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the IDR at B 16
# ---------------------------------------------------------------------------

def test_open_loop_maps_b16_matches_jax():
    """Pass A at B 16 (sizes 4, 8 and 16; depth 0 a 16-CU, 1 an 8-CU) with
    the TU split, live against the reference (the other rd_modes: the
    fixture's INTRA16_CASES)."""
    y = fx.intra_frame(64, 64, 5)[0]
    lam = int(jtables.LAMBDA_FX[QP])
    fn = jax.jit(intra_jax._open_loop_maps,
                 static_argnames=("B", "strong_smoothing", "rd_mode",
                                  "tu_split"))
    want = fn(jnp.asarray(y), B=16, qp=jnp.int32(QP), lam_fx=jnp.int32(lam),
              strong_smoothing=True, rd_mode=1, tu_split=True)
    got = intra_torch._open_loop_maps(
        torch.as_tensor(y), B=16, qp=torch.tensor(QP, dtype=I32),
        lam_fx=torch.tensor(lam, dtype=I32), strong_smoothing=True,
        rd_mode=1, tu_split=True)
    for name, a, b in zip(("mode_u", "depth_u", "part_u", "trd_u"), want,
                          got):
        np.testing.assert_array_equal(np.asarray(a), b.to(I32).numpy(),
                                      err_msg=name)
    mode_u, depth_u, part_u, trd_u = got
    assert set(np.unique(depth_u.numpy())) == {0, 1}
    assert part_u.any() and not (part_u & (depth_u < 1)).any()
    assert ((trd_u > 0) & (depth_u == 0)).any(), "no TU split of a 16x16"
    assert ((trd_u > 0) & (depth_u == 1)).any(), "no TU split of an 8x8"
    assert not ((trd_u > 0) & part_u).any()


@functools.lru_cache(maxsize=None)
def _port_intra16(case: str):
    c = fx.INTRA16_CASES[case]
    frame = fx.intra_frame(c["width"], c["height"], c["seed"])
    return intra_torch.encode_frame_intra(
        *map(torch.as_tensor, frame), B=16, qp=QP, sign_hiding=True,
        split_rdo=c["split"], rd_mode=c["rd_mode"], tu_depth=c["tu_depth"])


@pytest.mark.parametrize("case", list(fx.INTRA16_CASES))
def test_encode_frame_intra_b16_matches_jax_fixture(case):
    """The IDR at B 16, every output and the wire, against the JAX
    package's encode_frame_intra(B=16): the split-RDO quadtree (pass A's
    maps followed closed-loop by pass B's wavefront of 16-CTUs) or the
    fixed CU (the 35-mode battery per 16-block, FASTEST's IDR)."""
    want = _fixture()["intra16"][case]
    assert {k: want[k] for k in fx.INTRA16_CASES[case]} == \
        fx.INTRA16_CASES[case]
    out = _port_intra16(case)
    for k in fx.INTRA_KEYS:
        assert fx.array_digest(out[k].numpy()) == want["arrays"][k], k
    c = fx.INTRA16_CASES[case]
    depth = out["depth_units"]
    if c["split"]:
        assert int(depth.max()) == 1 and int(depth.min()) == 0
        assert bool(out["part_units"].any())
        assert bool(out["trd_units"].any()) == bool(c["tu_depth"])
    else:
        assert not depth.any() and len(set(out["modes"].flatten().tolist())) > 3


# ---------------------------------------------------------------------------
# the fixed-CU P stage and the B stage at B 16
# ---------------------------------------------------------------------------

def _me_inputs(H=64, W=128, S=8, seed=7):
    rng = np.random.default_rng(seed)
    n = 2 * S + 1
    cur = rng.integers(0, 256, (H, W)).astype(np.int16)
    ref = rng.integers(0, 256, (H + 2 * PAD, W + 2 * PAD)).astype(np.int16)
    ref[PAD:PAD + H, PAD + 3:PAD + 3 + W - 8] = cur[:, :W - 8]   # a match
    mv = rng.integers(0, 40, (n * n,)).astype(np.int32)
    return cur, ref, mv


@pytest.mark.parametrize("search", [8, 16])
def test_integer_me_b16_matches_pallas(search):
    """me_sad's plain version at B 16 (the kernel's B-16 tile on the card)
    against the JAX package's Pallas kernel in interpret mode."""
    cur, ref, mv = _me_inputs(S=search)
    cj, ij = integer_me_pallas(jnp.asarray(cur), jnp.asarray(ref),
                               jnp.asarray(mv), B=16, search=search, pad=PAD,
                               interpret=True)
    ct, it = me.integer_me(torch.as_tensor(cur), torch.as_tensor(ref),
                           torch.as_tensor(mv), B=16, search=search, pad=PAD)
    assert ct.shape == (4, 8)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())


def test_p_frame_device_b16_matches_jax():
    f0, f1 = synth_clip(128, 96, 2, seed=3)
    kw = dict(B=16, qp=QP, search=16, me_precision=2, deblock=True,
              sign_hiding=True)
    want = p_jax.p_frame_device(*map(jnp.asarray, f1 + f0), **kw)
    got = p_torch.p_frame_device(*map(torch.as_tensor, f1 + f0), **kw)
    for k in ("wire", "mvs", "sad", "lev_y", "lev_u", "lev_v", "recon_y",
              "recon_u", "recon_v", "ref_y", "ref_u", "ref_v"):
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)
    mvs = got["mvs"].numpy()
    assert got["mvs"].shape == (6, 8, 2) and len(np.unique(mvs[..., 1])) > 1


def _b_planes(W=120, H=88, seed=1):
    """Frame 1 of a clip between frames 0 and 2, edge-padded to 16-CTUs
    (128x96), as the session pads them."""
    ph, pw = -(-H // 16) * 16, -(-W // 16) * 16

    def pad(f):
        return tuple(np.pad(p, ((0, (ph - H) >> (k > 0)),
                                (0, (pw - W) >> (k > 0))), mode="edge")
                     for k, p in enumerate(f))

    f0, f1, f2 = (pad(f) for f in synth_clip(W, H, 3, seed=seed))
    return f1 + f0 + f2, (H, W)


def test_b_frame_device_b16_matches_jax():
    planes, vis = _b_planes()
    kw = dict(B=16, qp=QP + 2, search=16, me_precision=2, sign_hiding=True,
              vis=vis)
    want = b_jax.b_frame_device(*map(jnp.asarray, planes), **kw)
    got = b_torch.b_frame_device(*map(torch.as_tensor, planes), **kw)
    keys = ("idc", "mv0", "mv1", "lev_y", "lev_u", "lev_v", "rec_y", "rec_u",
            "rec_v")
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    wire = b_torch.unpack_b_wire(got["wire"].numpy(), 96, 128, 16)
    for k, v in wire.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]),
                                      err_msg=f"wire {k}")
    assert got["idc"].shape == (6, 8)
    assert len(np.unique(got["idc"].numpy())) > 1


# ---------------------------------------------------------------------------
# the bands at B 16
# ---------------------------------------------------------------------------

def _pass_a(y, rd, tu, devs=None):
    qp = torch.tensor(QP, dtype=I32)
    if devs is None:
        return intra_torch._open_loop_maps(
            y, B=16, qp=qp, lam_fx=_lam(), strong_smoothing=True,
            rd_mode=rd, tu_split=tu)
    rows, devs = sharded.band_rows(devs, y.shape[0], 16)
    parts = intra_bands.open_loop_maps_bands(
        y, rows, devs, qp=QP, strong_smoothing=True, rd_mode=rd,
        tu_split=tu, B=16)
    return tuple(torch.cat([p[k] for p in parts]) for k in range(4))


@pytest.mark.parametrize("tu", [False, True], ids=["tu0", "tu1"])
@pytest.mark.parametrize("rd", [0, 1, 2])
def test_open_loop_maps_b16_in_bands_equal_whole_frame(rd, tu):
    y = _frame(64, 80)[0]                     # 5 CTU rows: bands 2, 1, 1, 1
    want = _pass_a(y, rd, tu)
    got = _pass_a(y, rd, tu, ["cpu"] * 4)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k
    assert int(want[1].max()) == 1            # the quadtree splits to 8x8


def _halo_plane16():
    """A made-up 64x32 luma plane on which pass A at B 16 reads the last
    sample of a left column 16 rows below its band: smooth ramps; column
    15, rows 0-31, noisy, with row 30 far from row 31; the 16x16 block
    right of it (rows 0-15) is the angular mode 2 prediction from that
    column, whose last sample reads row 31, so a band that clamps at row
    30 decides that block differently."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :32]
    y = 100 + yy // 4 + xx // 8 + rng.integers(-1, 2, (64, 32))
    col = y[:32, 15]
    col[:30] += rng.integers(-30, 31, 30)
    col[30], col[31] = 20, 240
    y = torch.as_tensor(np.clip(y, 0, 255).astype(np.int32))
    left = y[:32, 15][None]
    refs = intra_ops.prepare_refs(
        left[:, :1].expand(1, 32), left, left[:, 0], torch.tensor([True]),
        torch.tensor([False]), size=16, c_idx=0, strong_smoothing=True)
    y[:16, 16:] = intra_ops.predict_one_mode(*refs, torch.tensor([2]),
                                             size=16, c_idx=0)[0]
    return y.to(torch.uint8)


@pytest.mark.parametrize("halo", [(1, 16), (0, 16), (1, 15)])
def test_open_loop_halo_b16_is_the_least(halo, monkeypatch):
    """At B 16 pass A's bands read open_loop_halo(16) = (1, 16) rows beyond
    them; with one row fewer above or below, a map differs."""
    assert intra_bands.open_loop_halo(16) == (1, 16)
    y = _halo_plane16()
    want = _pass_a(y, 1, True)
    assert int(want[0][0, 4]) == 2            # mode 2 decides the block
    monkeypatch.setattr(intra_bands, "open_loop_halo", lambda B: halo)
    got = _pass_a(y, 1, True, ["cpu"] * 4)    # bands of one CTU row
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    assert same == (halo == (1, 16))


# (width, height, split_rdo, rd_mode, tu_depth, bands, intra_frame seed):
# 6 CTU rows in bands of 2, 2, 1, 1 (the fourth starts at row 80, 16 rows
# off the IDR's 32-row TU grid) or 5 in 2, 1, 1, 1
IDR16_CASES = {
    "split_rd1_tu1": (96, 96, True, 1, 1, 4, 3),
    "split_rd2_tu0": (96, 96, True, 2, 0, 4, 3),
    "split_rd0_tu1": (64, 80, True, 0, 1, 4, 5),
    "fixed_rd1": (96, 96, False, 1, 0, 4, 3),
}


@pytest.mark.parametrize("case", list(IDR16_CASES))
def test_intra_b16_in_bands_equals_single_device(case):
    """The IDR at CTU 16 in bands (pass A, the wavefront with its row
    handoff, deblocking and SAO) against encode_frame_intra and the
    whole frame's loop filter."""
    W, H, split, rd, tu, nb, seed = IDR16_CASES[case]
    planes = _frame(W, H, seed)
    kw = dict(B=16, qp=QP, sign_hiding=True, split_rdo=split, rd_mode=rd,
              tu_depth=tu)
    want = intra_torch.encode_frame_intra(*planes, **kw)
    fy = p_torch.deblock_intra_device(
        want["recon_y"], want["recon_u"], want["recon_v"], qp=QP,
        depth_units=want["depth_units"],
        trd_units=want["trd_units"] if tu else None)
    info, filt = sao_ops.sao_stage_device(planes, fy, 16, QP, QP_C)
    got = intra_bands.intra_frame_bands(["cpu"] * nb, *planes, deblock=True,
                                        sao=True, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, f in zip("yuv", filt):
        assert torch.equal(got[f"ref_{k}"], f), k
    for comp in ("luma", "cb", "cr"):
        for k in info[comp]:
            np.testing.assert_array_equal(np.asarray(got["sao_info"][comp][k]),
                                          np.asarray(info[comp][k]))
    rows, _ = sharded.band_rows(["cpu"] * nb, H, 16)
    assert any(r % 32 for r in np.cumsum(rows[:-1]))
    if split:
        assert int(want["depth_units"].max()) == 1


def test_intra_deblocking_b16_bands_off_the_32_grid():
    """The IDR's deblocking in bands of 16-CTU rows that start 16 rows off
    its 32-row TU grid (fault 2 keeps that grid at CTU 16), on made-up
    planes with CU depths of 0 and 1 and TU splits: the bands' rows equal
    deblock_intra_device's."""
    H, W = 160, 64
    rows = [48, 16, 32, 64]
    rng = np.random.default_rng(4)

    def up(a, k):
        return np.repeat(np.repeat(a, k, 0), k, 1)

    def plane(h, w):
        yy, xx = np.mgrid[:h, :w]
        steps = up(rng.integers(-9, 10, (h // 8, w // 8)), 8)
        return torch.as_tensor(np.clip(100 + yy // 3 + xx // 4 + steps, 0,
                                       255).astype(np.int32))

    whole = dict(recon_y=plane(H, W), recon_u=plane(H // 2, W // 2),
                 recon_v=plane(H // 2, W // 2),
                 depth_units=torch.as_tensor(up(rng.integers(
                     0, 2, (H // 16, W // 16)), 4).astype(np.int32)),
                 trd_units=torch.as_tensor(up(rng.random(
                     (H // 16, W // 16)) < 0.3, 4).astype(np.int32)))
    want = p_torch.deblock_intra_device(
        whole["recon_y"], whole["recon_u"], whole["recon_v"], qp=QP,
        depth_units=whole["depth_units"], trd_units=whole["trd_units"])
    cuts = np.cumsum([0] + rows)
    outs = [{k: t[a // s:b // s] for k, t, s in (
        (k, t, 1 if k == "recon_y" else 2 if k.startswith("recon") else 4)
        for k, t in whole.items())} for a, b in zip(cuts[:-1], cuts[1:])]
    got, _ = sharded.band_loop_filter([None] * 4, outs, ctu=16, qp=QP,
                                      deblock=True, sao=False, intra=True)
    for k in range(3):
        assert torch.equal(torch.cat([g[k] for g in got]).to(torch.uint8),
                           want[k]), k


@pytest.mark.parametrize("search", [16, 64])
def test_p_frame_b16_in_bands_equals_single_device(search):
    """The fixed-CU P stage at B 16 in bands (the band above's MV row, the
    reference halo; at search 64 the hierarchical search on bands shorter
    than its halo) with deblocking and SAO, against p_frame_device and the
    whole frame's SAO."""
    f0, f1 = (tuple(torch.as_tensor(p) for p in f)
              for f in synth_clip(128, 96, 2, seed=3))
    kw = dict(B=16, qp=QP, search=search, me_precision=2, deblock=True,
              sign_hiding=True)
    want = p_torch.p_frame_device(*f1, *f0, **kw)
    info, filt = sao_ops.sao_stage_device(
        f1, (want["ref_y"], want["ref_u"], want["ref_v"]), 16, QP, QP_C,
        slice_p=True)
    got = sharded.p_frame_bands(["cpu"] * 4, *f1, *f0, sao=True, **kw)
    for k in ("wire", "mvs", "sad", "lev_y", "lev_u", "lev_v", "recon_y",
              "recon_u", "recon_v"):
        assert torch.equal(got[k], want[k]), k
    for k, f in zip("yuv", filt):
        assert torch.equal(got[f"ref_{k}"], f), k
    for comp in ("luma", "cb", "cr"):
        for k in info[comp]:
            np.testing.assert_array_equal(np.asarray(got["sao_info"][comp][k]),
                                          np.asarray(info[comp][k]))
    rows, _ = sharded.band_rows(["cpu"] * 4, 96, 16)
    if search > p_torch.HIER_THRESHOLD:
        assert min(rows) < sharded.halo_rows(search)


@pytest.mark.parametrize("search", [16, 64])
def test_b_stage_b16_in_bands_equals_single_device(search):
    planes, vis = _b_planes()
    planes = [torch.as_tensor(p) for p in planes]
    kw = dict(B=16, qp=QP + 2, search=search, me_precision=2,
              sign_hiding=True, vis=vis, kernels=False)
    want = b_torch.b_frame_device(*planes, **kw)
    got = sharded.b_frame_bands(["cpu"] * 4, *planes, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _session(name: str):
    """The port's AUs and per-frame reconstructions (the decoder's output
    pictures, in decode order) of one of CTU16_RUNS, on one device."""
    enc = HomerEncoder(fx.run_config(name), device="cpu")
    recons = []
    encode_frame = enc.encode_frame

    def recording(*args, **kw):
        au = encode_frame(*args, **kw)
        recons.append(enc.last_recon)
        return au

    enc.encode_frame = recording
    aus = fx.encode_run(enc, name)
    enc.close()
    return aus, recons


@pytest.mark.parametrize("name", list(fx.CTU16_RUNS))
def test_ctu16_run_matches_jax_fixture(name):
    entry = _fixture()[name]
    assert {k: entry[k] for k in fx.RUNS[name]} == fx.RUNS[name]
    aus, _ = _session(name)
    assert fx.au_digest(aus) == entry["aus"]


def _drift(name):
    """The largest |decoded - reconstructed| per frame and plane of a
    CTU-16 run coded frame by frame (encode_frames' chunks return no
    per-frame reconstruction)."""
    enc = HomerEncoder(fx.run_config(name), device="cpu")
    aus, recons = [], []
    for f in fx.clip(name):
        aus.append(enc.encode_frame(*f))
        recons.append(enc.last_recon)
    enc.close()
    dec = de265.decode_annexb(b"".join(aus))
    assert len(dec) == len(aus)
    diff = [[int(np.abs(d[k].astype(np.int32) - r[k].astype(np.int32)).max())
             for k in range(3)] for d, r in zip(dec, recons)]
    return aus, recons, dec, diff


@pytest.mark.parametrize("name", ["fastest16_small", "faster16_rd1_small"])
def test_fault2_ctu16_streams_drift_in_libde265(name):
    """Fault 2 of the reference, in FASTEST and in FASTER: the IDR is
    deblocked on the 32-row and 32-column TU grid of `32 >> depth` (depth 0
    a 16-CU), which a decoder filters at 16, so libde265 decodes the
    stream, the JAX package's bytes, to pictures that differ from the
    port's reconstruction from the IDR on; the P frames carry the drift."""
    if not de265.available():
        pytest.skip("libde265 does not load")
    aus, recons, dec, diff = _drift(name)
    # the same bytes as the JAX package's (the fixture; coded frame by
    # frame here, in chunks there)
    assert fx.au_digest(aus) == _fixture()[name]["aus"]
    assert all(max(d) > 0 for d in diff), diff
    # on the IDR, luma differs only near 16-pel TU edges that the encoder
    # did not filter (x or y = 16 mod 32): the deblocking filter's 3
    # samples on either side, and one more that SAO's edge classes read
    y = np.abs(dec[0][0].astype(np.int32) - recons[0][0].astype(np.int32))
    ys, xs = np.nonzero(y)
    near = np.minimum(np.abs((ys % 32) - 16 + 0.5),
                      np.abs((xs % 32) - 16 + 0.5)) <= 4.5
    if name == "fastest16_small":
        assert near.all()
    assert near.any()


def test_cli_ctu16_matches_jax_cli(tmp_path):
    """-cu_size 16 -performance_mode 3 through the port's CLI writes the JAX
    CLI's .265 and -o-raw bytes and per-frame lines; the JAX CLI's own
    stream drifts in libde265 from its -o-raw file (fault 2)."""
    name = "cli_fastest16_small"
    entry = _fixture()["cli"][name]
    yuv, out, raw = (str(tmp_path / f) for f in ("in.yuv", "out.265",
                                                 "rec.yuv"))
    fx.write_cli_input(name, yuv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = app.main(fx.cli_argv(name, yuv, out, raw) + ["-device", "cpu"])
    assert rc == 0
    rec = fx.cli_record(buf.getvalue(), out, raw)
    for k in ("stream", "raw", "lines", "frames", "tail"):
        assert rec[k] == entry[k], k
    assert entry["decode"] is None or not entry["decode"]["match"]
