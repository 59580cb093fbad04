"""The IDR and the B stage in bands of CTU rows (homerhevc_tpu_torch/
parallel/intra_bands.py, sharded.b_frame_bands, the loop filter of an IDR
through sharded.band_loop_filter) against the single-device functions of
the port, on meshes that name the CPU several times; the B stage also
against the JAX package's b_frame_device.

  * pass A in bands equals intra_torch._open_loop_maps on every map, in
    rd_mode 0, 1 and 2, with and without the TU split, in bands of 2, 1, 1,
    1 CTU rows and of one CTU row; its halo (OPEN_LOOP_HALO) is the least:
    one row fewer above, or below, changes a map;
  * the wavefront in bands equals encode_frame_intra on every output, the
    wire included: the fixed-CU IDR at B 32 and 64, the split-RDO IDR at
    CTU 32 and 64 in every rd_mode with tu_depth 0 and 1, and a mesh of
    one band; a row handoff taken one diagonal too early changes it;
  * the IDR's loop filter in bands (deblocking with the intra bS maps, SAO
    with the I slice's derivation) equals the whole-frame filter, and the
    deblocking halos of ops/deblock.py are still the least for the intra
    bS maps;
  * the B stage in bands equals b_frame_device on every output and the
    wire: search 8, 16 and 64 (the hierarchical search, bands shorter than
    its 72-row halo) and a padded picture (120x88: the visible mask of the
    bottom band), and the JAX package's b_frame_device at search 16.

No split-RDO IDR of the JAX package is compiled here: the port's
single-device IDR is held to it by tests/test_torch_intra_split.py and the
fixture. Tolerance: exact (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu.pipeline import b_jax
from homerhevc_tpu_torch import tables
from homerhevc_tpu_torch.ops import deblock as dbk
from homerhevc_tpu_torch.ops import intra as intra_ops
from homerhevc_tpu_torch.ops import sao as sao_ops
from homerhevc_tpu_torch.parallel import intra_bands, sharded
from homerhevc_tpu_torch.pipeline import b_torch, intra_torch, p_torch
from homerhevc_tpu_torch.utils import fixtures as fx
from homerhevc_tpu_torch.utils.synth import synth_clip
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

QP = 32
QP_C = int(tables.chroma_qp_from_luma(QP))


def _frame(W, H, seed=5):
    return tuple(torch.as_tensor(p) for p in fx.intra_frame(W, H, seed))


def _pass_a(y, rd, tu, devs=None):
    """Pass A of the whole frame, or in bands of CTU rows on `devs` (the
    bands' maps joined)."""
    qp = torch.tensor(QP, dtype=torch.int32)
    if devs is None:
        return intra_torch._open_loop_maps(
            y, B=32, qp=qp, lam_fx=torch.as_tensor(tables.LAMBDA_FX)[qp],
            strong_smoothing=True, rd_mode=rd, tu_split=tu)
    rows, devs = sharded.band_rows(devs, y.shape[0], 32)
    parts = intra_bands.open_loop_maps_bands(
        y, rows, devs, qp=QP, strong_smoothing=True, rd_mode=rd,
        tu_split=tu)
    return tuple(torch.cat([p[k] for p in parts]) for k in range(4))


@pytest.mark.parametrize("bands", [4, 5], ids=["rows_2111", "rows_1"])
@pytest.mark.parametrize("tu", [False, True], ids=["tu0", "tu1"])
@pytest.mark.parametrize("rd", [0, 1, 2])
def test_open_loop_maps_in_bands_equal_whole_frame(rd, tu, bands):
    y = _frame(64, 160)[0]                    # 5 CTU rows
    want = _pass_a(y, rd, tu)
    got = _pass_a(y, rd, tu, ["cpu"] * bands)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k
    assert int(want[1].max()) == 2            # the quadtree splits to 8x8


def _halo_plane():
    """A made-up 128x64 luma plane on which pass A reads the last sample of
    a left column 32 rows below its band: smooth ramps; in column 31, rows
    0-62 noisy and row 63 set so that the strong smoothing of the 32x32
    block right of it (rows 0-31) is on, off with row 62 in its place; that
    block is the planar prediction from the smoothed references, so planar
    wins it only where the band reads row 63."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:128, :64]
    y = 100 + yy // 4 + xx // 8 + rng.integers(-1, 2, (128, 64))
    col = y[:64, 31]
    col[:63] += rng.integers(-25, 26, 63)
    col[63] = 2 * col[31] - col[0]      # |l[0] + l[63] - 2 l[31]| < 8
    col[62] = col[63] + 40
    y = torch.as_tensor(np.clip(y, 0, 255).astype(np.int32))
    left = y[:64, 31][None]
    refs = intra_ops.prepare_refs(
        left[:, :1].expand(1, 64), left, left[:, 0], torch.tensor([True]),
        torch.tensor([False]), size=32, c_idx=0, strong_smoothing=True)
    y[:32, 32:] = intra_ops.predict_one_mode(*refs, torch.tensor([0]),
                                             size=32, c_idx=0)[0]
    return y.to(torch.uint8)


@pytest.mark.parametrize("halo", [(1, 32), (0, 32), (1, 31)])
def test_open_loop_halo_is_the_least(halo, monkeypatch):
    """With OPEN_LOOP_HALO the bands' maps equal the whole frame's; with
    one row fewer above or below, a map differs."""
    assert intra_bands.OPEN_LOOP_HALO == (1, 32)
    y = _halo_plane()
    want = _pass_a(y, 1, True)
    monkeypatch.setattr(intra_bands, "OPEN_LOOP_HALO", halo)
    got = _pass_a(y, 1, True, ["cpu"] * 4)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    assert same == (halo == (1, 32))


# (width, height, B, split_rdo, rd_mode, tu_depth, bands, intra_frame seed)
IDR_CASES = {
    "fixed_b32": (96, 160, 32, False, 1, 0, 4, 5),
    "fixed_b64": (128, 192, 64, False, 2, 0, 4, 5),
    **{f"split{B}_rd{rd}_tu{tu}": (64, 160, B, True, rd, tu, 4, 5)
       if B == 32 else (128, 128, B, True, rd, tu, 2, 5)
       for B in (32, 64) for rd in (0, 1, 2) for tu in (0, 1)},
    "one_band": (64, 128, 32, True, 1, 1, 1, 5),
}
# the loop filter's: frames on which SAO filters some CTUs
FILTER_CASES = {
    "fixed_b32": IDR_CASES["fixed_b32"],
    "split32_rd1_tu1": (96, 160, 32, True, 1, 1, 4, 3),
    "split32_rd2_tu0": (96, 160, 32, True, 2, 0, 4, 3),
    "split64_rd1_tu1": IDR_CASES["split64_rd1_tu1"],
}


def _idr(spec, devs=None, **kw):
    W, H, B, split, rd, tu, _, seed = spec
    y, u, v = _frame(W, H, seed)
    args = dict(B=B, qp=QP, sign_hiding=True, split_rdo=split, rd_mode=rd,
                tu_depth=tu)
    if devs is None:
        return intra_torch.encode_frame_intra(y, u, v, **args), (y, u, v)
    return intra_bands.intra_frame_bands(devs, y, u, v, **args, **kw), None


@pytest.mark.parametrize("case", list(IDR_CASES))
def test_intra_wavefront_in_bands_equals_single_device(case):
    spec = IDR_CASES[case]
    want, _ = _idr(spec)
    got, _ = _idr(spec, ["cpu"] * spec[6])
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if case.startswith("split64"):
        # band edges at CTU-row edges of 64, each CTU's 32-blocks in
        # z-order; the decided trees split
        assert int(want["depth_units"].max()) == 2


def test_row_handoff_one_diagonal_early_changes_the_output(monkeypatch):
    """The band above's row as it stood before diagonal d-1 (what a handoff
    one diagonal too early gives) changes the coded frame."""
    spec = IDR_CASES["split32_rd1_tu1"]
    want, _ = _idr(spec)
    stale = {}

    def early(above, below):
        key = id(below)
        row = stale.get(key, torch.zeros_like(below.bot_rows[0]))
        stale[key] = above.bot_rows[-1].clone()
        below.bot_rows[0].copy_(row)

    monkeypatch.setattr(intra_bands, "hand_off", early)
    got, _ = _idr(spec, ["cpu"] * 4)
    assert stale
    assert not torch.equal(got["recon_y"], want["recon_y"])
    assert not torch.equal(got["wire"], want["wire"])


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_intra_loop_filter_in_bands_equals_whole_frame(case):
    spec = FILTER_CASES[case]
    B, tu, nb = spec[2], spec[5], spec[6]
    want, planes = _idr(spec)
    fy = p_torch.deblock_intra_device(
        want["recon_y"], want["recon_u"], want["recon_v"], qp=QP,
        depth_units=want["depth_units"],
        trd_units=want["trd_units"] if tu else None)
    info, filt = sao_ops.sao_stage_device(planes, fy, B, QP, QP_C)
    dbk_only, _ = _idr(spec, ["cpu"] * nb, deblock=True)
    for k, f in zip("yuv", fy):
        assert torch.equal(dbk_only[f"ref_{k}"], f), k
    got, _ = _idr(spec, ["cpu"] * nb, deblock=True, sao=True)
    for k, f in zip("yuv", filt):
        assert torch.equal(got[f"ref_{k}"], f), k
    for comp in ("luma", "cb", "cr"):
        for k in info[comp]:
            np.testing.assert_array_equal(np.asarray(got["sao_info"][comp][k]),
                                          np.asarray(info[comp][k]))
    np.testing.assert_array_equal(got["sao_info"]["merge_left"],
                                  info["merge_left"])
    np.testing.assert_array_equal(got["sao_info"]["merge_up"],
                                  info["merge_up"])
    assert any(info[c]["type"].any() for c in ("luma", "cb", "cr"))


def _intra_filter_inputs(H, W, seed):
    """Made-up IDR outputs for its loop filter: pre-deblock planes of
    smooth ramps with a step per 8x8 block, random CU depths per 8x8 block
    (relative to 32-blocks) and TU splits per 16x16."""
    rng = np.random.default_rng(seed)

    def up(a, k):
        return np.repeat(np.repeat(a, k, 0), k, 1)

    def plane(h, w):
        yy, xx = np.mgrid[:h, :w]
        steps = up(rng.integers(-9, 10, (h // 8, w // 8)), 8)
        return torch.as_tensor(np.clip(100 + yy // 3 + xx // 4 + steps, 0,
                                       255).astype(np.int32))

    depth = up(rng.integers(0, 3, (H // 8, W // 8)), 2)
    return dict(recon_y=plane(H, W), recon_u=plane(H // 2, W // 2),
                recon_v=plane(H // 2, W // 2),
                depth_units=torch.as_tensor(depth.astype(np.int32)),
                trd_units=torch.as_tensor(
                    up(rng.random((H // 16, W // 16)) < 0.3, 4)
                    .astype(np.int32)))


@pytest.mark.parametrize("halos", [
    (dbk.HALO_Y, dbk.HALO_C, dbk.HALO_UNITS),
    (dbk.HALO_Y - 1, dbk.HALO_C, dbk.HALO_UNITS),
    (dbk.HALO_Y, dbk.HALO_C - 1, dbk.HALO_UNITS),
    (dbk.HALO_Y, dbk.HALO_C, (dbk.HALO_UNITS[0] - 1, dbk.HALO_UNITS[1])),
    (dbk.HALO_Y, dbk.HALO_C, (dbk.HALO_UNITS[0], dbk.HALO_UNITS[1] - 1)),
])
def test_intra_deblocking_halo_is_the_least(halos, monkeypatch):
    """With the halos of ops/deblock.py the bands' rows of the IDR's
    deblocking filter equal the whole frame's (deblock_intra_device), on
    made-up planes and depth / TU-split maps; with one row fewer of any
    halo they do not."""
    H, W = 192, 128
    rows = [64, 32, 64, 32]
    whole = _intra_filter_inputs(H, W, 3)
    want = p_torch.deblock_intra_device(
        whole["recon_y"], whole["recon_u"], whole["recon_v"], qp=QP,
        depth_units=whole["depth_units"], trd_units=whole["trd_units"])
    cuts = np.cumsum([0] + rows)
    outs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        outs.append({k: t[a // s:b // s] for k, t, s in (
            (k, t, 1 if k == "recon_y" else 2 if k.startswith("recon")
             else 4) for k, t in whole.items())})
    hy, hc, hu = halos
    monkeypatch.setattr(dbk, "HALO_Y", hy)
    monkeypatch.setattr(dbk, "HALO_C", hc)
    monkeypatch.setattr(dbk, "HALO_UNITS", hu)
    got, _ = sharded.band_loop_filter([None] * 4, outs, ctu=32, qp=QP,
                                      deblock=True, sao=False, intra=True)
    got = [torch.cat([g[k] for g in got]).to(torch.uint8) for k in range(3)]
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    assert same == (halos == (4, 2, (2, 1)))


# (width, height, search, visible (height, width) or None, bands)
B_CASES = {
    "s8": (128, 160, 8, None, 4),
    "s16": (128, 160, 16, None, 4),
    "s64_hier": (128, 160, 64, None, 4),
    "padded_120x88": (128, 96, 16, (88, 120), 3),
}


def _b_inputs(case, seed=2):
    W, H, search, vis, nb = B_CASES[case]
    f0, f1, f2 = synth_clip(W, H, 3, seed=seed)
    if vis is not None:                         # the session pads the frame
        f0, f1, f2 = (tuple(np.pad(p[:vis[0] >> (k > 0), :vis[1] >> (k > 0)],
                                   ((0, (H - vis[0]) >> (k > 0)),
                                    (0, (W - vis[1]) >> (k > 0))),
                                   mode="edge") for k, p in enumerate(f))
                      for f in (f0, f1, f2))
    planes = [torch.as_tensor(p) for p in f1 + f0 + f2]
    kw = dict(B=32, qp=QP + 2, search=search, me_precision=2,
              sign_hiding=True, vis=vis, kernels=False)
    return planes, kw, nb


@pytest.mark.parametrize("case", list(B_CASES))
def test_b_stage_in_bands_equals_single_device(case):
    planes, kw, nb = _b_inputs(case)
    want = b_torch.b_frame_device(*planes, **kw)
    got = sharded.b_frame_bands(["cpu"] * nb, *planes, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    H, W = planes[0].shape
    if case == "s64_hier":
        rows, _ = sharded.band_rows(["cpu"] * nb, H, 32)
        assert min(rows) < sharded.halo_rows(kw["search"])
        assert kw["search"] > p_torch.HIER_THRESHOLD
    if case == "s64_hier":                     # every prediction direction
        assert set(np.unique(want["idc"].numpy())) == {0, 1, 2}


def test_b_stage_in_bands_equals_jax():
    planes, kw, nb = _b_inputs("s16")
    kw_j = {k: v for k, v in kw.items() if k != "kernels"}
    want = b_jax.b_frame_device(*(jnp.asarray(p.numpy()) for p in planes),
                                **kw_j)
    got = sharded.b_frame_bands(["cpu"] * nb, *planes, **kw)
    for k in ("idc", "mv0", "mv1", "lev_y", "lev_u", "lev_v", "rec_y",
              "rec_u", "rec_v"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
