"""The port's own copies of the host modules against the JAX package's
originals, from seeded numpy inputs (numpy only plus the two packages).

  tables                 every public table and table function equal
  config                 EncoderConfig(**kw).validate() field for field
  entropy.headers        VPS/SPS/PPS and slice header bytes equal
  pipeline.assemble      assemble_{idr,p}_au_from_maps bytes equal on random
                         maps at 64x64 and 128x96
  entropy.native_backend the port's libhenc against the Python CABAC oracle
                         inside the port (and the JAX package's bytes)
  ops.sao_host           derive_all_from_stats equal
  ops.inter_golden       derive_block_decisions_fast equal; the port's
                         Python walk equal to it and to libhenc's
  api                    _tree_decisions, _pad_to, SCENE_SAD_PER_PIXEL equal;
                         HomerEncoder raises TypeError on the other
                         package's config
  utils.synth, ops.interp, PAD equal
  rate_control           RateControl's methods the same source
  ops.inter_b            B merge and AMVP candidate lists, MV scaling and
                         boundary strengths equal on random motion fields
  explicit P frames      the session's fixed-CU host half (wire, fast
                         decisions, native maps, rps 2) writes the AU of
                         the JAX package's build_p_plans + assemble_p_au
  pipeline.b_golden      build_b_plans' plans give the same B-slice AU
                         bytes in both packages
  utils.yuv, utils.psnr, the same source, function for function, and the
  utils.profiler,        same results: YUV frames written and read back,
  api.write_annex_b      edge padding, PSNR (int64 differences, 100.0 at
                         MSE 0), the profiler's report

Tolerance: exact (integers and bytes).
"""

import dataclasses

import numpy as np
import pytest
import torch

import homerhevc_tpu.api as japi
import homerhevc_tpu.config as jconfig
import homerhevc_tpu.tables as jtables
from homerhevc_tpu.entropy import headers as jheaders
from homerhevc_tpu.entropy import native_backend as jnative
from homerhevc_tpu.ops import inter_golden as jinter
from homerhevc_tpu.ops import interp as jinterp
from homerhevc_tpu.ops import sao as jsao
from homerhevc_tpu.pipeline import assemble as jassemble
from homerhevc_tpu.pipeline import intra_golden, p_golden
from homerhevc_tpu.utils.synth import synth_clip as jsynth_clip

import homerhevc_tpu_torch.api as tapi
import homerhevc_tpu_torch.config as tconfig
import homerhevc_tpu_torch.tables as ttables
from homerhevc_tpu_torch.entropy import headers as theaders
from homerhevc_tpu_torch.entropy import native_backend as tnative
from homerhevc_tpu_torch.ops import inter_golden as tinter
from homerhevc_tpu_torch.ops import interp as tinterp
from homerhevc_tpu_torch.ops import sao_host as tsao
from homerhevc_tpu_torch.pipeline import assemble as tassemble
from homerhevc_tpu_torch.pipeline import p_chunk as tchunk
from homerhevc_tpu_torch.pipeline import p_torch
from homerhevc_tpu_torch.utils.synth import synth_clip as tsynth_clip


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

TABLE_NAMES = sorted(
    n for n in vars(jtables)
    if not n.startswith("_") and isinstance(getattr(jtables, n),
                                            (np.ndarray, int)))
TABLE_CALLS = {
    "dct_matrix": [(4,), (8,), (16,), (32,)],
    "scan_order": [(s, k) for s in (2, 4, 8) for k in (0, 1, 2)],
    "coeff_scan": [(lg, k) for lg in (2, 3, 4, 5) for k in (0, 1, 2)],
    "scan_mode_for_intra": [(lg, m, c) for lg in (2, 3, 4)
                            for m in (0, 1, 6, 10, 14, 22, 26, 30, 34)
                            for c in (0, 1)],
    "fwd_transform_shifts": [(2,), (3,), (4,), (5,)],
    "inv_transform_shifts": [()],
    "chroma_qp_from_luma": [(np.arange(-6, 58),), (29,), (35,), (51,)],
    "zscan_to_raster": [(1,), (3,), (4,)],
    "raster_to_zscan": [(1,), (3,), (4,)],
}


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_table_constants_equal(name):
    want, got = getattr(jtables, name), getattr(ttables, name)
    assert want is not got or isinstance(want, int)   # a copy, not a re-export
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("name", sorted(TABLE_CALLS))
def test_table_functions_equal(name):
    for args in TABLE_CALLS[name]:
        want = getattr(jtables, name)(*args)
        got = getattr(ttables, name)(*args)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=f"{name}{args}")


@pytest.mark.parametrize("n", [4, 8, 32])
def test_level_bits_est_equal(n):
    rng = np.random.default_rng(n)
    lev = rng.integers(-40, 41, (5, n, n)) * (rng.random((5, n, n)) < 0.2)
    np.testing.assert_array_equal(ttables.level_bits_est(lev),
                                  jtables.level_bits_est(lev))


def test_every_public_table_name_is_copied():
    public = {n for n in vars(jtables) if not n.startswith("_")
              and getattr(getattr(jtables, n), "__module__",
                          jtables.__name__) == jtables.__name__
              and n not in ("annotations", "functools", "np")}
    assert public <= set(vars(ttables)), public - set(vars(ttables))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

CONFIG_CASES = {
    "defaults": dict(width=1280, height=720),
    "slice": dict(width=128, height=96, qp=32, cu_size=32, intra_period=100,
                  me_search_range=16, sign_hiding=True, deblocking=True,
                  sample_adaptive_offset=True, frame_pipeline_depth=2,
                  performance_mode="FASTEST_COMPUTATION"),
    "odd size": dict(width=130, height=98, qp=60, cu_size=16,
                     me_search_range=5),
    "cbr": dict(width=640, height=360, bitrate_mode="CBR", bitrate=900,
                rd_mode="FAST", gop_size=2, wpp=True),
    "odd width": dict(width=641, height=360),                # refused
    "bad cu": dict(width=640, height=360, cu_size=48),       # refused
    "bad search": dict(width=640, height=360, me_search_range=30),  # refused
}
ENUM_FIELDS = {"performance_mode": "PerformanceMode", "rd_mode": "RDMode",
               "bitrate_mode": "BitrateMode", "profile": "Profile"}


def _config(mod, kw):
    kw = {k: (getattr(mod, ENUM_FIELDS[k])[v] if k in ENUM_FIELDS else v)
          for k, v in kw.items()}
    return mod.EncoderConfig(**kw)


def _plain(cfg):
    return {k: (v.name if hasattr(v, "name") else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_validate_equal(case):
    kw = CONFIG_CASES[case]
    try:
        want = _config(jconfig, kw).validate()
    except Exception as e:                     # both must refuse alike
        with pytest.raises(type(e)):
            _config(tconfig, kw).validate()
        return
    got = _config(tconfig, kw).validate()
    assert _plain(got) == _plain(want)
    for prop in ("ctu_size", "padded_width", "padded_height"):
        assert getattr(got, prop) == getattr(want, prop)


def test_config_fields_and_enums_equal():
    assert ([f.name for f in dataclasses.fields(tconfig.EncoderConfig)]
            == [f.name for f in dataclasses.fields(jconfig.EncoderConfig)])
    for enum in set(ENUM_FIELDS.values()):
        assert ({m.name: m.value for m in getattr(tconfig, enum)}
                == {m.name: m.value for m in getattr(jconfig, enum)})


def test_encoder_refuses_other_packages_config():
    kw = CONFIG_CASES["slice"]
    with pytest.raises(TypeError, match="EncoderConfig"):
        tapi.HomerEncoder(_config(jconfig, kw), device="cpu")
    tapi.HomerEncoder(_config(tconfig, kw), device="cpu").close()


# ---------------------------------------------------------------------------
# headers + AU assembly from random maps
# ---------------------------------------------------------------------------

def _params(mod, w, h, qp=32, **kw):
    return mod.StreamParams(
        width=w, height=h, ctu_log2=5, min_cu_log2=5, max_tu_log2=5,
        max_tr_depth_intra=0, max_tr_depth_inter=0, init_qp=qp,
        sign_hiding=True, deblocking_disabled=False, **kw)


@pytest.mark.parametrize("size", [(64, 64), (128, 96), (1280, 720)])
def test_header_bytes_equal(size):
    w, h = size
    pj = _params(jheaders, w, h, sao_enabled=True, pad_bottom=(-h) % 32)
    pt = _params(theaders, w, h, sao_enabled=True, pad_bottom=(-h) % 32)
    for fn in ("write_vps", "write_sps", "write_pps"):
        assert getattr(theaders, fn)(pt) == getattr(jheaders, fn)(pj), fn
    for st, idr in ((jheaders.SLICE_I, True), (jheaders.SLICE_P, False)):
        kw = dict(slice_type=st, is_idr=idr, is_irap=idr, poc=0 if idr else 3,
                  slice_qp=30, sao_luma=True, sao_chroma=True)
        assert (theaders.write_slice_header(pt, **kw).get_bytes()
                == jheaders.write_slice_header(pj, **kw).get_bytes())


def _random_levels(rng, shape, density):
    lev = rng.integers(-300, 301, shape).astype(np.int32)
    return lev * (rng.random(shape) < density)


def _random_sao(rng, nby, nbx, mod, qp):
    st = []
    for _ in range(3):
        st.append((rng.integers(0, 200, (4, 4, nby, nbx)),
                   rng.integers(-900, 900, (4, 4, nby, nbx)),
                   rng.integers(0, 200, (32, nby, nbx)),
                   rng.integers(-900, 900, (32, nby, nbx))))
    luma, cb, cr, ml, mu = mod.derive_all_from_stats(
        *st, qp, int(jtables.chroma_qp_from_luma(qp)), slice_p=True)
    return dict(luma=luma, cb=cb, cr=cr, merge_left=ml, merge_up=mu,
                sao_luma=True, sao_chroma=True)


@pytest.mark.parametrize("kind", ["idr", "p", "p_dqp_wpp"])
@pytest.mark.parametrize("size", [(64, 64), (128, 96)])
def test_assemble_from_random_maps_equal(size, kind):
    w, h = size
    seed = w + h + len(kind)
    aus = []
    for headers, native, assemble, inter, sao in (
            (jheaders, jnative, jassemble, jinter, jsao),
            (theaders, tnative, tassemble, tinter, tsao)):
        rng = np.random.default_rng(seed)      # the same draws for both
        # rate control's per-CTU-row QPs (cu_qp_delta) and WPP substreams
        extra = (dict(cu_qp_delta_enabled=True, wpp_enabled=True)
                 if kind == "p_dqp_wpp" else {})
        params = _params(headers, w, h, sao_enabled=True, **extra)
        nby, nbx = h // 32, w // 32
        lev = (_random_levels(rng, (h, w), 0.02),
               _random_levels(rng, (h // 2, w // 2), 0.01),
               _random_levels(rng, (h // 2, w // 2), 0.01))
        sao_info = _random_sao(rng, nby, nbx, sao, 30)
        if kind == "idr":
            modes = np.repeat(np.repeat(rng.integers(0, 35, (nby, nbx)), 8,
                                        0), 8, 1)
            maps = native.maps_from_intra_units(
                modes, np.zeros((h // 4, w // 4), np.int32), *lev)
            aus.append(assemble.assemble_idr_au_from_maps(
                params, maps, slice_qp=30, sao_info=sao_info))
        else:
            mvs = rng.integers(-40, 41, (nby, nbx, 2)).astype(np.int32)
            mvs[rng.random((nby, nbx)) < 0.4] = 0
            blk = [lv.reshape(nby, lv.shape[0] // nby, nbx,
                              lv.shape[1] // nbx).transpose(0, 2, 1, 3)
                   for lv in lev]
            has_resid = np.any(blk[0], axis=(-1, -2))
            dec, _ = inter.derive_block_decisions_fast(mvs, has_resid, 32, 5)
            maps = native.maps_from_p_arrays(mvs, dec, *blk, 32)
            if extra:
                maps["qp_ctu"] = np.repeat(rng.integers(
                    24, 40, (nby, 1)), nbx, 1).astype(np.int8)
            aus.append(assemble.assemble_p_au_from_maps(
                params, maps, poc=2, slice_qp=30, sao_info=sao_info))
    assert len(aus[0]) > 100
    assert aus[1] == aus[0]


# ---------------------------------------------------------------------------
# libhenc against the Python CABAC oracle inside the port
# ---------------------------------------------------------------------------

def _plans(kind):
    """CTU plans of a small golden encode (the JAX package's numpy golden
    pipeline makes them; the port's entropy coders read them)."""
    frames = list(jsynth_clip(96, 64, 2, 5))
    ip = intra_golden.encode_intra_frame(*frames[0], qp=30, ctu_log2=5)
    if kind == "intra":
        return ip.ctu_plans, jheaders.SLICE_I
    pp = p_golden.encode_p_frame(*frames[1], ip.recon, qp=30, ctu_log2=5,
                                 search=8)
    return pp.ctu_plans, jheaders.SLICE_P


@pytest.mark.parametrize("kind", ["intra", "p", "p_dqp_wpp"])
def test_port_libhenc_matches_port_python_oracle(kind):
    plans, slice_type = _plans(kind[:1] if kind != "intra" else kind)
    extra = {}
    if kind == "p_dqp_wpp":
        # a cu_qp_delta target per CTU row, WPP substreams
        plans = [dataclasses.replace(p, qp_ctu=27 + 4 * (p.y0 // 32))
                 for p in plans]
        extra = dict(cu_qp_delta_enabled=True, wpp_enabled=True)
    pt = dataclasses.replace(_params(theaders, 96, 64, qp=30),
                             sign_hiding=False, deblocking_disabled=True,
                             **extra)
    pj = dataclasses.replace(_params(jheaders, 96, 64, qp=30),
                             sign_hiding=False, deblocking_disabled=True,
                             **extra)
    oracle = tassemble.encode_slice_data(pt, plans, slice_qp=30,
                                         slice_type=slice_type, native=False)
    lib = tassemble.encode_slice_data(pt, plans, slice_qp=30,
                                      slice_type=slice_type)
    # with WPP: (slice data, substream sizes), two CTU rows here
    data = oracle[0] if extra else oracle
    assert len(data) > 50 and (not extra or len(oracle[1]) == 2)
    assert lib == oracle
    assert lib == jassemble.encode_slice_data(pj, plans, slice_qp=30,
                                              slice_type=slice_type)


def test_port_libhenc_is_its_own_build():
    lib = tnative.build_library()
    assert "homerhevc_tpu_torch" in lib and "_build" in lib
    assert tnative._load() is not jnative._load()


def test_scatter_levels_native_matches_numpy():
    rng = np.random.default_rng(4)
    H, W = 96, 128
    n4 = (H // 4) * (W // 4) * 3 // 2
    cnt = 200
    idx = rng.permutation(n4)[:256].astype(np.int32)
    vals = rng.integers(-500, 501, (256, 16)).astype(np.int16)
    want = tchunk.scatter_levels(idx, vals, cnt, H, W)
    got = tnative.scatter_levels_native(idx, vals, cnt, H, W)
    for a, b in zip(want, got[:3]):
        np.testing.assert_array_equal(a, b)
    nz = (np.any(want[0].reshape(H // 4, 4, W // 4, 4) != 0, axis=(1, 3))
          | np.any(want[1].reshape(H // 4, 2, W // 4, 2) != 0, axis=(1, 3))
          | np.any(want[2].reshape(H // 4, 2, W // 4, 2) != 0, axis=(1, 3)))
    np.testing.assert_array_equal(got[3], nz)


# ---------------------------------------------------------------------------
# SAO derivation, inter decisions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slice_p", [False, True])
def test_derive_all_from_stats_equal(slice_p):
    rng = np.random.default_rng(10 + slice_p)
    nby, nbx = 3, 4
    st = [(rng.integers(0, 300, (4, 4, nby, nbx)),
           rng.integers(-1500, 1500, (4, 4, nby, nbx)),
           rng.integers(0, 300, (32, nby, nbx)),
           rng.integers(-1500, 1500, (32, nby, nbx))) for _ in range(3)]
    want = jsao.derive_all_from_stats(*st, 32, 31, slice_p=slice_p)
    got = tsao.derive_all_from_stats(*st, 32, 31, slice_p=slice_p)
    for a, b in zip(want[:3], got[:3]):
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].dtype == a[k].dtype
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    assert tsao.EO_NEIGHBORS == jsao.EO_NEIGHBORS
    assert tsao.MAX_OFFSET == jsao.MAX_OFFSET


def _random_mvs(rng, nby, nbx):
    mvs = rng.integers(-67, 68, size=(nby, nbx, 2)).astype(np.int32)
    mvs[rng.random((nby, nbx)) < 0.3] = 0
    for r in range(nby):
        for c in range(1, nbx):
            if rng.random() < 0.3:
                mvs[r, c] = mvs[r, c - 1]
    for r in range(1, nby):
        for c in range(nbx):
            if rng.random() < 0.3:
                mvs[r, c] = mvs[r - 1, c]
    return mvs, rng.random((nby, nbx)) < 0.5


@pytest.mark.parametrize("shape", [(3, 4), (6, 9), (23, 40)])
def test_derive_block_decisions_fast_equal(shape):
    mvs, has_resid = _random_mvs(np.random.default_rng(sum(shape)), *shape)
    want, fw = jinter.derive_block_decisions_fast(mvs, has_resid, 32, 5)
    got, fg = tinter.derive_block_decisions_fast(mvs, has_resid, 32, 5)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(fg.mv, fw.mv)
    np.testing.assert_array_equal(fg.ref_idx, fw.ref_idx)
    if shape[0] <= 6:
        # the port's sequential Python walk on the same fixed grid (every
        # CU at depth 0 of a 32-CTU) gives the same decisions per unit
        mv_u = np.repeat(np.repeat(mvs, 8, 0), 8, 1)
        nz_u = np.repeat(np.repeat(has_resid, 8, 0), 8, 1)
        walk, _ = tinter.derive_tree_decisions(
            np.zeros(nz_u.shape, np.int32), mv_u, nz_u, 5, 5)
        for k in want:
            np.testing.assert_array_equal(walk[k][::8, ::8], want[k],
                                          err_msg=k)


def _random_tree(rng, ctu_log2, uh, uw):
    step = (1 << ctu_log2) // 4
    depth = np.zeros((uh, uw), np.int32)
    for r in range(0, uh, step):
        for c in range(0, uw, step):
            d = int(rng.integers(0, 3))
            depth[r:r + step, c:c + step] = d
            if d >= 1:                 # one quadrant split one level deeper
                h = step // 2
                q = int(rng.integers(0, 4))
                ro, co = r + (q // 2) * h, c + (q % 2) * h
                depth[ro:ro + h, co:co + h] = d + int(rng.integers(0, 2))
    mv = rng.integers(-32, 33, (uh, uw, 2)).astype(np.int32)
    mv = np.repeat(np.repeat(mv[::4, ::4], 4, 0), 4, 1)[:uh, :uw]
    return depth, mv, rng.random((uh, uw)) < 0.4


@pytest.mark.parametrize("ctu_log2,units", [(5, (24, 32)), (6, (32, 48))])
def test_tree_decisions_equal(ctu_log2, units):
    depth, mv, nz = _random_tree(np.random.default_rng(7), ctu_log2, *units)
    want = japi._tree_decisions(depth, mv, nz, ctu_log2, 5)
    got = tapi._tree_decisions(depth, mv, nz, ctu_log2, 5)
    walk, _ = tinter.derive_tree_decisions(depth, mv, nz, ctu_log2, 5)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(walk[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

def test_small_constants_equal():
    from homerhevc_tpu.pipeline.p_golden import PAD
    assert p_torch.PAD == PAD
    assert tapi.SCENE_SAD_PER_PIXEL == japi.SCENE_SAD_PER_PIXEL
    np.testing.assert_array_equal(tinterp.LUMA_FILTERS, jinterp.LUMA_FILTERS)
    np.testing.assert_array_equal(tinterp.CHROMA_FILTERS,
                                  jinterp.CHROMA_FILTERS)
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    np.testing.assert_array_equal(tapi._pad_to(a, 5, 8), japi._pad_to(a, 5, 8))
    assert tapi._pad_to(a, 3, 4) is a


def test_synth_clip_equal():
    for want, got in zip(jsynth_clip(128, 96, 3, seed=3),
                         tsynth_clip(128, 96, 3, seed=3)):
        for p, q in zip(want, got):
            np.testing.assert_array_equal(q, p)


# ---------------------------------------------------------------------------
# rate_control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["__init__", "frame_target", "frame_qp",
                                    "end_frame", "plan_rows",
                                    "on_scene_change"])
def test_rate_control_is_a_copy(method):
    # the same code, line for line, in the port's own module (its behaviour
    # against the original over 200 frames: tests/test_torch_rc.py)
    import inspect

    from homerhevc_tpu import rate_control as jrc
    from homerhevc_tpu_torch import rate_control as trc
    assert trc.RateControl is not jrc.RateControl
    assert inspect.getsource(getattr(trc.RateControl, method)) == \
        inspect.getsource(getattr(jrc.RateControl, method))


# ---------------------------------------------------------------------------
# the host halves of explicit P and B frames
# ---------------------------------------------------------------------------

def _random_b_field(mod, rng, uh, uw):
    fld = mod.BMotionField(uh, uw)
    for y in range(0, uh * 4, 16):
        for x in range(0, uw * 4, 16):
            if rng.random() < 0.2:
                continue                    # left unavailable
            d = int(rng.integers(0, 3))
            mv0 = tuple(int(v) for v in rng.integers(-40, 41, 2))
            mv1 = tuple(int(v) for v in rng.integers(-40, 41, 2))
            fld.set_cu(x, y, 16, mod.BMotion(d != 1, d != 0,
                                             mv0 if d != 1 else (0, 0),
                                             mv1 if d != 0 else (0, 0)))
    return fld


def test_inter_b_candidates_equal():
    from homerhevc_tpu.ops import inter_b as jb
    from homerhevc_tpu_torch.ops import inter_b as tb
    for seed in range(3):
        fj = _random_b_field(jb, np.random.default_rng(seed), 16, 24)
        ft = _random_b_field(tb, np.random.default_rng(seed), 16, 24)
        for x0, y0, size in ((16, 16, 16), (32, 0, 32), (48, 32, 16),
                             (0, 48, 16)):
            want = [c.key() for c in jb.merge_candidates_b(fj, x0, y0, size)]
            got = [c.key() for c in tb.merge_candidates_b(ft, x0, y0, size)]
            assert got == want
            for lst in (0, 1):
                assert (tb.amvp_candidates_b(ft, x0, y0, size, lst, 3, (2, 4))
                        == jb.amvp_candidates_b(fj, x0, y0, size, lst, 3,
                                                (2, 4)))
        cbf = np.random.default_rng(seed).random((16, 24)) < 0.3
        for a, b in zip(jb.inter_bs_maps_b(fj, 16, cbf),
                        tb.inter_bs_maps_b(ft, 16, cbf)):
            np.testing.assert_array_equal(b, a)
    for mv, tb_, td in (((17, -9), 1, 2), ((-300, 41), -1, 1), ((5, 5), 2,
                                                                -1)):
        assert tb.scale_mv(mv, tb_, td) == jb.scale_mv(mv, tb_, td)


def _ibp_params(headers, w, h, wpp):
    """Stream parameters of an IBP session (the three-entry RPS list)."""
    return _params(headers, w, h, qp=30, num_ref_frames=2, num_reorder_pics=1,
                   wpp_enabled=wpp,
                   rps_list=(headers.StRefPicSet(delta_pocs=(2,),
                                                 used=(True,)),
                             headers.StRefPicSet(delta_pocs=(1,),
                                                 used=(True,),
                                                 pos_delta_pocs=(1,),
                                                 pos_used=(True,)),
                             headers.StRefPicSet(delta_pocs=(1,),
                                                 used=(True,))))


@pytest.mark.parametrize("wpp", [False, True])
@pytest.mark.parametrize("shape", [(2, 3), (4, 5)])
def test_explicit_p_host_half_matches_build_p_plans(shape, wpp):
    """An explicit P frame (trailing, or before a scheduled IDR) goes
    through the fixed-CU path's host half; from the same device arrays it
    writes the AU that the JAX package's build_p_plans + assemble_p_au
    write with rps 2."""
    nby, nbx = shape
    rng = np.random.default_rng(10 * nby + nbx + wpp)
    mvs = _random_mvs(rng, nby, nbx)[0]
    lev = [_random_levels(rng, (nby, nbx, n, n), d).astype(np.int16)
           for n, d in ((32, 0.02), (16, 0.01), (16, 0.01))]
    sad = rng.integers(0, 99999, (nby, nbx)).astype(np.int32)
    meta = np.concatenate([mvs.reshape(-1), sad.reshape(-1)]).astype(np.int32)
    wire = torch.from_numpy(np.concatenate(
        [lv.reshape(-1) for lv in lev] + [meta.view(np.int16)]))
    cfg = tconfig.EncoderConfig(
        width=32 * nbx, height=32 * nby, qp=30, cu_size=32, gop_size=2,
        wpp=wpp, sign_hiding=True,
        performance_mode=tconfig.PerformanceMode.FASTEST_COMPUTATION)
    enc = tapi.HomerEncoder(cfg, device="cpu")
    got_mvs, got_sad, got_lev = enc._fixed_p_fetch(wire, 32, "p_expl")
    maps = enc._fixed_p_maps(got_mvs, got_lev, 32, "p_expl")
    np.testing.assert_array_equal(got_sad, sad)
    got = tassemble.assemble_p_au_from_maps(
        _ibp_params(theaders, 32 * nbx, 32 * nby, wpp), maps, poc=3,
        slice_qp=30, rps_idx=2)
    plan = p_golden.build_p_plans(mvs, *(lv.astype(np.int32) for lv in lev),
                                  (None, None, None), size=32)
    assert any(bool(p.merge_flag[0, 0]) for p in plan.ctu_plans)
    want = jassemble.assemble_p_au(
        _ibp_params(jheaders, 32 * nbx, 32 * nby, wpp), plan.ctu_plans,
        poc=3, slice_qp=30, rps_idx=2)
    assert len(want) > 50 and got == want


@pytest.mark.parametrize("wpp", [False, True])
def test_build_b_plans_b_slice_bytes_equal(wpp):
    from homerhevc_tpu.pipeline import b_golden as jbg
    from homerhevc_tpu_torch.pipeline import b_golden as tbg
    nby, nbx = 3, 4
    rng = np.random.default_rng(40 + wpp)
    idc = rng.integers(0, 3, (nby, nbx)).astype(np.int32)
    mv0 = _random_mvs(rng, nby, nbx)[0]
    mv1 = _random_mvs(rng, nby, nbx)[0]
    mv0[idc == 1] = 0
    mv1[idc == 0] = 0
    lev = [_random_levels(rng, (nby, nbx, n, n), d)
           for n, d in ((32, 0.02), (16, 0.01), (16, 0.01))]
    kw = dict(size=32, poc=1, poc_refs=(0, 2))
    aus = []
    for headers, assemble, bg in ((jheaders, jassemble, jbg),
                                  (theaders, tassemble, tbg)):
        plan = bg.build_b_plans(idc, mv0, mv1, *lev, (None, None, None), **kw)
        aus.append(assemble.assemble_p_au(
            _ibp_params(headers, 32 * nbx, 32 * nby, wpp), plan.ctu_plans,
            poc=1, slice_qp=32, slice_type=headers.SLICE_B, rps_idx=1))
    assert len(aus[0]) > 50 and aus[1] == aus[0]


# ---------------------------------------------------------------------------
# utils.yuv, utils.psnr, utils.profiler, api.write_annex_b
# ---------------------------------------------------------------------------

COPIED_FUNCTIONS = [
    ("utils.yuv", "frame_size_bytes"), ("utils.yuv", "read_yuv_frame"),
    ("utils.yuv", "write_yuv_frame"), ("utils.yuv", "pad_to_ctu"),
    ("utils.psnr", "psnr"), ("utils.psnr", "yuv_psnr"),
    ("utils.profiler", "Profiler"), ("api", "write_annex_b")]


@pytest.mark.parametrize("module,name", COPIED_FUNCTIONS)
def test_session_utils_are_copies(module, name):
    import importlib
    import inspect
    want = getattr(importlib.import_module("homerhevc_tpu." + module), name)
    got = getattr(importlib.import_module("homerhevc_tpu_torch." + module),
                  name)
    assert got is not want
    assert inspect.getsource(got) == inspect.getsource(want)


def test_yuv_io_equal():
    import io

    from homerhevc_tpu.utils import yuv as jyuv
    from homerhevc_tpu_torch.utils import yuv as tyuv
    rng = np.random.default_rng(11)
    frames = [tuple(rng.integers(0, 256, s, dtype=np.uint8)
                    for s in ((22, 30), (11, 15), (11, 15))) for _ in range(3)]
    bufs = []
    for mod in (jyuv, tyuv):
        f = io.BytesIO()
        for fr in frames:
            mod.write_yuv_frame(f, *fr)
        bufs.append(f.getvalue())
    assert bufs[0] == bufs[1]
    assert len(bufs[0]) == 3 * tyuv.frame_size_bytes(30, 22)
    f = io.BytesIO(bufs[1][:-7])                    # the last frame cut short
    for fr in frames[:2]:
        for p, q in zip(fr, tyuv.read_yuv_frame(f, 30, 22)):
            np.testing.assert_array_equal(q, p)
    assert tyuv.read_yuv_frame(f, 30, 22) is None
    for h, w in ((22, 30), (32, 32), (24, 40)):
        np.testing.assert_array_equal(tyuv.pad_to_ctu(frames[0][0], h, w),
                                      jyuv.pad_to_ctu(frames[0][0], h, w))


def test_psnr_equal():
    from homerhevc_tpu.utils import psnr as jpsnr
    from homerhevc_tpu_torch.utils import psnr as tpsnr
    rng = np.random.default_rng(12)
    a = rng.integers(0, 256, (16, 24), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-9, 10, a.shape), 0,
                255).astype(np.uint8)
    # uint8 wrap-around would corrupt the error without int64 differences
    c = np.where(a > 128, 0, 255).astype(np.uint8)
    for ref, rec in ((a, b), (a, c), (a, a)):
        assert tpsnr.psnr(ref, rec) == jpsnr.psnr(ref, rec)
    assert tpsnr.psnr(a, a) == 100.0
    assert tpsnr.psnr(a, c) < 10.0
    assert tpsnr.yuv_psnr((a, b, c), (b, b, a)) == jpsnr.yuv_psnr((a, b, c),
                                                                  (b, b, a))


def test_profiler_report_equal():
    from homerhevc_tpu.utils import profiler as jprof
    from homerhevc_tpu_torch.utils import profiler as tprof
    reports = []
    for mod in (jprof, tprof):
        assert not mod.NULL.enabled
        with mod.NULL.probe("x"):
            pass
        assert not mod.NULL.acc and mod.Profiler().report() == \
            "profiler: no samples"
        p = mod.Profiler()
        for name, t in (("p.device", 0.25), ("entropy", 0.0125),
                        ("p.device", 0.5), ("sao", 0.0)):
            p.acc[name] += t
            p.count[name] += 1
        with p.probe("upload"):
            pass
        p.acc["upload"] = 0.001
        reports.append(p.report())
    assert reports[0] == reports[1]
    assert reports[1].splitlines()[1].split()[:2] == ["p.device", "750.0"]
