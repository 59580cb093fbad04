"""Session level, quadtree configurations: the torch port's HomerEncoder
(device=cpu, plain kernel versions) with the keywords the repository's
bench.py times (FAST_COMPUTATION, search 64, QP 32, deblocking + SAO + sign
hiding) and its neighbours, against the JAX package. Tolerance: exact, byte
for byte.

  * live: homerhevc_tpu.api.HomerEncoder(backend="jax") runs in this process
    on the first four frames of the `fast_small` clip (the reference's
    split-RDO IDR stage compiles for minutes on a CPU, so this is the one
    live session); its AUs must equal the port's and the committed fixture;
  * through the fixture tests/fixtures/torch_port_aus.json (written from the
    JAX package by tools/make_torch_fixtures.py): FASTER, FAST with search
    16 (the dense front end; the clip's motion leaves that window, so frames
    inside a chunk are re-encoded as IDR), with max_inter_tr_depth=0, with
    max_intra_tr_depth=0, and at 120x88 (padded to 128x96);
  * every stream decodes in libde265 to the port's reconstruction;
  * encode_frame frame by frame equals encode_frames; seed_reference
    continues a FAST P chain; the settings still outside (FAST and FULL at
    cu_size 16 among them) raise NotImplementedError naming the setting
    (every rd_mode, B frames at cu_size 32, and FASTEST and FASTER at
    cu_size 16 are admitted).
"""

import contextlib
import dataclasses
import functools
import hashlib
import json
import os

import numpy as np
import pytest

from homerhevc_tpu_torch.api import HomerEncoder
from homerhevc_tpu_torch.config import BitrateMode, RDMode
from homerhevc_tpu_torch.utils import fixtures as fx
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")

VARIANTS = ("faster_small", "fast_s16_small", "fast_inter_tr0_small",
            "fast_intra_tr0_small", "fast_padded_small")


def _tools():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures",
        os.path.join(ROOT, "tools", "make_torch_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def _port_run(name: str):
    """(AUs, final reference planes, StreamParams) of the port for one of
    the fixture's runs."""
    enc = HomerEncoder(fx.run_config(name), device="cpu", fetch_recon=False)
    aus = enc.encode_frames(fx.clip(name), chunk=fx.RUNS[name]["chunk"])
    ref = tuple(p.numpy() for p in enc._ref)
    enc.close()
    return aus, ref, enc.params


def _is_idr(au: bytes) -> bool:
    """An IDR AU opens with its parameter sets: the first NAL is the VPS."""
    assert au[:4] == b"\x00\x00\x00\x01"
    return (au[4] >> 1) & 0x3F == 32


def _assert_decodes(name: str):
    from homerhevc_tpu_torch.validate import de265
    if not de265.available():
        pytest.skip("libde265 not available")
    aus, ref, _ = _port_run(name)
    r = fx.RUNS[name]
    dec = de265.decode_annexb(b"".join(aus))
    assert len(dec) == len(aus)
    h, w = r["height"], r["width"]
    for p, q, (ph, pw) in zip(dec[-1], ref, ((h, w), (h // 2, w // 2),
                                             (h // 2, w // 2))):
        np.testing.assert_array_equal(p, q[:ph, :pw])


# ---------------------------------------------------------------------------
def test_fast_small_matches_fixture():
    aus, _, params = _port_run("fast_small")
    assert fx.au_digest(aus) == _fixture()["fast_small"]["aus"]
    assert (params.min_cu_log2, params.max_tr_depth_intra,
            params.max_tr_depth_inter) == (3, 1, 1)
    assert _is_idr(aus[0]) and not any(_is_idr(a) for a in aus[1:])


def test_fast_small_decodes():
    _assert_decodes("fast_small")


@contextlib.contextmanager
def _no_persistent_jax_cache():
    """JAX's persistent compilation cache switched off, then as it was: a
    test worker died of a segmentation fault inside its write of the
    reference's split-RDO IDR executable."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()     # the setting is read once per reset
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        compilation_cache.reset_cache()


def test_fast_matches_live_jax():
    # IDR + one chunk of 3: one compile of the reference's IDR stage and one
    # of its quadtree chunk (minutes on a CPU); AUs do not depend on how a
    # clip is cut into chunks, so these are the fixture's first four
    tools = _tools()
    r = fx.RUNS["fast_small"]
    with _no_persistent_jax_cache():
        want = tools.jax_encode(fx.run_kwargs("fast_small"),
                                fx.clip("fast_small")[:4], r["chunk"])
    assert fx.au_digest(want) == _fixture()["fast_small"]["aus"][:4]
    got = _port_run("fast_small")[0][:4]
    for k, (a, b) in enumerate(zip(want, got)):
        assert a == b, f"AU {k} differs: {len(a)} vs {len(b)} bytes"


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_matches_fixture(name):
    entry = _fixture()[name]
    assert {k: entry[k] for k in fx.RUNS[name]} == fx.RUNS[name]
    aus, _, params = _port_run(name)
    assert fx.au_digest(aus) == entry["aus"]
    # the setting took effect
    base = _port_run("fast_small")[0][:len(aus)]
    if name == "fast_intra_tr0_small":
        assert params.max_tr_depth_intra == 0 and aus[0] != base[0]
    else:
        assert params.max_tr_depth_intra == 1
    if name == "fast_inter_tr0_small":
        assert params.max_tr_depth_inter == 0 and aus[1:] != base[1:]
    if name == "faster_small":
        # fixed-CU P frames, but the quadtree SPS of the split-RDO IDR
        assert (params.min_cu_log2, params.max_tr_depth_inter) == (3, 0)
        assert aus[1:] != base[1:]
    if name == "fast_padded_small":
        assert (params.pad_right, params.pad_bottom) == (8, 8)
    if name == "fast_s16_small":
        assert aus[1:] != base[1:]


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_decodes(name):
    _assert_decodes(name)


def test_scene_cut_inside_a_tree_chunk():
    # search 16 loses the clip's motion: the chunk [1, 2, 3] is dispatched
    # as P frames, frame 1 trips the scene-cut test and is re-encoded as
    # IDR, the rest of the chunk per frame (held to the JAX package's bytes
    # by test_variant_matches_fixture)
    aus = _port_run("fast_s16_small")[0]
    idr = [_is_idr(a) for a in aus]
    assert idr[0] and idr[1] and not all(idr)
    cfg = dataclasses.replace(fx.run_config("fast_s16_small"),
                              reinit_gop_on_scene_change=False)
    enc = HomerEncoder(cfg, device="cpu", fetch_recon=False)
    plain = enc.encode_frames(fx.clip("fast_s16_small"), chunk=3)
    assert [_is_idr(a) for a in plain] == [True, False, False, False]


@pytest.mark.parametrize("name", ["fast_small", "fast_s16_small",
                                  "faster_small"])
def test_per_frame_path_matches_chunked(name):
    cfg = fx.run_config(name)
    enc = HomerEncoder(cfg, device="cpu")
    got = [enc.encode_frame(*f) for f in fx.clip(name)]
    assert got == _port_run(name)[0]
    assert enc.last_recon[0].shape == (cfg.height, cfg.width)
    np.testing.assert_array_equal(
        enc.last_recon[0], _port_run(name)[1][0][:cfg.height, :cfg.width])


def test_seed_reference_carry_over_fast():
    # a session seeded with the planes behind frame 3 writes the fixture's
    # AUs 4 and 5
    frames = fx.clip("fast_small")
    cfg = fx.run_config("fast_small")
    first = HomerEncoder(cfg, device="cpu", fetch_recon=False)
    head = first.encode_frames(frames[:4], chunk=3)
    ref = tuple(p.numpy() for p in first._ref)
    port = HomerEncoder(cfg, device="cpu", fetch_recon=False)
    port.seed_reference(ref, poc=4, last_idr=0)
    tail = port.encode_frames(frames[4:], chunk=3)
    assert fx.au_digest(head + tail) == _fixture()["fast_small"]["aus"]
    assert port.poc == 6
    with pytest.raises(ValueError):
        port.seed_reference(tuple(p[:-4] for p in ref), poc=6, last_idr=0)


@pytest.mark.parametrize("mode", ["FASTEST_COMPUTATION", "FASTER_COMPUTATION",
                                  "FAST_COMPUTATION", "FULL_COMPUTATION"])
@pytest.mark.parametrize("search", [8, 24, 32, 64])
def test_settings_inside_are_admitted(mode, search):
    cfg = fx.fast_config(128, 96, performance_mode=mode,
                         me_search_range=search)
    enc = HomerEncoder(cfg, device="cpu")
    assert enc.intra_split == (mode != "FASTEST_COMPUTATION")
    assert enc.inter_split == (mode in ("FAST_COMPUTATION",
                                        "FULL_COMPUTATION"))
    assert enc.inter_cu8 == (mode == "FULL_COMPUTATION")


@pytest.mark.parametrize("mode", ["FULL_COMPUTATION", "FAST_COMPUTATION",
                                  "FASTER_COMPUTATION",
                                  "FASTEST_COMPUTATION"])
def test_cu16_raises(mode):
    # the JAX package has no quadtree P stage at CTU 16 (FAST and FULL fail
    # there: fault 1 of the reference), so those stay refused; FASTEST and
    # FASTER are ported at cu_size 16 and code a small clip (their bytes:
    # tests/test_torch_ctu16.py)
    cfg = fx.fast_config(128, 96, cu_size=16, performance_mode=mode)
    if mode in ("FAST_COMPUTATION", "FULL_COMPUTATION"):
        with pytest.raises(NotImplementedError, match="cu_size=16"):
            HomerEncoder(cfg, device="cpu")
        return
    enc = HomerEncoder(cfg, device="cpu")
    aus = enc.encode_frames(fx.clip("fast_small")[:3], chunk=2)
    enc.close()
    assert len(aus) == 3 and all(au[:4] == b"\x00\x00\x00\x01"
                                 for au in aus)
    assert enc.ctu == 16 and enc.params.ctu_log2 == 4


@pytest.mark.parametrize("field,value", [
    ("cu_size", 16),
    ("gop_size", 2),
    ("wpp_shards", 2),
    ("rd_mode", RDMode.FAST),
    ("rd_mode", RDMode.DIST_ONLY),
    ("bit_depth", 10),
])
def test_out_of_slice_settings_raise(field, value):
    # every rd_mode is ported, and B frames at cu_size 32: those are
    # admitted here, and B frames raise at cu_size 64; wpp_shards is
    # admitted (a CPU session builds no mesh: it has no CUDA devices)
    cfg = dataclasses.replace(fx.fast_config(128, 96), **{field: value})
    if field == "wpp_shards":
        enc = HomerEncoder(cfg, device="cpu")
        assert enc._mesh is None
        enc.close()
        return
    if field in ("rd_mode", "gop_size"):
        HomerEncoder(cfg, device="cpu").close()
        if field == "rd_mode":
            return
        cfg = dataclasses.replace(cfg, cu_size=64)
    with pytest.raises(NotImplementedError, match=field):
        HomerEncoder(cfg, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("bitrate_mode", BitrateMode.CBR),
    ("bitrate_mode", BitrateMode.VBR),
    ("wpp", True),
])
def test_rate_control_and_wpp_admitted(field, value):
    # the quadtree path codes per-CTU-row QPs whenever rate control runs
    cfg = dataclasses.replace(fx.fast_config(128, 96), **{field: value})
    enc = HomerEncoder(cfg, device="cpu")
    rc = cfg.bitrate_mode != BitrateMode.FIXED_QP
    assert enc.params.wpp_enabled == cfg.wpp
    assert enc.params.cu_qp_delta_enabled == rc == enc._row_qp_on


def test_earlier_fixture_entries_did_not_move():
    # the fixed-CU runs of the fixture, as first written from the JAX
    # package, and the CTU-64 and FULL runs as written when they came
    want = {
        "small": "57b868a82d6ba0abc28ecb16c237193258a654d8262210ad3b96e7b06a"
                 "ae520f",
        "720p": "38d9e00ffedbef2351fe8f5d2144326fd973db539b9045787130323f64b"
                "c68e0",
        "default_720p": "3308011253014f517466e39292414a4b2971a3d69474e6e850"
                        "7988f6f546efde",
        "full64_720p": "f1c45a5d4fb74fc8285d1c0b961f05042ece653f40cdd852919"
                       "f0a5c054dbaa0",
        "fastest64_720p": "5ba52137699a1c9f231f70b41110e751d1a1ec5ab200538"
                          "492cf6c697c7bfd18",
        "default_small": "f20da1e6e91ebf7a1de35b96b5cb7845d01ec9d3a08c6684e"
                         "35cde44b322f69c",
        "faster64_small": "0c35970681312cbcf67a1e3f2dc9edd59e9a466c09b6f6a"
                          "77b4591cf206e7638",
        "faster64_s64_small": "a1b3c26a24cf3508f8777ab9ec74c44b365a8858e88"
                              "955a24be30c022befdc4a",
        "fastest64_small": "135608562ef3ddffabb00555d052dfb50b96e3624afcf52"
                           "d93b1e2aab720b451",
        "full64_small": "5b5cd76c4da825769c63c9dd82b1b36d74d9615c133d071e1e"
                        "a3d23e2da03c5e",
        "full64_s16_small": "86c439fa44b724e3056e3db7a4afd8ce986fe55ad97f02"
                            "b8e7edefe9a99297e9",
        "full32_small": "fa2ee799e6d69e7055c1112fe27f1639415e32af789190a76"
                        "563b1fe09f109be",
        "full32_s16_small": "ca1bfbfd599621308ed1c71c3673d0126c17e8a26b4f7"
                            "fcdee64c31ea74d6fbd",
    }
    for name, digest in want.items():
        aus = _fixture()[name]["aus"]
        assert len(aus) == fx.RUNS[name]["frames"]
        assert hashlib.sha256(json.dumps(aus, sort_keys=True)
                              .encode()).hexdigest() == digest, name
    # FULL, FAST and FASTER code the same IDR (chip_smoke.py continues
    # full64_720p from default_720p's IDR planes on that ground)
    fx_ = _fixture()
    assert fx_["full64_720p"]["aus"][0] == fx_["default_720p"]["aus"][0]
