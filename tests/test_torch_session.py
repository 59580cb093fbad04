"""Session level: the torch port's HomerEncoder (device=cpu, plain kernel
versions) against homerhevc_tpu.api.HomerEncoder(backend="jax").

  * the 128x96 fixture clip (synth_clip(128, 96, 6, seed=3), slice
    configuration, encode_frames(chunk=3)) gives byte-identical AUs;
  * the committed fixture tests/fixtures/torch_port_aus.json still equals
    the live JAX output (chip_smoke.py holds the card to that fixture);
  * the port's stream decodes in libde265 to the port's own recon;
  * seed_reference carries a P chain over: both sessions seeded from the
    same planes give byte-identical P AUs;
  * settings outside the ported configurations raise NotImplementedError
    (rd_mode FAST, B frames at cu_size 32 and FASTEST at cu_size 16 are
    admitted)
    (the quadtree configurations are in tests/test_torch_session_fast.py,
    CTU 64 and FULL_COMPUTATION in tests/test_torch_ctu64.py and
    tests/test_torch_cu8.py); CBR and WPP are admitted (their streams are
    held in tests/test_torch_rc.py).

Each package gets its own EncoderConfig, built from one keyword dictionary
(the port refuses the other package's class). Tolerance: exact, byte for
byte.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from homerhevc_tpu.api import HomerEncoder as JaxEncoder
from homerhevc_tpu_torch.api import HomerEncoder
from homerhevc_tpu_torch.config import BitrateMode, PerformanceMode, RDMode
from homerhevc_tpu_torch.utils import fixtures as fx
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")


def _tools():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures",
        os.path.join(ROOT, "tools", "make_torch_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small():
    r = fx.RUNS["small"]
    cfg = fx.slice_config(r["width"], r["height"])
    return fx, r, fx.clip("small"), cfg


@pytest.fixture(scope="module")
def jax_aus():
    return _tools().jax_run("small")


@pytest.fixture(scope="module")
def port_aus(small):
    _, r, frames, cfg = small
    enc = HomerEncoder(cfg, device="cpu", fetch_recon=False)
    aus = enc.encode_frames(frames, chunk=r["chunk"])
    enc.close()
    return aus


def test_session_matches_jax(jax_aus, port_aus):
    assert len(jax_aus) == len(port_aus)
    for k, (a, b) in enumerate(zip(jax_aus, port_aus)):
        assert a == b, f"AU {k} differs: {len(a)} vs {len(b)} bytes"


def test_fixture_matches_live_jax(jax_aus):
    with open(FIXTURE) as f:
        want = json.load(f)["small"]["aus"]
    assert fx.au_digest(jax_aus) == want


def test_port_matches_fixture(small, port_aus):
    with open(FIXTURE) as f:
        want = json.load(f)["small"]["aus"]
    assert small[0].au_digest(port_aus) == want


def test_per_frame_path_matches_chunked(small, port_aus):
    _, _, frames, cfg = small
    enc = HomerEncoder(cfg, device="cpu")
    got = [enc.encode_frame(*f) for f in frames]
    assert got == port_aus
    assert enc.last_recon[0].shape == (cfg.height, cfg.width)


def test_port_stream_decodes(small):
    from homerhevc_tpu_torch.validate import de265
    if not de265.available():
        pytest.skip("libde265 not available")
    _, _, frames, cfg = small
    enc = HomerEncoder(cfg, device="cpu")
    aus, recons = [], []
    for f in frames:
        aus.append(enc.encode_frame(*f))
        recons.append(enc.last_recon)
    dec = de265.decode_annexb(b"".join(aus))
    assert len(dec) == len(frames)
    for k, (d, r) in enumerate(zip(dec, recons)):
        for p, q in zip(d, r):
            np.testing.assert_array_equal(p, q, err_msg=f"frame {k}")


def test_seed_reference_carry_over(small):
    _, _, frames, cfg = small
    cfg = dataclasses.replace(cfg, reinit_gop_on_scene_change=False)
    first = HomerEncoder(cfg, device="cpu")
    first.encode_frames(frames[:2], chunk=1)
    ref = tuple(p.numpy() for p in first._ref)
    tail = frames[2:4]
    jax_cfg = dataclasses.replace(
        _tools().jax_config(cfg.width, cfg.height),
        reinit_gop_on_scene_change=False)
    jax_enc = JaxEncoder(jax_cfg, backend="jax", fetch_recon=False)
    jax_enc.seed_reference(ref, poc=2, last_idr=0)
    port = HomerEncoder(cfg, device="cpu", fetch_recon=False)
    port.seed_reference(ref, poc=2, last_idr=0)
    want = jax_enc.encode_frames(tail, chunk=3)
    got = port.encode_frames(tail, chunk=3)
    assert got == want
    assert port.poc == jax_enc.poc == 4


@pytest.mark.parametrize("field,value", [
    ("cu_size", 16),
    ("gop_size", 2),
    ("wpp_shards", 2),
    ("rd_mode", RDMode.FAST),
])
def test_out_of_slice_settings_raise(small, field, value):
    # every rd_mode is ported, B frames at cu_size 32, and this FASTEST
    # configuration at cu_size 16: those are admitted here, and B frames
    # raise at cu_size 64, FAST at cu_size 16; wpp_shards is admitted (a
    # CPU session builds no mesh: it has no CUDA devices)
    cfg = dataclasses.replace(small[3], **{field: value})
    if field == "wpp_shards":
        enc = HomerEncoder(cfg, device="cpu")
        assert enc._mesh is None
        enc.close()
        return
    if field in ("rd_mode", "gop_size", "cu_size"):
        HomerEncoder(cfg, device="cpu").close()
        if field == "rd_mode":
            return
        cfg = dataclasses.replace(cfg, **(
            dict(cu_size=64) if field == "gop_size" else
            dict(performance_mode=PerformanceMode.FAST_COMPUTATION)))
    with pytest.raises(NotImplementedError, match=field):
        HomerEncoder(cfg, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("bitrate_mode", BitrateMode.CBR),
    ("wpp", True),
])
def test_rate_control_and_wpp_admitted(small, field, value):
    # the fixed-CU path codes a QP per frame: no cu_qp_delta there
    cfg = dataclasses.replace(small[3], **{field: value})
    enc = HomerEncoder(cfg, device="cpu")
    assert enc.params.wpp_enabled == cfg.wpp
    assert not enc.params.cu_qp_delta_enabled
    assert (enc._rc is None) == (cfg.bitrate_mode == BitrateMode.FIXED_QP)
