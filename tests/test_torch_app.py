"""The port's CLI (homerhevc_tpu_torch/app.py, launched by
homer_app_torch.py) and its session surface against the JAX package's CLI
(homer_app.py), on the CPU:

  CLI runs        each small run of fixtures.CLI_RUNS through app.main with
                  -device cpu, in process, on the same .yuv file and flags
                  as the JAX CLI's recorded run: the .265 and -o-raw SHA-256,
                  the per-frame lines (PSNR included) and what follows "fps"
                  on the last line equal the fixture's (the timing is not
                  compared); the port's .265 decodes in libde265 to its
                  -o-raw file
                    cli_fastest_small     120x88 (padded), IPPP, FASTEST,
                                          SAO, -metrics -o-raw -profiling
                    cli_cbr_fast_small    120x88, FAST, CBR at 8 kbps, frame
                                          by frame, a scene cut at frame 5
                    cli_ibp_small         128x96, -gop_size 2, FASTEST
                    cli_allintra64_small  192x128, -gop_size 0 -cu_size 64
                                          -rd 2 -sao 0 (BASELINE.md
                                          configuration 1, small)
  stage names     the profiler's stage names equal the JAX CLI's on the
                  IPPP run; on the IBP run the port adds only its B frame's
                  and explicit P frame's stages; every probe name of the JAX
                  session is one of the port's
  1080p entry     cli_cbr_scene_fastest_1080p (BASELINE.md configuration 4,
                  run on the GPU by chip_smoke.py): the JAX CLI's stream
                  re-encodes frame 5 as a scene-change IDR and decodes in
                  libde265 to its own reconstruction
  surface         write_annex_b writes b"".join(aus); -cu_size 16 in the
                  default -performance_mode (FAST, fault 1) exits
                  non-zero with the NotImplementedError's message and writes
                  no file; the flags and their defaults are homer_app.py's
                  (less -backend, plus -device); read_yuv_frames reads what
                  homer_app.py's does; profiler=NULL, no profiler and an
                  enabled profiler give the same AUs

The JAX CLI's outputs come from tests/fixtures/torch_port_aus.json ("cli",
written by tools/make_torch_fixtures.py): no JAX compile runs here.
Tolerance: exact (bytes and printed text).
"""

import contextlib
import dataclasses
import functools
import io
import os
import re

import numpy as np
import pytest

import homer_app
from homerhevc_tpu_torch import app
from homerhevc_tpu_torch.api import HomerEncoder, write_annex_b
from homerhevc_tpu_torch.utils import fixtures as fx
from homerhevc_tpu_torch.utils.profiler import NULL, Profiler
from test_torch_ctu64 import ROOT, fixture
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

SMALL = ["cli_fastest_small", "cli_cbr_fast_small", "cli_ibp_small",
         "cli_allintra64_small"]
COMPARED = ("stream", "raw", "lines", "frames", "tail")
# stages only the port's session has: a B frame and an explicit P frame
PORT_ONLY = {"b.upload", "b.device", "b.fetch", "b.plans", "b.entropy",
             "p_expl.upload", "p_expl.device", "p_expl.fetch",
             "p_expl.decisions+maps", "p_expl.entropy"}


def _cli(argv):
    """app.main in process: (exit code, standard output, standard error)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = app.main(argv)
    return rc, out.getvalue(), err.getvalue()


@functools.lru_cache(maxsize=None)
def port_cli(name: str, tmp: str):
    """The port's CLI on one of CLI_RUNS (-device cpu): (record, exit code,
    output text, per-CTU-row QP plans of its frames, decode check)."""
    plans = []
    plan_rows = HomerEncoder._plan_rows

    def recording(self, qp):
        rows = plan_rows(self, qp)
        plans.append(None if rows is None else np.array(rows))
        return rows

    r = fx.CLI_RUNS[name]
    yuv, out, raw = (os.path.join(tmp, f"{name}.{e}")
                     for e in ("yuv", "265", "rec.yuv"))
    fx.write_cli_input(name, yuv)
    HomerEncoder._plan_rows = recording
    try:
        rc, text, _ = _cli(fx.cli_argv(name, yuv, out, raw)
                           + ["-device", "cpu"])
    finally:
        HomerEncoder._plan_rows = plan_rows
    dec = (fx.cli_decode_check(out, raw, r["width"], r["height"])
           if r.get("write_raw") else None)
    return fx.cli_record(text, out, raw), rc, text, plans, dec


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cli"))


def _entry(name):
    entry = fixture()["cli"][name]
    spec = dict(fx.CLI_RUNS[name], args=list(fx.CLI_RUNS[name]["args"]))
    assert {k: entry[k] for k in spec} == spec
    return entry


@pytest.mark.parametrize("name", SMALL)
def test_cli_matches_jax_cli(name, tmp):
    entry = _entry(name)
    rec, rc, text, _, _ = port_cli(name, tmp)
    assert rc == 0, text
    for k in COMPARED:
        assert rec[k] == entry[k], k
    assert rec["frames"] == fx.CLI_RUNS[name]["frames"]
    if fx.CLI_RUNS[name].get("write_raw"):
        assert rec["raw"]["len"] == rec["frames"] * fx.CLI_RUNS[name][
            "width"] * fx.CLI_RUNS[name]["height"] * 3 // 2
    else:
        assert rec["raw"] is None and entry["raw"] is None


@pytest.mark.parametrize("name", [n for n in SMALL
                                  if fx.CLI_RUNS[n].get("write_raw")])
def test_cli_streams_decode_to_their_reconstruction(name, tmp):
    # the JAX CLI's (recorded) and the port's (here), where libde265 loads
    assert _entry(name)["decode"]["match"]
    dec = port_cli(name, tmp)[4]
    if dec is not None:
        assert dec["match"], dec


def test_cli_stage_names_match_jax_cli(tmp):
    rec = port_cli("cli_fastest_small", tmp)[0]
    assert rec["stages"] == _entry("cli_fastest_small")["stages"]
    assert {"intra.device", "p.device", "p.fetch", "ref.fetch"} <= set(
        rec["stages"])
    ibp = port_cli("cli_ibp_small", tmp)[0]
    want = set(_entry("cli_ibp_small")["stages"])
    assert want <= set(ibp["stages"])
    assert set(ibp["stages"]) - want == PORT_ONLY


def test_every_jax_probe_name_is_a_port_probe_name():
    def names(path):
        with open(os.path.join(ROOT, path)) as f:
            return set(re.findall(r'probe\("([^"]+)"\)', f.read()))

    jax_names = names("homerhevc_tpu/api.py")
    port_names = names("homerhevc_tpu_torch/api.py")
    # the fixed-CU P frame's fetch and decisions probes take their stage
    # as an argument ("p" or "p_expl")
    port_names |= {f"{s}.{k}" for s in ("p", "p_expl")
                   for k in ("fetch", "decisions+maps")}
    assert {"chunk.upload", "chunk.dispatch", "chunk.fetch", "chunk.scatter",
            "chunk.decisions", "chunk.entropy"} <= jax_names
    assert jax_names <= port_names
    assert port_names - jax_names == PORT_ONLY


def test_cbr_cli_codes_a_scene_cut_and_row_qps(tmp):
    rec, _, _, plans, _ = port_cli("cli_cbr_fast_small", tmp)
    assert rec["lines"][0].startswith("POC:0, I,")
    assert rec["lines"][5].startswith("POC:5, I,")
    # frame by frame under CBR on the quadtree path: a frame's CTU rows
    # take different QPs
    assert any(p is not None and len(set(p.tolist())) > 1 for p in plans)
    assert len({ln.split("qp: ")[1].split(",")[0]
                for ln in rec["lines"]}) > 1


def test_1080p_reference_run():
    entry = _entry("cli_cbr_scene_fastest_1080p")
    lines = entry["lines"]
    assert len(lines) == 10
    assert [ln.split(", ")[1] for ln in lines] == ["I"] + ["P"] * 4 + [
        "I"] + ["P"] * 4
    assert entry["stages"] == _entry("cli_fastest_small")["stages"]
    assert entry["raw"]["len"] == 10 * 1920 * 1080 * 3 // 2
    # libde265 decodes the JAX CLI's 1080p stream (1088 coded rows, the
    # conformance window crops 8) to its -o-raw file
    assert entry["decode"] == {"match": True, "decoded": 10,
                               "first_diff": None}


def test_write_annex_b(tmp_path):
    aus = [b"\x00\x00\x00\x01\x40\x01", b"", b"\x00\x00\x01\x26\x01\xaf"]
    path = tmp_path / "out.265"
    write_annex_b(str(path), aus)
    assert path.read_bytes() == b"".join(aus)


def test_cli_refuses_cu_size_16(tmp_path):
    yuv = tmp_path / "in.yuv"
    fx.write_cli_input("cli_fastest_small", str(yuv))
    out, raw = tmp_path / "out.265", tmp_path / "rec.yuv"
    rc, text, err = _cli(["-i", str(yuv), "-o", str(out), "-o-raw", str(raw),
                          "-widthxheight", "120x88", "-cu_size", "16",
                          "-device", "cpu"])
    assert rc != 0 and text == ""
    assert "cu_size=16" in err and "not ported" in err
    assert not out.exists() and not raw.exists()


def test_flags_and_defaults_are_homer_apps():
    argvs = [["-i", "x.yuv"],
             ["-i", "x.yuv", "-o", "y.265", "-o-raw", "r.yuv",
              "-widthxheight", "1920x1080", "-performance_mode", "3",
              "-bitrate_mode", "1", "-bitrate", "1250", "-rd", "2", "-sao",
              "1", "-vbv_size", "0.5", "-n_wpp_threads", "2", "-metrics",
              "-profiling", "-gop_size", "0", "-rd_mode", "0"]]
    for argv in argvs:
        want = vars(homer_app.parse_args(argv))
        got = vars(app.parse_args(argv))
        assert want.pop("backend") == "jax"
        assert got.pop("device") is None
        assert got == want
    assert app.parse_args(["-i", "x", "-device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        app.parse_args(["-i", "x", "-backend", "golden"])


def test_config_mapping_is_homer_apps():
    # homer_app.py's arithmetic: gop 0 -> intra_period 1, VBV sizes in
    # units of the bitrate, WPP from the thread count
    args = app.parse_args(["-i", "x", "-bitrate_mode", "1", "-bitrate", "800",
                           "-vbv_size", "0.5", "-vbv_init", "0.4",
                           "-gop_size", "0", "-n_wpp_threads", "3",
                           "-cu_size", "64", "-rd", "2"])
    cfg = app.config_from_args(args, 192, 128)
    assert (cfg.intra_period, cfg.vbv_size, cfg.vbv_init, cfg.wpp) == (
        1, 400, 160, True)
    assert (cfg.bitrate_mode.name, cfg.rd_mode.name, cfg.cu_size) == (
        "CBR", "FAST", 64)


def test_read_yuv_frames_is_homer_apps(tmp_path):
    path = tmp_path / "in.yuv"
    rng = np.random.default_rng(4)
    w, h = 24, 16
    # three whole frames and a partial one
    path.write_bytes(rng.integers(0, 256, w * h * 3 // 2 * 3 + 100,
                                  dtype=np.uint8).tobytes())
    for n, skip in ((5, 0), (2, 1), (5, 2), (1, 3)):
        want = list(homer_app.read_yuv_frames(str(path), w, h, n, skip))
        got = list(app.read_yuv_frames(str(path), w, h, n, skip))
        assert len(got) == len(want)
        for a, b in zip(want, got):
            for p, q in zip(a, b):
                np.testing.assert_array_equal(q, p)


def test_profiler_changes_no_byte():
    # "small" turns its first chunk into a scene cut (per-frame re-encodes);
    # without the scene-cut test its P frames stay in the chunk
    name = "small"
    frames = fx.clip(name)[:5]
    for reinit in (True, False):
        cfg = dataclasses.replace(fx.run_config(name),
                                  reinit_gop_on_scene_change=reinit)
        runs, profs = {}, {}
        for key, prof in (("none", None), ("null", NULL), ("on", Profiler())):
            enc = HomerEncoder(cfg, device="cpu", fetch_recon=False,
                               profiler=prof)
            runs[key] = (enc.encode_frames(frames[:4], chunk=3)
                         + [enc.encode_frame(*frames[4])])
            profs[key] = enc.prof
            enc.close()
        assert runs["none"] == runs["null"] == runs["on"]
        assert profs["none"] is NULL and not NULL.acc
        if reinit:
            assert fx.au_digest(runs["on"]) == fixture()[name]["aus"][:5]
    on = profs["on"]
    assert set(on.acc) == {"upload", "intra.device", "intra.fetch+maps",
                           "sao", "entropy", "chunk.upload",
                           "chunk.dispatch", "chunk.fetch", "chunk.scatter",
                           "chunk.decisions", "chunk.entropy", "p.device",
                           "p.fetch", "p.decisions+maps"}
    assert on.count["chunk.dispatch"] == 1 and on.count["chunk.entropy"] == 3
