"""Write tests/fixtures/torch_port_aus.json from the JAX package.

The fixture holds the SHA-256 and length of every AU the JAX package
(homerhevc_tpu) writes for each reference run of the torch port. The port
(homerhevc_tpu_torch) runs where JAX is not installed; these hashes let
chip_smoke.py and the tests hold its output against the JAX package there.
The runs, the clips and the configuration keywords are the port's own
(homerhevc_tpu_torch/utils/fixtures.py); this tool is the one place that
feeds them to the JAX package.

Run on the CPU:

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py \
        [--out FILE] [RUN ...]
    python tools/make_torch_fixtures.py --merge FILE [FILE ...]

With no run named every run and every intra case is computed anew; with
names (of RUNS, INTRA_CASES, CLI_RUNS, SHARDED_CASES, or a case of
INTRA16_CASES as "intra16_" + its name) only those are computed and the
other entries of the file are kept as they are (the 720p runs take
minutes each on a CPU, and every new shape, transform depth or rd_mode
of the split-RDO IDR compiles for about three minutes at CTU 32 and forty
at CTU 64). `--out`
reads and writes FILE instead of the fixture, so independent runs can go in
separate processes; `--merge` copies the runs of such files into the
fixture. A run marked "push" in RUNS goes through push_frame and flush.
A run of CLI_RUNS goes through the JAX package's CLI (homer_app.main) on
the clip written to a .yuv file; its entry under "cli" holds the digests of
the .265 and -o-raw files, the printed lines without timings, and the
libde265 check of the .265 against the -o-raw file. A run with a band mesh
(`mesh` or wpp_shards in RUNS) is coded by the JAX session with its mesh and
without, and the two must be equal. A case of SHARDED_CASES goes through
the JAX package's make_p_frame_sharded and its single-device stage; its
entry under "sharded" holds the SHA-256 of each output of both. A case of
INTRA16_CASES goes through the JAX package's IDR stage at B 16; its entry
under "intra16" holds the SHA-256 of each output array. The tool gives JAX
8 virtual CPU devices, as tests/conftest.py does.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")


def jax_config_from(kw: dict):
    """Configuration keywords (enums by name) as the JAX package's own
    EncoderConfig."""
    from homerhevc_tpu.config import (BitrateMode, EncoderConfig,
                                      PerformanceMode, RDMode)
    kw = dict(kw)
    kw["performance_mode"] = PerformanceMode[kw["performance_mode"]]
    if "bitrate_mode" in kw:
        kw["bitrate_mode"] = BitrateMode[kw["bitrate_mode"]]
    if "rd_mode" in kw:
        kw["rd_mode"] = RDMode[kw["rd_mode"]]
    return EncoderConfig(**kw)


def jax_config(width: int, height: int):
    """The fixed-CU slice configuration as the JAX package's own."""
    from homerhevc_tpu_torch.utils.fixtures import slice_kwargs
    return jax_config_from(slice_kwargs(width, height))


def jax_encode(kw: dict, frames, chunk: int) -> list:
    """AUs of the JAX package for one keyword dictionary (imports jax)."""
    from homerhevc_tpu.api import HomerEncoder
    enc = HomerEncoder(jax_config_from(kw), backend="jax", fetch_recon=False)
    try:
        return enc.encode_frames(frames, chunk=chunk)
    finally:
        enc.close()


def jax_mesh(n: int):
    """A jax Mesh of the first n devices on one 'band' axis."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    devs = jax.devices()[:n]
    if len(devs) < n:
        raise RuntimeError(f"a mesh of {n} needs {n} JAX devices, there are "
                           f"{len(devs)}")
    return Mesh(np.array(devs), ("band",))


def jax_run(name: str) -> list:
    """AUs of the JAX package for one of the port's RUNS; a run with a band
    mesh (`mesh`, or wpp_shards > 1) is coded with the mesh and without, and
    the two must be equal."""
    from homerhevc_tpu.api import HomerEncoder
    from homerhevc_tpu_torch.utils.fixtures import (encode_run, run_kwargs,
                                                    run_spec)

    def session(kw, mesh):
        enc = HomerEncoder(jax_config_from(kw), backend="jax",
                           fetch_recon=False, mesh=mesh)
        try:
            return encode_run(enc, name), enc._mesh is not None
        finally:
            enc.close()

    kw = run_kwargs(name)
    n = run_spec(name).get("mesh")
    aus, meshed = session(kw, jax_mesh(n) if n else None)
    if n or kw.get("wpp_shards", 1) > 1:
        if not meshed:
            raise AssertionError(f"{name}: the JAX session built no mesh")
        single, _ = session(dict(kw, wpp_shards=1), None)
        if single != aus:
            raise AssertionError(f"{name}: the JAX session's AUs differ with "
                                 "and without its mesh")
    return aus


def jax_sharded_case(name: str) -> dict:
    """SHA-256 per output of the JAX package's make_p_frame_sharded step on
    a (lanes, bands) mesh and of its single-device p_frame_device, lane by
    lane, for one of the port's SHARDED_CASES."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from homerhevc_tpu.parallel.sharded import make_p_frame_sharded
    from homerhevc_tpu.pipeline.p_jax import p_frame_device
    from homerhevc_tpu_torch.utils.fixtures import (SHARDED_CASES,
                                                    SHARDED_KEYS,
                                                    array_digest,
                                                    sharded_frames)
    c = SHARDED_CASES[name]
    G, nb = c["lanes"], c["bands"]
    mesh = Mesh(np.array(jax.devices()[:G * nb]).reshape(G, nb),
                ("gop", "band"))
    cur, ref = sharded_frames(name)
    gb = NamedSharding(mesh, P("gop", "band"))
    args = [jax.device_put(jnp.asarray(a), gb) for a in cur + ref]
    qp = jax.device_put(jnp.full((G,), 32, jnp.int32),
                        NamedSharding(mesh, P("gop")))
    step = make_p_frame_sharded(mesh, B=c["B"], search=c["search"],
                                me_precision=2)
    out = step(*args, qp)
    single = [p_frame_device(*(jnp.asarray(p[g]) for p in cur + ref),
                             B=c["B"], qp=32, search=c["search"],
                             me_precision=2) for g in range(G)]
    return dict(
        c, seeds=list(c["seeds"]),
        sharded={k: array_digest(o) for k, o in zip(SHARDED_KEYS, out)},
        single={k: array_digest(np.stack([np.asarray(s[k]) for s in single]))
                for k in SHARDED_KEYS})


def jax_intra_case(c: dict, B: int = 32) -> dict:
    """SHA-256 per output array of the JAX package's IDR stage
    (encode_frame_intra at block size B) for one of the port's INTRA_CASES
    (split RDO, rd_mode FULL) or INTRA16_CASES (B 16, the case's split and
    rd_mode)."""
    import jax.numpy as jnp

    from homerhevc_tpu.pipeline import intra_jax
    from homerhevc_tpu_torch.utils.fixtures import (INTRA_KEYS, array_digest,
                                                    intra_frame)
    frame = intra_frame(c["width"], c["height"], c["seed"])
    out = intra_jax.encode_frame_intra(
        *map(jnp.asarray, frame), B=B, qp=32, sign_hiding=True,
        split_rdo=c.get("split", True), rd_mode=c.get("rd_mode", 1),
        tu_depth=c["tu_depth"])
    return {k: array_digest(out[k]) for k in INTRA_KEYS}


def jax_cli(name: str) -> dict:
    """The JAX package's CLI (homer_app.main, in this process, its standard
    output captured) on one of the port's CLI_RUNS: what cli_record reads
    off its outputs, and the libde265 check of its .265 against its -o-raw
    file."""
    import contextlib
    import io
    import tempfile
    import time

    import homer_app
    from homerhevc_tpu_torch.utils import fixtures as fx

    r = fx.CLI_RUNS[name]
    with tempfile.TemporaryDirectory() as d:
        yuv, out, raw = (os.path.join(d, f) for f in ("in.yuv", "out.265",
                                                      "rec.yuv"))
        fx.write_cli_input(name, yuv)
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            homer_app.main(fx.cli_argv(name, yuv, out, raw))
        secs = time.perf_counter() - t
        text = buf.getvalue()
        print(text, end="")
        print(f"{name}: the JAX CLI took {secs:.1f} s on this CPU")
        rec = dict(r, args=list(r["args"]), **fx.cli_record(text, out, raw))
        rec["decode"] = (fx.cli_decode_check(out, raw, r["width"],
                                             r["height"])
                         if r.get("write_raw") else None)
    return rec


def _write(path: str, out: dict) -> None:
    from homerhevc_tpu_torch.utils.fixtures import (CLI_RUNS, INTRA16_CASES,
                                                    INTRA_CASES, RUNS,
                                                    SHARDED_CASES)
    intra = out.pop("intra_split", {})
    intra16 = out.pop("intra16", {})
    cli = out.pop("cli", {})
    shard = out.pop("sharded", {})
    out = {name: out[name] for name in RUNS if name in out}
    out["intra_split"] = {n: intra[n] for n in INTRA_CASES if n in intra}
    out["intra16"] = {n: intra16[n] for n in INTRA16_CASES if n in intra16}
    out["cli"] = {n: cli[n] for n in CLI_RUNS if n in cli}
    out["sharded"] = {n: shard[n] for n in SHARDED_CASES if n in shard}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: " + ", ".join(
        f"{k} {len(v['aus'])} AUs" for k, v in out.items()
        if k not in ("intra_split", "intra16", "cli", "sharded"))
        + f", intra_split {len(out['intra_split'])} cases, intra16 "
        f"{len(out['intra16'])} cases, cli "
        f"{len(out['cli'])} runs, sharded {len(out['sharded'])} cases")


def merge(paths) -> int:
    """Copy the runs and intra cases of other output files into OUT."""
    with open(OUT) as f:
        out = json.load(f)
    for p in paths:
        with open(p) as f:
            part = json.load(f)
        out.setdefault("intra_split", {}).update(part.pop("intra_split", {}))
        out.setdefault("intra16", {}).update(part.pop("intra16", {}))
        out.setdefault("cli", {}).update(part.pop("cli", {}))
        out.setdefault("sharded", {}).update(part.pop("sharded", {}))
        out.update(part)
    _write(OUT, out)
    return 0


def main(argv) -> int:
    from homerhevc_tpu_torch.utils.fixtures import (CLI_RUNS, INTRA16_CASES,
                                                    INTRA_CASES, RUNS,
                                                    SHARDED_CASES, au_digest)
    if argv[:1] == ["--merge"]:
        return merge(argv[1:])
    path = OUT
    if argv[:1] == ["--out"]:
        path, argv = argv[1], argv[2:]
    known = (list(RUNS) + list(INTRA_CASES) + list(CLI_RUNS)
             + list(SHARDED_CASES) + ["intra16_" + n for n in INTRA16_CASES])
    names = argv or known
    unknown = [n for n in names if n not in known]
    if unknown:
        print(f"unknown runs {unknown}; known: {known}", file=sys.stderr)
        return 2
    out = {}
    if argv and os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    intra = out.pop("intra_split", {})
    intra16 = out.pop("intra16", {})
    cli = out.pop("cli", {})
    shard = out.pop("sharded", {})
    for name in names:
        if name.startswith("intra16_"):
            case = INTRA16_CASES[name[len("intra16_"):]]
            intra16[name[len("intra16_"):]] = dict(
                case, arrays=jax_intra_case(case, B=16))
        elif name in RUNS:
            out[name] = dict(RUNS[name], aus=au_digest(jax_run(name)))
        elif name in CLI_RUNS:
            cli[name] = jax_cli(name)
        elif name in SHARDED_CASES:
            shard[name] = jax_sharded_case(name)
        else:
            intra[name] = dict(INTRA_CASES[name],
                               arrays=jax_intra_case(INTRA_CASES[name]))
        print(f"{name}: done", flush=True)
    out["intra_split"] = intra
    out["intra16"] = intra16
    out["cli"] = cli
    out["sharded"] = shard
    _write(path, out)
    return 0


if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
