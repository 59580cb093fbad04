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
names (of RUNS or INTRA_CASES) only those are computed and the other entries
of the file are kept as they are (the 720p runs take minutes each on a CPU,
and every new shape, transform depth or rd_mode of the split-RDO IDR
compiles for about three minutes at CTU 32 and forty at CTU 64). `--out`
reads and writes FILE instead of the fixture, so independent runs can go in
separate processes; `--merge` copies the runs of such files into the
fixture. A run marked "push" in RUNS goes through push_frame and flush.
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


def jax_run(name: str) -> list:
    """AUs of the JAX package for one of the port's RUNS."""
    from homerhevc_tpu.api import HomerEncoder
    from homerhevc_tpu_torch.utils.fixtures import encode_run, run_kwargs
    enc = HomerEncoder(jax_config_from(run_kwargs(name)), backend="jax",
                       fetch_recon=False)
    try:
        return encode_run(enc, name)
    finally:
        enc.close()


def jax_intra_case(name: str) -> dict:
    """SHA-256 per output array of the JAX package's split-RDO IDR stage for
    one of the port's INTRA_CASES."""
    import jax.numpy as jnp

    from homerhevc_tpu.pipeline import intra_jax
    from homerhevc_tpu_torch.utils.fixtures import (INTRA_CASES, INTRA_KEYS,
                                                    array_digest, intra_frame)
    c = INTRA_CASES[name]
    frame = intra_frame(c["width"], c["height"], c["seed"])
    out = intra_jax.encode_frame_intra(
        *map(jnp.asarray, frame), B=32, qp=32, sign_hiding=True,
        split_rdo=True, rd_mode=1, tu_depth=c["tu_depth"])
    return {k: array_digest(out[k]) for k in INTRA_KEYS}


def _write(path: str, out: dict) -> None:
    from homerhevc_tpu_torch.utils.fixtures import INTRA_CASES, RUNS
    intra = out.pop("intra_split", {})
    out = {name: out[name] for name in RUNS if name in out}
    out["intra_split"] = {n: intra[n] for n in INTRA_CASES if n in intra}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: " + ", ".join(
        f"{k} {len(v['aus'])} AUs" for k, v in out.items()
        if k != "intra_split")
        + f", intra_split {len(out['intra_split'])} cases")


def merge(paths) -> int:
    """Copy the runs and intra cases of other output files into OUT."""
    with open(OUT) as f:
        out = json.load(f)
    for p in paths:
        with open(p) as f:
            part = json.load(f)
        out.setdefault("intra_split", {}).update(part.pop("intra_split", {}))
        out.update(part)
    _write(OUT, out)
    return 0


def main(argv) -> int:
    from homerhevc_tpu_torch.utils.fixtures import (INTRA_CASES, RUNS,
                                                    au_digest)
    if argv[:1] == ["--merge"]:
        return merge(argv[1:])
    path = OUT
    if argv[:1] == ["--out"]:
        path, argv = argv[1], argv[2:]
    names = argv or list(RUNS) + list(INTRA_CASES)
    unknown = [n for n in names if n not in RUNS and n not in INTRA_CASES]
    if unknown:
        print(f"unknown runs {unknown}; known: "
              f"{list(RUNS) + list(INTRA_CASES)}", file=sys.stderr)
        return 2
    out = {}
    if argv and os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    intra = out.pop("intra_split", {})
    for name in names:
        if name in RUNS:
            out[name] = dict(RUNS[name], aus=au_digest(jax_run(name)))
        else:
            intra[name] = dict(INTRA_CASES[name],
                               arrays=jax_intra_case(name))
        print(f"{name}: done", flush=True)
    out["intra_split"] = intra
    _write(path, out)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
