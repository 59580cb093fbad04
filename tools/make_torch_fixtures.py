"""Write tests/fixtures/torch_port_aus.json from the JAX package.

The fixture holds the SHA-256 and length of every AU the JAX package
(homerhevc_tpu) writes for each reference run of the torch port. The port
(homerhevc_tpu_torch) runs where JAX is not installed; these hashes let
chip_smoke.py and the tests hold its output against the JAX package there.
The runs, the clips and the configuration keywords are the port's own
(homerhevc_tpu_torch/utils/fixtures.py); this tool is the one place that
feeds them to the JAX package.

Run on the CPU:  JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")


def jax_config(width: int, height: int):
    """The slice configuration as the JAX package's own EncoderConfig."""
    from homerhevc_tpu.config import EncoderConfig, PerformanceMode
    from homerhevc_tpu_torch.utils.fixtures import slice_kwargs
    kw = slice_kwargs(width, height)
    kw["performance_mode"] = PerformanceMode[kw["performance_mode"]]
    return EncoderConfig(**kw)


def jax_run(name: str) -> list:
    """AUs of the JAX package for one of the port's RUNS (imports jax)."""
    from homerhevc_tpu.api import HomerEncoder
    from homerhevc_tpu_torch.utils.fixtures import RUNS, clip
    r = RUNS[name]
    enc = HomerEncoder(jax_config(r["width"], r["height"]), backend="jax",
                       fetch_recon=False)
    try:
        return enc.encode_frames(clip(name), chunk=r["chunk"])
    finally:
        enc.close()


def main() -> int:
    from homerhevc_tpu_torch.utils.fixtures import RUNS, au_digest
    out = {name: dict(RUNS[name], aus=au_digest(jax_run(name)))
           for name in RUNS}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}: " + ", ".join(
        f"{k} {len(v['aus'])} AUs" for k, v in out.items()))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
