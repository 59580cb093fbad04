"""The torch port's reference runs, and the fixture written from them.

Writes tests/fixtures/torch_port_aus.json: the SHA-256 and length of every
AU the JAX package writes for each reference run. `slice_config`, `clip`
and `decode_check` are shared with chip_smoke.py and the port's tests.

The port (homerhevc_tpu_torch) runs where JAX is not installed; these hashes
let it hold its output against the JAX package there. Two runs, both with
the slice configuration (FASTEST_COMPUTATION, cu_size 32, search 16,
quarter-pel, fixed QP 32, deblocking + SAO + sign hiding, intra_period 100,
frame_pipeline_depth 2):

  small: synth_clip(128, 96, 6, seed=3), encode_frames(chunk=3)
  720p:  synth_clip(1280, 720, 17, seed=0), encode_frames(chunk=8)

Run on the CPU:  JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")

RUNS = {
    "small": dict(width=128, height=96, frames=6, seed=3, chunk=3),
    "720p": dict(width=1280, height=720, frames=17, seed=0, chunk=8),
}


def slice_config(width: int, height: int):
    from homerhevc_tpu.config import EncoderConfig, PerformanceMode
    return EncoderConfig(
        width=width, height=height, qp=32, cu_size=32, intra_period=100,
        me_search_range=16, sign_hiding=True, deblocking=True,
        sample_adaptive_offset=True, frame_pipeline_depth=2,
        performance_mode=PerformanceMode.FASTEST_COMPUTATION)


def clip(name: str) -> list:
    """The frames [(y, u, v), ...] of one of RUNS, made from its seed."""
    from homerhevc_tpu.utils.synth import synth_clip
    r = RUNS[name]
    return list(synth_clip(r["width"], r["height"], r["frames"],
                           seed=r["seed"]))


def decode_check(aus, recon_y):
    """Decode the stream in libde265 and compare its last luma plane with
    `recon_y`: True or False, or None where libde265 does not load."""
    import numpy as np

    from homerhevc_tpu.validate import de265
    if not de265.available():
        return None
    dec = de265.decode_annexb(b"".join(aus))
    return len(dec) == len(aus) and np.array_equal(dec[-1][0], recon_y)


def au_digest(aus) -> list:
    return [{"sha256": hashlib.sha256(a).hexdigest(), "len": len(a)}
            for a in aus]


def jax_run(name: str) -> list:
    """AUs of the JAX package for one of RUNS (imports jax)."""
    from homerhevc_tpu.api import HomerEncoder
    r = RUNS[name]
    enc = HomerEncoder(slice_config(r["width"], r["height"]), backend="jax",
                       fetch_recon=False)
    try:
        return enc.encode_frames(clip(name), chunk=r["chunk"])
    finally:
        enc.close()


def main() -> int:
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
