"""The port's reference runs: the slice configuration, the seeded clips, the
AU digest and the decoder check that chip_smoke.py and the tests share.

tests/fixtures/torch_port_aus.json holds the SHA-256 and length of every AU
the JAX package writes for each of RUNS (tools/make_torch_fixtures.py writes
it, with the same RUNS and the same configuration keywords); the port's AUs
must hash the same. Both runs use the slice configuration
(FASTEST_COMPUTATION, cu_size 32, search 16, quarter-pel, fixed QP 32,
deblocking + SAO + sign hiding, intra_period 100, frame_pipeline_depth 2):

  small: synth_clip(128, 96, 6, seed=3), encode_frames(chunk=3)
  720p:  synth_clip(1280, 720, 17, seed=0), encode_frames(chunk=8)
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..config import EncoderConfig, PerformanceMode
from ..validate import de265
from .synth import synth_clip

RUNS = {
    "small": dict(width=128, height=96, frames=6, seed=3, chunk=3),
    "720p": dict(width=1280, height=720, frames=17, seed=0, chunk=8),
}


def slice_kwargs(width: int, height: int) -> dict:
    """Keywords of the slice configuration, enums by name, so either
    package can build its own EncoderConfig from them."""
    return dict(width=width, height=height, qp=32, cu_size=32,
                intra_period=100, me_search_range=16, sign_hiding=True,
                deblocking=True, sample_adaptive_offset=True,
                frame_pipeline_depth=2,
                performance_mode="FASTEST_COMPUTATION")


def slice_config(width: int, height: int) -> EncoderConfig:
    kw = slice_kwargs(width, height)
    kw["performance_mode"] = PerformanceMode[kw["performance_mode"]]
    return EncoderConfig(**kw)


def clip(name: str) -> list:
    """The frames [(y, u, v), ...] of one of RUNS, made from its seed."""
    r = RUNS[name]
    return list(synth_clip(r["width"], r["height"], r["frames"],
                           seed=r["seed"]))


def au_digest(aus) -> list:
    return [{"sha256": hashlib.sha256(a).hexdigest(), "len": len(a)}
            for a in aus]


def decode_check(aus, recon_y):
    """Decode the stream in libde265 and compare its last luma plane with
    `recon_y`: True or False, or None where libde265 does not load."""
    if not de265.available():
        return None
    dec = de265.decode_annexb(b"".join(aus))
    return len(dec) == len(aus) and np.array_equal(dec[-1][0], recon_y)
