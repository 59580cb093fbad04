"""The fixed-CU P step through the session's CUDA graphs
(homerhevc_tpu_torch/pipeline/p_graph.py), on the CPU.

`p_graph.engaged` is made to answer yes for the CPU, so a session's
graphs take their CPU form: each call copies its inputs into the graph's
static buffers, runs the step on them in place of a replay and copies the
results into the graph's output buffers, which the next call overwrites.
Through both call sites, encode_frames' chunk path and encode_frame's
per-frame path, a graphed session must

  * write the AUs of a session that calls the step directly, and the
    fixture's (tests/fixtures/torch_port_aus.json) where it has the run;
  * hold at every call boundary (`HomerEncoder._ref`, which the benchmark
    copies there) the direct session's reference planes, and still hold
    them after later calls: nothing it hands out is a graph's buffer;
  * count in P_GRAPH one eager (warm-up) frame, one capture and a replay
    for every later P frame.

Also here: `device.take` against PyTorch's indexing, and the host's map of
nonzero 4x4 units (`api._nz_units`) against numpy's block reduction.
Tolerance: exact.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from homerhevc_tpu_torch.api import HomerEncoder, _nz_units
from homerhevc_tpu_torch.device import take
from homerhevc_tpu_torch.pipeline import p_graph
from homerhevc_tpu_torch.utils import fixtures as fx
from homerhevc_tpu_torch.utils.synth import synth_clip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")

# FASTEST at CTU 64 and search 64 (the benchmark's P stage: hierarchical
# search and gather_win), an IDR and 6 P frames, with SAO and without (the
# per-frame path's reference is then the graph's deblocked planes
# themselves, not SAO's new ones); and a fixture run of the same P stage
# (FASTER, whose IDR is the split-RDO one), an IDR and 3 P
CLIPS = {
    "fastest64_s64": dict(width=192, height=128, frames=7, seed=3),
    "fastest64_s64_nosao": dict(width=192, height=128, frames=7, seed=3,
                                over=dict(sample_adaptive_offset=False)),
    "faster64_s64_small": fx.RUNS["faster64_s64_small"],
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module (see tests/test_torch_ctu64.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def clip_config(name: str):
    if name in fx.RUNS:
        return fx.run_config(name), fx.clip(name)
    r = CLIPS[name]
    cfg = fx.config_from(fx.slice_kwargs(r["width"], r["height"], cu_size=64,
                                         me_search_range=64,
                                         **r.get("over", {})))
    return cfg, list(synth_clip(r["width"], r["height"], r["frames"],
                                seed=r["seed"]))


def encode(cfg, frames, path: str):
    """The IDR, then the P frames in calls (two of encode_frames in chunks
    of 2, or one encode_frame each); returns the AUs, and at each call
    boundary the session's reference planes as handed out and a copy."""
    enc = HomerEncoder(cfg, device="cpu", fetch_recon=False)
    aus = [enc.encode_frame(*frames[0])]
    bounds = []
    if path == "chunk":
        half = 1 + (len(frames) - 1) // 2
        calls = [(1, half), (half, len(frames))]
    else:
        calls = [(k, k + 1) for k in range(1, len(frames))]
    for lo, hi in calls:
        if path == "chunk":
            aus += enc.encode_frames(frames[lo:hi], chunk=2)
        else:
            aus.append(enc.encode_frame(*frames[lo]))
        bounds.append((enc._ref, tuple(p.clone() for p in enc._ref)))
    graphed = enc._graphs is not None
    enc.close()
    return aus, bounds, graphed


@pytest.mark.parametrize("name", sorted(CLIPS))
@pytest.mark.parametrize("path", ["chunk", "frame"])
def test_graphed_step_buffers(monkeypatch, path, name):
    cfg, frames = clip_config(name)
    want, want_bounds, graphed = encode(cfg, frames, path)
    assert not graphed                     # the CPU: the step called directly
    monkeypatch.setattr(p_graph, "engaged", lambda device: True)
    before = dict(vars(p_graph.P_GRAPH))
    got, bounds, graphed = encode(cfg, frames, path)
    assert graphed
    moved = {k: v - before[k] for k, v in vars(p_graph.P_GRAPH).items()}
    n_p = len(frames) - 1
    assert moved == dict(captures=1, replays=n_p - 1, eager=1)
    assert got == want
    if name in fixture():
        assert fx.au_digest(got) == fixture()[name]["aus"]
    for (held, copy), (_, want_copy) in zip(bounds, want_bounds):
        for h, c, w in zip(held, copy, want_copy):
            assert torch.equal(c, w)
            assert torch.equal(h, w)       # not overwritten by later calls


@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 1, 1), (2, 4)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_take_equals_indexing(shape, dtype):
    table = torch.arange(100, 152, dtype=torch.int32) * 7
    idx = torch.randint(0, table.numel(), shape, dtype=dtype,
                        generator=torch.Generator().manual_seed(1))
    got = take(table, idx)
    want = table[idx]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [(128, 192), (1088, 1920)])
@pytest.mark.parametrize("density", [0.0, 0.002, 0.2])
def test_nz_units_equals_block_reduction(hw, density):
    H, W = hw
    rng = np.random.default_rng(7)
    lev = [((rng.random((h, w)) < density)
            * rng.integers(-3, 4, (h, w))).astype(np.int32)
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    uh, uw = H // 4, W // 4
    want = (np.any(lev[0].reshape(uh, 4, uw, 4) != 0, axis=(1, 3))
            | np.any(lev[1].reshape(uh, 2, uw, 2) != 0, axis=(1, 3))
            | np.any(lev[2].reshape(uh, 2, uw, 2) != 0, axis=(1, 3)))
    got = _nz_units(*lev)
    assert got.dtype == want.dtype and np.array_equal(got, want)
