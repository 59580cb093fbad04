"""End-to-end metrics are taken over the whole window and every frame;
the result line has the contract's keys, with the checks last."""

import json
import types

import numpy as np
import pytest

from hevc_bench import harness, roofline


def _run(traffic, durations, n, window_s):
    calls, t = [], 0.0
    for d in durations:
        calls.append(harness.Call(pos=len(calls) * n, n=n, t0=t, t1=t + d,
                                  aus=[b"x"] * n))
        t += d
    return harness.Run(cell=dict(name="c", chips=1), conf={},
                       traffic=traffic, cfg=None, clip=None, frames=[],
                       setup_s=12.5, window_s=window_s, calls=calls)


@pytest.fixture
def manifest(root):
    return harness.Manifest(root)


def test_fps_is_all_frames_over_all_time(manifest):
    # three segments of 32 frames, one slow: fps is 96 / 10 s, not the
    # median of the segments' rates
    run = _run(dict(delivery="segments"), [2.0, 2.0, 6.0], 32, 10.0)
    assert manifest.reader("fps").read(run) == pytest.approx(9.6)
    assert manifest.reader("frame_ms_p95.live").read(run) is None


def test_p95_over_every_frame(manifest):
    d = list(np.linspace(0.1, 0.2, 200))
    run = _run(dict(delivery="frames"), d, 1, sum(d[:184]))
    run.slice_calls = (184, 200)            # the traced calls are left out
    want = float(np.percentile([x * 1e3 for x in d[:184]], 95))
    assert manifest.reader("frame_ms_p95.live").read(run) == \
        pytest.approx(want)
    assert manifest.reader("fps").read(run) == pytest.approx(
        184 / sum(d[:184]))


def test_setup(manifest):
    run = _run(dict(delivery="frames"), [0.1], 1, 0.1)
    assert manifest.reader("setup_s").read(run) == 12.5


def test_trace_readers(manifest):
    run = _run(dict(delivery="segments"), [1.0, 1.0, 1.0], 32, 3.0)
    run.slice_calls = (1, 2)
    run.cfg = types.SimpleNamespace(padded_height=1088, padded_width=1920,
                                    ctu_size=64, me_search_range=64,
                                    performance_mode=3)
    sites = roofline.gather_sites(1088, 1920, [64], 64)
    assert [s[3] for s in sites] == [73, 35, 70]
    least = roofline.gather_least_s(sites)
    run.trace = dict(slice_s=1.0, busy_s=0.2, launches=32 * 5800,
                     kernels={
                         "void (anonymous namespace)::gather_kernel<73>("
                         "(anonymous namespace)::Args)": (32 * least, 32),
                         "void (anonymous namespace)::gather_kernel<35>("
                         "(anonymous namespace)::Args)": (32 * least, 32),
                         "void (anonymous namespace)::gather_kernel<70>("
                         "(anonymous namespace)::Args)": (32 * least, 32),
                         # PyTorch's own gather: not gather_win
                         "void at::native::_scatter_gather_elementwise_"
                         "kernel<128, 8, at::native::_cuda_scatter_gather_"
                         "internal_kernel<true, short>>": (100.0, 5000)})
    run.counters = dict(gather_win=96)
    assert manifest.reader("device_idle_pct").read(run) == pytest.approx(80)
    assert manifest.reader("launches_per_frame").read(run) == 5800
    # three sites at once take `least`; each launch took `least`
    assert manifest.reader("gather_win_roofline").read(run) == \
        pytest.approx(100 / 3)
    run.counters = dict(gather_win=97)
    with pytest.raises(RuntimeError, match="97 launches"):
        manifest.reader("gather_win_roofline").read(run)
    run.trace["kernels"] = {}
    run.counters = dict(gather_win=0)
    assert manifest.reader("gather_win_roofline").read(run) is None


def test_probe_readers(manifest):
    from hevc_bench.trace import HostProbes
    run = _run(dict(delivery="segments"), [1.0, 1.0, 1.0], 32, 3.0)
    run.probes = HostProbes()
    run.window_host = (0.0, 3.0)
    run.slice_calls, run.slice_host = (1, 2), (1.0, 2.0)
    run.probes.spans = [("chunk.fetch", 0.1, 0.2), ("chunk.entropy", 0.2,
                                                     0.5),
                        ("chunk.fetch", 1.1, 1.9),       # in the slice
                        ("chunk.scatter", 2.1, 2.2)]
    assert manifest.reader("host_wait_ms").read(run) == pytest.approx(
        100 / 64)
    assert manifest.reader("entropy_ms").read(run) == pytest.approx(
        400 / 64)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace, monkeypatch):
    from hevc_bench import card
    monkeypatch.setattr(card, "device_block",
                        lambda chips, peak, t=None: dict(
                            platform="gpu", kind="k", count=chips,
                            memory_peak_bytes=peak,
                            **({} if t is None else dict(busy_s=1.0,
                                                         window_s=2.0))))
    run = _run(dict(delivery="frames"), [0.1, 0.1], 1, 0.2)
    run.memory_peak_bytes = 5
    if trace:
        run.trace = dict(busy_s=1.0, slice_s=2.0, device_ops=[["k", 1.0]],
                         idle_gaps=[["entropy", 0.5]])
    checks = dict(recon_mismatch=dict(value=0, limit=0),
                  frames_missing=dict(value=0, limit=0))
    line = harness.result_line(run, checks, 0, {}, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["attempted"] == 2
    json.dumps(line)
    checks["frames_missing"]["value"] = 1
    assert harness.result_line(run, checks, 0, {}, trace)["correct"] is False
