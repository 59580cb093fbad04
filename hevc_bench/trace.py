"""Host probes and the device trace of a traced run.

`HostProbes` stands in for the port's `utils.profiler.Profiler` (the
session calls `probe(name)` around its stages): it keeps every span with
its host-clock start and end, and while the device trace runs it also
marks each span in that trace (`record_function`), so an idle gap of the
device can be put down to the host stage that ran across it.

`Trace` runs torch.profiler (CPU and CUDA activity) over a slice of the
window and reduces it to what the per-layer readers use: the device's
busy time (the union of its kernels, copies and sets), the kernels with
their durations, and the idle gaps. The busy-share and launch arithmetic
is a frozen copy of `tools/profile_torch_port.py`'s: device time over wall
time, kernels counted on the device side.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

PROBE_PREFIX = "probe:"
SLICE_NAME = "bench.slice"
# device activity that is not a kernel launch
_NOT_KERNELS = ("Memcpy", "Memset")


class HostProbes:
    """Profiler for `HomerEncoder(profiler=)` that keeps each span."""

    def __init__(self):
        self.spans = []           # (name, t0, t1), host clock seconds
        self.mark = False         # also mark spans in the device trace

    @contextmanager
    def probe(self, name: str):
        t0 = time.perf_counter()
        rf = None
        if self.mark:
            import torch
            rf = torch.profiler.record_function(PROBE_PREFIX + name)
            rf.__enter__()
        try:
            yield
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append((name, t0, time.perf_counter()))

    def _kept(self, window, outside):
        for name, t0, t1 in self.spans:
            if not window[0] <= t0 <= window[1]:
                continue
            if outside is not None and outside[0] <= t0 <= outside[1]:
                continue
            yield name, t0, t1

    def totals(self, window, outside=None) -> dict:
        """Seconds per probe name over the spans that start inside
        `window` (t0, t1), leaving out those that start inside `outside`:
        the traced slice, which the profiler slows."""
        out = {}
        for name, t0, t1 in self._kept(window, outside):
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return out

    def counts(self, window, outside=None) -> dict:
        out = {}
        for name, _, _ in self._kept(window, outside):
            out[name] = out.get(name, 0) + 1
        return out


def merged(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """torch.profiler over a slice of the window."""

    def __init__(self, probes: HostProbes | None):
        self.probes = probes
        self.prof = None
        self.rf = None
        self.host = None          # host-clock (t0, t1) of the slice

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        if self.probes is not None:
            self.probes.mark = True
        self.rf = torch.profiler.record_function(SLICE_NAME)
        self.rf.__enter__()
        self.host = [time.perf_counter(), None]

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.host[1] = time.perf_counter()
        self.rf.__exit__(None, None, None)
        if self.probes is not None:
            self.probes.mark = False
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """Reduce the trace: slice length, busy seconds, kernels, gaps."""
        events = self.prof.profiler.kineto_results.events()
        slice_ns = None
        probes, device, kernels = [], [], []
        for ev in events:
            name = ev.name()
            t0 = ev.start_ns()
            t1 = t0 + ev.duration_ns()
            if ev.device_type().name == "CUDA":
                if name == SLICE_NAME or name.startswith(PROBE_PREFIX):
                    continue        # the ranges' marks on the device row
                device.append((t0, t1))
                if not name.startswith(_NOT_KERNELS):
                    kernels.append((name, t0, t1))
            elif name == SLICE_NAME:
                slice_ns = (t0, t1)
            elif name.startswith(PROBE_PREFIX):
                probes.append((name[len(PROBE_PREFIX):], t0, t1))
        if slice_ns is None:
            raise RuntimeError("the trace holds no slice range")
        s0, s1 = slice_ns
        busy = merged([(max(a, s0), min(b, s1)) for a, b in device
                       if b > s0 and a < s1])
        busy_ns = sum(b - a for a, b in busy)
        gaps, prev = [], s0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if s1 > prev:
            gaps.append((prev, s1))
        gaps.sort(key=lambda g: g[0] - g[1])
        named_gaps = [(_host_stage(probes, g), (g[1] - g[0]) * 1e-9)
                      for g in gaps[:10]]
        per_name = {}
        for name, t0, t1 in kernels:
            if s0 <= t0 <= s1:
                tot = per_name.setdefault(name, [0, 0])
                tot[0] += t1 - t0
                tot[1] += 1
        top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
        return dict(
            slice_s=(s1 - s0) * 1e-9, busy_s=busy_ns * 1e-9,
            launches=sum(n for _, n in per_name.values()),
            kernels={k: (v[0] * 1e-9, v[1]) for k, v in per_name.items()},
            device_ops=[[name[:160], v[0] * 1e-9] for name, v in top],
            idle_gaps=[[name, s] for name, s in named_gaps])


def _host_stage(probes, gap) -> str:
    """The probe that overlaps the gap (a0, a1) most; 'unprobed' where
    none does (the harness's loop, the session's Python between
    probes)."""
    a0, a1 = gap
    best, best_ov = "unprobed", 0
    for name, t0, t1 in probes:
        ov = min(a1, t1) - max(a0, t0)
        if ov > best_ov:
            best, best_ov = name, ov
    return best
