"""Lightweight stage profiler; the port's own copy of
homerhevc_tpu/utils/profiler.py. Role of the reference's hmr_profiler.c
(QueryPerformanceCounter/clock_gettime probes gated by _TIME_PROFILING_,
hmr_profiler.h:29-41): named accumulating timers around encoder stages.

Enabled explicitly (zero overhead when disabled); report() prints the
per-stage breakdown like the reference's profiler_print_data. A probe reads
the host's clock only: around launches it measures their dispatch, and the
probe whose stage fetches a result to the host carries the wait for the
device.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.acc = defaultdict(float)
        self.count = defaultdict(int)

    @contextmanager
    def probe(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> str:
        if not self.acc:
            return "profiler: no samples"
        total = sum(self.acc.values())
        lines = ["profiler: stage breakdown"]
        for name, t in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            n = self.count[name]
            lines.append(f"  {name:<24s} {t * 1e3:9.1f} ms  "
                         f"({t / max(total, 1e-12) * 100:5.1f}%)  "
                         f"x{n}  {t / n * 1e3:8.2f} ms/call")
        lines.append(f"  {'total':<24s} {total * 1e3:9.1f} ms")
        return "\n".join(lines)


NULL = Profiler(enabled=False)
