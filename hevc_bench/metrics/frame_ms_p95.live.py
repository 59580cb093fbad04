"""frame_ms_p95.live (layer session): the 95th percentile, over every frame
of the window's untraced calls, of the time from the call of encode_frame
to the return of its AU (one frame per call). None where the traffic
delivers frames in segments. Read in the traced run: as an end-to-end
metric it spread wider across runs than a bound can hold (PERF.md)."""

import numpy as np


def read(run):
    if run.traffic["delivery"] != "frames":
        return None
    ms = [(c.t1 - c.t0) * 1e3 for c in run.untraced_calls()]
    return float(np.percentile(ms, 95)) if ms else None
