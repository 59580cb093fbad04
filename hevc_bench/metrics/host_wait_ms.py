"""host_wait_ms (layer session): milliseconds per frame the host spends
blocked on the device in the session's `*.fetch` probes (`chunk.fetch` in
segments, `p.fetch` per frame), over the window's untraced calls."""

WAIT_PROBES = ("chunk.fetch", "p.fetch")


def read(run):
    totals, _, frames = run.probe_totals()
    if not frames:
        return None
    return sum(totals.get(p, 0.0) for p in WAIT_PROBES) * 1e3 / frames
