"""entropy_ms (layer host entropy): milliseconds per frame of the host's
level scatter, block decisions and CABAC: `chunk.scatter` +
`chunk.decisions` + `chunk.entropy` in segments, `p.decisions+maps` +
`entropy` per frame, over the window's untraced calls."""

PROBES = ("chunk.scatter", "chunk.decisions", "chunk.entropy",
          "p.decisions+maps", "entropy")


def read(run):
    totals, _, frames = run.probe_totals()
    if not frames:
        return None
    return sum(totals.get(p, 0.0) for p in PROBES) * 1e3 / frames
