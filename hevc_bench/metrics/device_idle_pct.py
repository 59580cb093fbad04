"""device_idle_pct (layer device): the share of the traced slice's wall
time in which no kernel, copy or set ran on the card."""


def read(run):
    t = run.trace
    if t is None or t["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["slice_s"])
