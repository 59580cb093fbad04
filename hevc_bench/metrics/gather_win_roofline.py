"""gather_win_roofline (layer kernels): the least time of the cell's
gather_win sites (hevc_bench/roofline.py: each site's distinct plane
samples read once and windows written once, at 3.35 TB/s), summed over
the sites, over the kernel's mean device time per launch in the traced
slice times the number of sites. None where the slice ran no gather.

Only the port's own kernels of kernels/gather_win.cu count, by their
names (gather_kernel<G>, gather_span_kernel, gather_generic_kernel):
PyTorch's own gathers (`_scatter_gather_elementwise_kernel`, which
torch.gather and scatter_add launch) are other kernels. Their number in
the slice has to equal the launches that `GATHER_WIN` counted there."""

import re

from hevc_bench import roofline

FASTEST, FASTER, FAST, FULL = 3, 2, 1, 0
# a kernel's name as the profiler gives it, e.g.
# "void (anonymous namespace)::gather_kernel<73>((anonymous namespace)::Args)"
KERNEL = re.compile(r"(?:^|[\s:])gather_(?:kernel<|span_kernel\b|"
                    r"generic_kernel\b)")


def cu_sizes(c):
    """CU sizes of the P stage: the CTU alone with fixed CUs; the quadtree
    from the CTU down to 16 (8 in FULL)."""
    if int(c.performance_mode) >= FASTER:
        return [c.ctu_size]
    low = 8 if int(c.performance_mode) == FULL else 16
    sizes, b = [], c.ctu_size
    while b >= low:
        sizes.append(b)
        b //= 2
    return sizes


def read(run):
    if run.trace is None:
        return None
    t, n = 0.0, 0
    for name, (secs, count) in run.trace["kernels"].items():
        if KERNEL.search(name) and "at::native" not in name:
            t += secs
            n += count
    counted = run.counters.get("gather_win", 0)
    if n != counted:
        raise RuntimeError(f"gather_win: {n} kernels in the trace, "
                           f"{counted} launches counted")
    if not n:
        return None
    c = run.cfg
    sites = roofline.gather_sites(c.padded_height, c.padded_width,
                                  cu_sizes(c), c.me_search_range)
    return 100.0 * roofline.gather_least_s(sites) / (len(sites) * t / n)
