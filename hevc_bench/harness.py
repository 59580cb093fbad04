"""The benchmark harness: find a cell's files by name, set the session up,
run the measured window, read the metrics, check the output, print the
result line.

Everything of one configuration, traffic mix or metric lives in a file of
its own, found by the name that BENCHMARK.json gives it:

- configuration: the `file` of its entry under `configs` (a JSON file
  under hevc_bench/configs/ with the EncoderConfig keywords under
  `encoder`);
- traffic mix: hevc_bench/traffic/<traffic>.json;
- metric: hevc_bench/metrics/<name>.py, whose `read(run)` returns the
  number or None when the run has nothing for it to read.

The session is driven only through `HomerEncoder`'s public calls. The one
thing read from inside it is the reference picture it holds between
calls (`HomerEncoder._ref`, the decoded picture buffer), copied on the
device at a few call boundaries for the output check: the public
`fetch_recon=True` would fetch every frame's picture to the host inside
the timed path.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib.util
import json
import os
import random
import sys
import time

from . import synth
from .trace import HostProbes, Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "homerhevc_tpu")
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (homerhevc_tpu_torch is not homerhevc_tpu)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Manifest:
    """BENCHMARK.json and the files it names."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.cells[name]

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root, self.configs[name]["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.root, "hevc_bench", "traffic",
                               name + ".json")) as f:
            return json.load(f)

    def reader(self, name: str):
        """The module hevc_bench/metrics/<name>.py."""
        path = os.path.join(self.root, "hevc_bench", "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "hevc_bench.metrics." + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end metrics (trace 0) or per-layer ones."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def encoder_config(conf: dict, traffic: dict, overrides=None):
    """The port's EncoderConfig from a configuration file, with the
    traffic's pipeline depth and any test overrides."""
    from homerhevc_tpu_torch.config import EncoderConfig
    kw = dict(conf["encoder"])
    if "depth" in traffic:
        kw["frame_pipeline_depth"] = traffic["depth"]
    kw.update(overrides or {})
    defaults = EncoderConfig()
    for k, v in kw.items():
        cur = getattr(defaults, k)
        if isinstance(cur, enum.Enum):
            kw[k] = type(cur)(v)
    return EncoderConfig(**kw)


@dataclasses.dataclass
class Call:
    pos: int            # index of the call's first frame in the clip
    n: int              # frames offered
    t0: float
    t1: float
    aus: list


@dataclasses.dataclass
class Run:
    """What a run measured and kept for its readers and its check."""
    cell: dict
    conf: dict
    traffic: dict
    cfg: object
    clip: object
    frames: list
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = dataclasses.field(default_factory=list)
    setup_aus: list = dataclasses.field(default_factory=list)
    snaps: dict = dataclasses.field(default_factory=dict)
    probes: HostProbes | None = None
    trace: dict | None = None
    slice_host: tuple | None = None
    window_host: tuple = (0.0, 0.0)
    slice_calls: tuple = (0, 0)
    counters: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    check_notes: list = dataclasses.field(default_factory=list)
    check_printed: dict = dataclasses.field(default_factory=dict)
    setup_parts: dict = dataclasses.field(default_factory=dict)

    @property
    def window_frames(self) -> int:
        return sum(c.n for c in self.calls)

    def frames_in(self, calls) -> int:
        return sum(c.n for c in calls)

    def untraced_calls(self) -> list:
        a, b = self.slice_calls
        return [c for i, c in enumerate(self.calls) if not a <= i < b]

    def traced_calls(self) -> list:
        a, b = self.slice_calls
        return self.calls[a:b]

    def probe_totals(self) -> tuple:
        """(seconds per probe, calls per probe, frames) over the window's
        untraced calls."""
        return (self.probes.totals(self.window_host, self.slice_host),
                self.probes.counts(self.window_host, self.slice_host),
                self.frames_in(self.untraced_calls()))


class Playback:
    """The clip's frames in playback order (synth.play), indexed by
    playback position: frames[p] or frames[a:b]."""

    def __init__(self, frames):
        self.frames = frames

    def __getitem__(self, k):
        n = len(self.frames)
        if isinstance(k, slice):
            return [self.frames[synth.play(p, n)]
                    for p in range(k.start, k.stop)]
        return self.frames[synth.play(k, n)]

    def motion(self, clip, p: int):
        """True motion of position p's texture from position p - 1's
        (synth.Clip.motion)."""
        n = len(self.frames)
        return clip.motion(synth.play(p, n), synth.play(p - 1, n))

    def is_cut(self, clip, p: int) -> bool:
        """A hard cut falls between positions p - 1 and p."""
        n = len(self.frames)
        return p > 0 and clip.shot(synth.play(p, n)) != clip.shot(
            synth.play(p - 1, n))


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _snapshot(enc):
    """A device copy of the session's reference planes (padded Y, U, V)."""
    return tuple(p.clone() for p in enc._ref)


def _counters():
    from homerhevc_tpu_torch.ops import gather, me
    return dict(me_sad=me.ME_SAD.launches,
                gather_win=gather.GATHER_WIN.launches)


def build_libraries(cfg) -> None:
    """Build, on a checkout's first run, or else load, the port's native
    libraries that the cell's path uses (host CABAC; gather_win; me_sad at
    search ranges that take the full sweep), so that their build time
    shows apart among set-up's parts."""
    from homerhevc_tpu_torch.entropy import native_backend
    from homerhevc_tpu_torch.ops import gather, me
    from homerhevc_tpu_torch.pipeline.p_torch import HIER_THRESHOLD
    native_backend.build_library()
    gather.GATHER_WIN.load()
    if cfg.me_search_range <= HIER_THRESHOLD:
        me.ME_SAD.load()


def drive(manifest: Manifest, cell_name: str, seed: int, seconds: float,
          trace: bool, *, t_start: float, device=None, overrides=None,
          session_hook=None) -> Run:
    """Set up the cell's session, run the window, keep what the metrics
    and the check read. `device`, `overrides` and `session_hook` (called
    with the session before set-up) serve the CPU tests only."""
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder

    marks = [("start", time.perf_counter())]
    cell = manifest.cell(cell_name)
    conf = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    cfg = encoder_config(conf, traffic, overrides)
    segments = traffic["delivery"] == "segments"
    per_call = traffic["segment_frames"] if segments else 1
    unit = traffic["check_frames"]
    if unit % per_call:
        raise ValueError("check_frames must be a whole number of calls")
    warm = traffic["warmup_frames"]
    clip = synth.Clip(cfg.width, cfg.height, seed=seed, **traffic["clip"])
    clip_frames = clip.frames(0, traffic["clip_frames"])
    frames = Playback(clip_frames)
    marks.append(("clip", time.perf_counter()))
    probes = HostProbes() if trace else None
    run = Run(cell=cell, conf=conf, traffic=traffic, cfg=cfg, clip=clip,
              frames=frames, probes=probes)

    if device is None:
        build_libraries(cfg)
        marks.append(("builds", time.perf_counter()))
    enc = HomerEncoder(cfg, device=device, kernels=True, fetch_recon=False,
                       profiler=probes)
    if session_hook is not None:
        session_hook(enc)
    dev = enc.device
    marks.append(("session", time.perf_counter()))
    if conf["start"] == "idr":
        run.setup_aus.append(enc.encode_frame(*frames[0]))
    elif conf["start"] == "seeded_reference":
        enc.seed_reference(synth.padded(frames[0], cfg.padded_height,
                                        cfg.padded_width), poc=1)
    else:
        raise ValueError(f"unknown start {conf['start']!r}")

    def deliver(pos, n):
        if segments:
            return enc.encode_frames(frames[pos:pos + n],
                                     chunk=traffic["chunk"])
        return [enc.encode_frame(*frames[pos])]

    _sync(dev)
    marks.append(("first_frame", time.perf_counter()))
    pos = 1
    for p in range(pos, pos + warm, per_call):
        run.setup_aus += deliver(p, min(per_call, pos + warm - p))
    pos += warm
    _sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - t_start
    marks.append(("warm_up", t_start + run.setup_s))
    run.setup_parts = {"imports": marks[0][1] - t_start}
    run.setup_parts.update({b[0]: b[1] - a[1]
                            for a, b in zip(marks, marks[1:])})

    pos0 = pos
    run.snaps[pos] = _snapshot(enc)

    def call():
        nonlocal pos
        ta = time.perf_counter()
        aus = deliver(pos, per_call)
        run.calls.append(Call(pos, per_call, ta, time.perf_counter(), aus))
        pos += per_call
        if (pos - pos0) % unit == 0:
            run.snaps[pos] = _snapshot(enc)

    t0 = time.perf_counter()
    # the window closes on time, once one run of check_frames is complete
    while time.perf_counter() - t0 < seconds or pos - pos0 < unit:
        call()
    _sync(dev)
    run.window_s = time.perf_counter() - t0
    run.window_host = (t0, t0 + run.window_s)
    if trace:
        # the traced slice follows the window: the profiler's hooks slow
        # the host for the rest of a process once it has run
        before = _counters()
        tracer = Trace(probes)
        tracer.start()
        first = len(run.calls)
        for _ in range(traffic["trace_calls"]):
            call()
        tracer.stop()
        after = _counters()
        run.counters = {k: after[k] - before[k] for k in after}
        run.slice_host = tuple(tracer.host)
        run.slice_calls = (first, len(run.calls))
        run.trace = tracer.summary()
    if torch.device(dev).type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    # the program's state goes before the reference runs: keep the
    # snapshots the check reads, on the host
    run.snaps = {k: tuple(p.cpu().numpy() for p in v)
                 for k, v in run.snaps.items()}
    enc.close()
    del enc
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return run


def check_unit(run: Run, seed: int) -> int:
    """First frame of the run of `check_frames` frames the check decodes:
    drawn from the seed among those the window completed."""
    unit = run.traffic["check_frames"]
    starts = sorted(s for s in run.snaps if s + unit in run.snaps)
    if not starts:
        raise RuntimeError("the window completed no run of check_frames")
    return random.Random(seed).choice(starts)


def read_metrics(manifest: Manifest, run: Run, entries) -> dict:
    out = {}
    for m in entries:
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def is_correct(checks: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in checks.values())


def result_line(run: Run, checks: dict, failed: int, metrics: dict,
                trace: bool) -> dict:
    """The result's JSON object; `checks` ({name: {value, limit}}, each
    correct when value <= limit) comes last."""
    from . import card
    line = dict(correct=is_correct(checks),
                attempted=run.window_frames, failed=failed, metrics=metrics,
                device=card.device_block(run.cell["chips"],
                                         run.memory_peak_bytes,
                                         run.trace if trace else None))
    if trace and run.trace is not None:
        line["breakdown"] = dict(device_ops=run.trace["device_ops"],
                                 idle_gaps=run.trace["idle_gaps"])
    line["checks"] = checks
    return line


def fail(msg: str, code: int = 2) -> int:
    print(f"hevc_bench: {msg}", file=sys.stderr, flush=True)
    return code


def main(args, *, root: str, t_start: float) -> int:
    os.makedirs(CACHE, exist_ok=True)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    bad = forbidden_modules()
    if bad:
        return fail(f"forbidden modules loaded at start: {bad}")
    try:
        manifest = Manifest(root)
        cell = manifest.cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot read the benchmark: {e}")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: torch.cuda.is_available() is False", 3)
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"the cell needs {cell['chips']} CUDA devices, "
                    f"{torch.cuda.device_count()} present", 3)
    try:
        import homerhevc_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program is not here: {e}")
    from . import card, check
    print(f"card: {card.card_line()}", file=sys.stderr, flush=True)
    run = drive(manifest, args.workload, args.seed, args.seconds,
                bool(args.trace), t_start=t_start)
    metrics = read_metrics(manifest, run,
                           manifest.metrics(args.workload, bool(args.trace)))
    for line in run_notes(run):
        print(line, file=sys.stderr, flush=True)
    t_check = time.perf_counter()
    checks, failed = check.verify(run, check_unit(run, args.seed))
    print(f"check: {time.perf_counter() - t_check:.1f} s of reference "
          f"decoding; not compared: {json.dumps(run.check_printed)}; notes "
          f"{run.check_notes}", file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        return fail(f"forbidden modules loaded after the window: {bad}")
    line = result_line(run, checks, failed, metrics, bool(args.trace))
    for name, v in line["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def run_notes(run: Run) -> list:
    """Lines for standard error: what the metrics rest on."""
    import statistics
    out = [f"window: {run.window_frames} frames in {run.window_s:.4f} s, "
           f"{len(run.calls)} calls; setup {run.setup_s:.4f} s ("
           + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items())
           + ")"]
    if run.traffic["delivery"] == "frames":
        ms = [(c.t1 - c.t0) * 1e3 for c in run.calls]
        out.append(f"frame ms: median {statistics.median(ms):.4f}, "
                   f"n {len(ms)}")
    if run.trace is not None:
        nf = run.frames_in(run.traced_calls())
        out.append(f"traced slice: {nf} frames in {run.trace['slice_s']:.4f}"
                   f" s, busy {run.trace['busy_s']:.4f} s, "
                   f"{run.trace['launches']} kernels; per frame me_sad "
                   f"{run.counters.get('me_sad', 0) / max(nf, 1):.3f}, "
                   f"gather_win "
                   f"{run.counters.get('gather_win', 0) / max(nf, 1):.3f}")
    return out
