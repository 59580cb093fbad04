"""CUDA graphs of the fixed-CU P frame's device step.

Eagerly, one fixed-CU P frame is some 5,000 to 6,000 small kernels, each
issued from Python: on the card the host's launches, not the device, set
the pace. `StepGraphs` captures the step once per static key as a
`torch.cuda.CUDAGraph` and replays it for every later frame of that key:

- the key is what the step observes: its function and keywords (sizes,
  search, ME precision, sign hiding, loop filter, `kernels`, the wire's
  capacity) and the shapes and dtypes of its inputs;
- the first frame of a key runs eagerly: it fills `device.const`, the
  lru_cache'd tables and the allocator, so nothing is uploaded from the
  host inside a capture; the second frame is captured (on a side stream,
  as `torch.cuda.graph` does) and replayed, and every later one replayed;
- the graph reads static input tensors, into which each call copies the
  frame, the reference planes and the QP (a Python int is `fill_`ed), and
  writes output tensors of its own pool, which the next replay
  overwrites: the caller copies out whatever it keeps past that;
- the launches of the hand-written kernels that a graph holds count on
  each replay, when the device runs them, and not at capture
  (`CudaKernel.launches`).

Engagement follows the device (`engaged`): a session on a CUDA device with
no band mesh replays; the CPU, the quadtree and the band mesh run the step
eagerly. On a device other than CUDA a `StepGraph` runs the step on its
static buffers in place of a replay and copies the results into its
output buffers: the same buffer discipline, which the CPU tests check.
"""

from __future__ import annotations

import torch

from ..device import I32
from ..kernels.build import KERNELS


class GraphCounts:
    """Fixed-CU P frames that went through `StepGraphs`, counted as
    `CudaKernel.launches` is: `captures` (graphs captured, one per key),
    `replays` (frames whose outputs came from a replay, each capturing
    frame's included) and `eager` (each key's first frame, run without a
    graph). The hit share is replays / (replays + eager)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.eager = 0


P_GRAPH = GraphCounts()


def engaged(device) -> bool:
    """Whether a session on `device` (with no band mesh) replays its
    fixed-CU P step from CUDA graphs."""
    return torch.device(device).type == "cuda"


class StepGraph:
    """One step `fn` captured over static copies of its inputs; a call
    copies new inputs in and replays it. Tensors in, tuple of tensors
    out."""

    def __init__(self, fn, inputs):
        self.fn = fn
        dev = next(x.device for x in inputs if isinstance(x, torch.Tensor))
        self.inputs = tuple(torch.empty_like(x) if isinstance(x, torch.Tensor)
                            else torch.empty((), dtype=I32, device=dev)
                            for x in inputs)
        self.outputs = None
        self.graph = None
        self.launches = {}       # kernel -> its launches in the graph
        if dev.type == "cuda":
            before = {k: k.launches for k in KERNELS}
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = tuple(fn(*self.inputs))
            for k, n in before.items():
                self.launches[k] = k.launches - n
                k.launches = n           # recorded, not run
        P_GRAPH.captures += 1

    def _set(self, inputs) -> None:
        for s, x in zip(self.inputs, inputs):
            if isinstance(x, torch.Tensor):
                s.copy_(x)
            else:
                s.fill_(x)

    def __call__(self, *inputs) -> tuple:
        self._set(inputs)
        if self.graph is not None:
            self.graph.replay()
            for k, n in self.launches.items():
                k.launches += n
        else:                            # the CPU form
            outs = tuple(self.fn(*self.inputs))
            if self.outputs is None:
                self.outputs = tuple(torch.empty_like(t) for t in outs)
            for s, t in zip(self.outputs, outs):
                s.copy_(t)
        P_GRAPH.replays += 1
        return self.outputs


class StepGraphs:
    """A session's captured steps by key (see the module docstring)."""

    def __init__(self):
        self._steps = {}

    def run(self, fn, inputs) -> tuple:
        """`fn` (a functools.partial over keywords that hash) on `inputs`
        (tensors and ints): eagerly for its key's first frame, else from
        the key's graph, whose output tensors the next call overwrites."""
        key = (fn.func, tuple(sorted(fn.keywords.items())),
               tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                     else type(x) for x in inputs))
        step = self._steps.get(key)
        if step is None:
            self._steps[key] = False     # warmed up: capture next time
            P_GRAPH.eager += 1
            dev = next(x.device for x in inputs
                       if isinstance(x, torch.Tensor))
            return tuple(fn(*(x if isinstance(x, torch.Tensor)
                              else torch.full((), x, dtype=I32, device=dev)
                              for x in inputs)))
        if step is False:
            step = self._steps[key] = StepGraph(fn, inputs)
        return step(*inputs)
