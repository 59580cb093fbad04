"""Where the time goes in the torch port on one GPU (1280x720 slice).

    python3 tools/profile_torch_port.py

Profiles, with torch.profiler (CPU + CUDA activities), one IDR device stage
and one P chunk of 8 frames (device stage only, no host CABAC) after a
warm-up, and prints for each window: wall time, summed device kernel time,
device busy share (kernel time / wall), CUDA kernel launches, and the top
operators by device time. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _window(name, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()                                           # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type.name == "CUDA")
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    print(f"{name}: wall {wall * 1000:.1f} ms, device kernels "
          f"{dev_us / 1000:.1f} ms, busy {dev_us / 1e6 / wall:.1%}, "
          f"{launches} kernel launches")
    print(events.table(sort_by="self_device_time_total", row_limit=12,
                       max_name_column_width=48))


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.device import require_cuda
    from homerhevc_tpu_torch.pipeline import intra_torch, p_chunk
    from homerhevc_tpu_torch.utils.fixtures import slice_config
    from homerhevc_tpu_torch.utils.synth import synth_clip

    dev = require_cuda()

    frames = list(synth_clip(1280, 720, 9, seed=0))
    enc = HomerEncoder(slice_config(1280, 720), device=dev)
    enc.encode_frames(frames[:1])                  # IDR -> reference planes
    padded = [enc._pad_frame(*f) for f in frames]
    y0, u0, v0 = (torch.as_tensor(p, device=dev) for p in padded[0])
    ys, us, vs = (torch.as_tensor(np.stack([p[k] for p in padded[1:9]]),
                                  device=dev) for k in range(3))
    qps = torch.full((8,), 32, dtype=torch.int32, device=dev)
    ref = enc._ref

    _window("idr", lambda: intra_torch.encode_frame_intra(
        y0, u0, v0, B=32, qp=32, sign_hiding=True))
    _window("p_chunk8", lambda: p_chunk.p_chunk_device(
        ys, us, vs, *ref, qps, ctu=32, search=16, me_precision=2,
        sign_hiding=True, deblock=True, sao=True, cap=enc._chunk_cap))
    enc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
