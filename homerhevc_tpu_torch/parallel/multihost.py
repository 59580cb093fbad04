"""Multi-process frame-span pipeline over torch.distributed.

Port of homerhevc_tpu/parallel/multihost.py, the repo's counterpart of the
reference's engine chain: HomerHEVC runs up to 8 frame-parallel engine
threads daisy-chained by input- and output-order semaphores, handing the
reconstructed reference and the rate-control state from engine to engine
(hmr_encoder_lib.c:1470-1487, :3268-3279). Here processes take frame spans
round-robin, and the reconstructed reference planes move from process to
process at every span boundary.

The planes cross a span boundary as host arrays (`seed_reference` takes
numpy), so the process group is gloo's, over TCP: NCCL also refuses two
ranks on one GPU. Every process returns the whole stitched stream, byte for
byte the single-process session's.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

# bounds the rendezvous and every collective: a process whose peer died
# raises instead of waiting for ever
TIMEOUT = datetime.timedelta(seconds=120)


def init(process_id: int, num_processes: int,
         coordinator: str = "127.0.0.1:12355") -> None:
    """Join the gloo process group at `coordinator` (host:port of rank 0);
    nothing for one process."""
    if num_processes <= 1:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=num_processes,
                            timeout=TIMEOUT)


def _bcast_from(arrs, src_process: int) -> list:
    """The numpy arrays of process `src_process`, on every process (each
    process passes arrays of the same shapes and dtypes)."""
    out = []
    for a in arrs:
        t = torch.from_numpy(np.array(a, copy=True))
        if dist.is_initialized():
            dist.broadcast(t, src=src_process)
        out.append(t.numpy())
    return out


class GopPipeline:
    """Round-robin frame-span pipeline across processes.

    Process p encodes the spans s with s % num_processes == p; a span that
    does not start with an IDR receives the previous span's reconstructed
    reference planes from their owner, with the last IDR's POC, and
    continues the P chain through HomerEncoder.seed_reference. Each
    process's session runs on `device` (the card unless the caller asks for
    the CPU). `close()` leaves the process group."""

    def __init__(self, cfg, *, span: int = 8, device=None):
        self.cfg = cfg
        self.span = span
        self.device = device
        self.pid = dist.get_rank() if dist.is_initialized() else 0
        self.nproc = dist.get_world_size() if dist.is_initialized() else 1

    def _ref_shapes(self):
        c = self.cfg
        ph, pw = c.padded_height, c.padded_width
        return [(ph, pw), (ph // 2, pw // 2), (ph // 2, pw // 2)]

    def encode(self, frames) -> list:
        from ..api import HomerEncoder

        n = len(frames)
        spans = [(s, min(n, s + self.span)) for s in range(0, n, self.span)]
        aus_by_frame: dict[int, bytes] = {}
        ref = None
        last_idr = 0
        for si, (a, b) in enumerate(spans):
            owner = si % self.nproc
            if si > 0:
                prev_owner = (si - 1) % self.nproc
                send = ref if (self.pid == prev_owner and ref is not None) \
                    else [np.zeros(s, np.uint8) for s in self._ref_shapes()]
                # the IDR anchor travels with the planes so slice POC and
                # intra-period cadence match the single-process stream
                send = send + [np.array([last_idr], np.int32)]
                *ref, anchor = _bcast_from(send, prev_owner)
                last_idr = int(anchor[0])
            if self.pid == owner:
                enc = HomerEncoder(self.cfg, device=self.device,
                                   fetch_recon=False)
                if si > 0:
                    enc.seed_reference(ref, poc=a, last_idr=last_idr)
                for k in range(a, b):
                    aus_by_frame[k] = enc.encode_frame(*frames[k])
                ref = [p.cpu().numpy() for p in enc._ref]
                last_idr = enc.last_idr
                enc.close()
            elif si == 0:
                ref = None
        return self._gather_aus(aus_by_frame, spans, n)

    def _gather_aus(self, aus_by_frame, spans, n):
        # one length vector and one 4 KiB-bucketed payload per span (not
        # per frame): each broadcast is a barrier across the processes
        out = [None] * n
        for si, (a, b) in enumerate(spans):
            owner = si % self.nproc
            if self.pid == owner:
                raws = [np.frombuffer(aus_by_frame[k], np.uint8)
                        for k in range(a, b)]
                lens = np.array([len(r) for r in raws], np.int32)
            else:
                raws = None
                lens = np.zeros(b - a, np.int32)
            (lens,) = _bcast_from([lens], owner)
            total = int(lens.sum())
            nbk = -(-max(total, 1) // 4096) * 4096
            buf = np.zeros((nbk,), np.uint8)
            if raws is not None:
                buf[:total] = np.concatenate(raws)
            (buf,) = _bcast_from([buf], owner)
            off = 0
            for k in range(a, b):
                ln = int(lens[k - a])
                out[k] = buf[off:off + ln].tobytes()
                off += ln
        return out

    def close(self) -> None:
        """Leave the process group (a no-op for one process)."""
        if dist.is_initialized():
            dist.destroy_process_group()
