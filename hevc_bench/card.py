"""The card a run used: `nvidia-smi`'s name and power limit (a frozen copy
of chip_smoke.py's `smi` and `card_line`), and the device block of the
result line."""

from __future__ import annotations

import subprocess


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    """'<name>, <power limit>' of the first card, or why it is unknown."""
    try:
        return smi("name,power.limit")
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def device_block(chips: int, memory_peak_bytes: int, trace=None) -> dict:
    import torch
    out = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
               count=chips, memory_peak_bytes=int(memory_peak_bytes))
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["slice_s"]
    return out
