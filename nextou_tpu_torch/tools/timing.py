"""What the measurement tools share: the card's name line and kernel timing
by CUDA events."""

from __future__ import annotations

import subprocess
import sys

import torch


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def require_card(tool: str) -> bool:
    """False, with a line on stderr, where no CUDA card is visible: the
    tools measure the card and do not carry on without one."""
    if torch.cuda.is_available():
        return True
    print(f"{tool}: no CUDA card visible", file=sys.stderr)
    return False


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the current device, by CUDA events
    around ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
