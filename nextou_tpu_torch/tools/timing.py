"""What the measurement tools share: the card's name line and kernel timing
by CUDA events."""

from __future__ import annotations

import statistics
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


def cuda_ms(fn, iters: int = 5, warmup: int = 2, min_ms: float = 0.0) -> float:
    """Milliseconds per call of ``fn`` on the current device, by CUDA events
    around ``iters`` calls after ``warmup`` calls. With ``min_ms``, rounds of
    ``iters`` calls follow one another until they have taken ``min_ms`` in
    all, and the median round counts: a call of a few tenths of a
    millisecond then is not one host hiccup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    rounds, total = [], 0.0
    while not rounds or total < min_ms:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end) / iters)
        total += rounds[-1] * iters
    return statistics.median(rounds)


def queued_cuda_ms(fn, iters: int = 20, warmup: int = 2, tries: int = 6) -> float | None:
    """Device milliseconds per call of ``fn``: ``iters`` calls queued behind a
    spin kernel (``torch.cuda._sleep``), so that the host's per-call work
    overlaps the device's and CUDA events around the calls time the device
    alone. Valid where the spin outlasts the queueing (the start event not yet
    reached once the last call is queued); the spin doubles until it does.
    None where it never does (a call that waits for the device)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 10_000_000
    for _ in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        cycles *= 2
    return None
