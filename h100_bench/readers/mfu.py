"""The step's share of the card's bf16 peak, in percent: the benchmark's
operations per step or case (``flops.py``) times those the window completed,
over the window's seconds, over 989 TFLOP/s (``roofline.py``)."""

from h100_bench.roofline import PEAK_BF16_FLOPS


def read(run, spec):
    s = run.stats
    return 100.0 * s["flops_per_unit"] * s["units"] / s["window_s"] / PEAK_BF16_FLOPS
