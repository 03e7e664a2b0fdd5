"""Host-side bicubic resize (NumPy), carried over from ``nextou_tpu/core/resize.py``.

Used once at model-construction time to resample the relative-position Gram
matrices to the target node counts, mirroring upstream NexToU's
``F.interpolate(mode='bicubic', align_corners=False)`` calls
(``NexToU_Encoder_Decoder.py:733-739``).

Keys cubic-convolution kernel with A=-0.75 and half-pixel coordinate mapping
with border clamping, the same convention as PyTorch. The arithmetic is the
JAX package's, step for step, so both packages build bit-identical tables.
"""

from __future__ import annotations

import numpy as np

_A = -0.75  # cubic convolution coefficient (PyTorch convention)


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """Weights of the 4 taps for fractional offsets ``t`` in [0, 1).

    Returns array of shape ``t.shape + (4,)`` for taps at offsets
    ``[-1, 0, 1, 2]`` relative to floor(src).
    """
    t = np.asarray(t, dtype=np.float64)

    def w1(x):  # |x| <= 1
        return ((_A + 2.0) * x - (_A + 3.0)) * x * x + 1.0

    def w2(x):  # 1 < |x| < 2
        return ((_A * x - 5.0 * _A) * x + 8.0 * _A) * x - 4.0 * _A

    return np.stack([w2(t + 1.0), w1(t), w1(1.0 - t), w2(2.0 - t)], axis=-1)


def _resize_axis(
    x: np.ndarray, out_size: int, axis: int, chunk: int = 512
) -> np.ndarray:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    x = np.moveaxis(x, axis, 0)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    w = _cubic_weights(t).astype(x.dtype)  # (out, 4)
    taps = np.clip(i0[:, None] + np.array([-1, 0, 1, 2]), 0, in_size - 1)
    # chunk the output rows: x[taps] materializes (chunk, 4, *rest) only
    out = np.empty((out_size,) + x.shape[1:], dtype=x.dtype)
    for s in range(0, out_size, chunk):
        e = min(s + chunk, out_size)
        out[s:e] = np.einsum("ot,ot...->o...", w[s:e], x[taps[s:e]])
    return np.moveaxis(out, 0, axis)


def bicubic_resize_2d(
    x: np.ndarray, out_shape: tuple[int, int], dtype=np.float64
) -> np.ndarray:
    """Separable bicubic resize of the last two axes of ``x``.

    ``dtype`` sets the compute precision: fp32 matches torch's fp32
    interpolate (what upstream runs); fp64 for oracle comparisons.
    """
    x = np.asarray(x, dtype=dtype)
    x = _resize_axis(x, out_shape[0], x.ndim - 2)
    x = _resize_axis(x, out_shape[1], x.ndim - 1)
    return x
