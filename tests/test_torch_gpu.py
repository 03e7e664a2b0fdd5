"""K1 (``nextou_tpu_torch/csrc/knn_max.cu``) against its plain PyTorch
version on a CUDA card. Imports no jax, so that it runs on a machine with the
card and without jax:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Skips without a card. Also holds the seeded inputs that
``tests/test_torch_knn.py`` shares. "Tie-built" inputs have coordinates in
{0, +-1} with exactly four nonzeros per row: normalized, every entry is
+-0.5 and every distance an exact multiple of 1/2, in bf16 and f32 alike, so
the many equal distances are exactly equal whatever order a sum runs in.
"""

import numpy as np
import pytest
import torch

from nextou_tpu_torch.kernels import knn as port_knn
from nextou_tpu_torch.kernels.knn import (
    knn_max_neighbors,
    knn_max_neighbors_reference,
)


def _random(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tie_built(shape, seed):
    rng = np.random.default_rng(seed)
    *lead, c = shape
    out = np.zeros((int(np.prod(lead)), c), np.float32)
    for row in out:
        pos = rng.choice(c, 4, replace=False)
        row[pos] = rng.choice([-1.0, 1.0], 4)
    return out.reshape(shape)


def make_case(kind, self_graph, bias, n, m, c, seed, b=2):
    make = _random if kind == "random" else _tie_built
    x = make((b, n, c), seed)
    y = None if self_graph else make((b, m, c), seed + 1)
    rel = None
    if bias:
        cols = n if self_graph else m
        # multiples of 1/8: exact in f32, so tie-built distances stay tied
        rel = np.random.default_rng(seed + 2).integers(-4, 5, (n, cols)) / 8.0
        rel = rel.astype(np.float32)
    return x, y, rel


CASES = [
    # (self_graph, bias, n, m, c, k): unaligned N, self and cross, bias or not
    (True, False, 37, 37, 8, 5),
    (True, True, 40, 40, 12, 7),
    (False, False, 45, 16, 8, 4),
    (False, True, 70, 150, 12, 9),
]


# --- K1 on the card -------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain_on_gpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("K1 is CUDA code: needs a CUDA card")
    # the plain version's f32 product is full f32 (allow_tf32 defaults to False)
    dev = torch.device("cuda")
    for kind in ("random", "tie_built"):
        for self_graph, bias, n, m, c, k in CASES + [(False, True, 300, 1344, 264, 28)]:
            x, y, rel = make_case(kind, self_graph, bias, n, m, c, seed=n + c)
            args = [
                None if a is None else torch.from_numpy(a).to(dev)
                for a in (x, y, rel)
            ]
            xt = args[0].to(dtype)
            yt = None if args[1] is None else args[1].to(dtype)
            before = port_knn.knn_max_cuda.launches
            got = knn_max_neighbors(xt, k, yt, args[2])
            torch.cuda.synchronize()
            assert port_knn.knn_max_cuda.launches == before + 1
            want = knn_max_neighbors_reference(xt, k, yt, args[2]).to(dtype)
            assert got.dtype == dtype and got.shape == want.shape
            if kind == "tie_built":  # exact arithmetic: identical selections
                torch.testing.assert_close(got, want, rtol=0, atol=0)
            else:
                rows_off = (got != want).any(-1).float().mean().item()
                assert rows_off <= 1e-3, (kind, n, m, c, k, rows_off)
    with pytest.raises(NotImplementedError):
        knn_max_neighbors(xt, 33, yt, args[2])
