"""Data parallel over processes: one rank per process, counterpart of
``nextou_tpu/parallel/distributed.py``.

The reference's only parallelism is DDP over NCCL with batch-Dice
all-reduced. The JAX package shards the batch over a mesh, where the sharded
``jit`` computes the loss over the *global* batch and XLA inserts every
reduction. Here each rank holds one share of the global batch, and every
reduction that the one-process step makes over the batch is made over the
ranks by hand: the BatchNorm statistics (``nn/layers.py::batch_norm``), the
loss terms (``losses/``), the gradients (``train/train_step.py``) and the
pseudo-Dice statistics (``train/trainer.py``). The step is then the
one-process step at the global batch.

Launch with torch's own launcher; its environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) is
the contract::

    python -m torch.distributed.run --nproc_per_node N -m nextou_tpu_torch.run_training ...

The backend follows from the devices: NCCL where every local rank has a
card of its own, gloo on the CPU or where ranks share a card. Only
``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo does these on
CUDA tensors too. :func:`all_reduce` counts its calls in ``trace.py``'s
counter ``all_reduce.calls``; without a process group of more than one rank
no collective is called.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from nextou_tpu_torch.trace import count


def launched() -> bool:
    """True when a launcher started this process as one rank of several
    (``torch.distributed.run`` sets ``RANK`` and ``WORLD_SIZE``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_lead() -> bool:
    """Rank 0, or no process group: the process that logs and writes files."""
    return rank() == 0


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device of ``device``'s type: ``cuda:(LOCAL_RANK %
    device_count)`` for a launched rank on the card, else ``device``."""
    device = torch.device(device)
    if device.type != "cuda" or not launched():
        return device
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_distributed(device: str | torch.device = "cuda",
                           init_method: str = "env://") -> torch.device:
    """Join the process group that the launcher's environment describes, on
    ``device``'s type, and return this rank's device (:func:`rank_device`).
    Idempotent: with a group already initialized only the device is
    returned.

    On the card each rank sets its own card current before anything is
    built on it, and the backend is NCCL when every local rank has a card of
    its own (``LOCAL_WORLD_SIZE <= device_count``), gloo when ranks share
    one; on the CPU it is gloo. ``init_method`` is where the ranks meet:
    ``env://`` (``MASTER_ADDR:MASTER_PORT``, the launcher's) or a
    ``file://`` path.
    """
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    name = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if local_world <= torch.cuda.device_count():
            name = "nccl"
    dist.init_process_group(name, init_method=init_method, rank=int(os.environ["RANK"]),
                            world_size=world)
    return dev


def local_share(global_batch: int) -> int:
    """This rank's share of the global batch (its loaders produce this
    many). The global batch must divide evenly over the ranks: uneven shares
    would make the ranks' statistics weigh their samples unevenly."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    count("all_reduce.calls")
    dist.all_reduce(t)
    return t



class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the ranks. Backward: the sum over the ranks of
    the cotangents, since every rank's loss reads the sum.

    Every rank's loss is then the global loss L, and a rank's gradient is
    ``world_size`` times its share of dL: the train step's average over the
    ranks gives dL itself."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``t`` over the ranks (a new tensor)."""
    return _AllReduceSum.apply(t)


def mean_over_ranks(values: torch.Tensor, mask: torch.Tensor | None = None,
                    min_count: float = 1.0) -> torch.Tensor:
    """``sum(values * mask) / max(sum(mask), min_count)``, the plain mean
    without a mask, over every rank's values: a loss term's mean over the
    global batch. ``mask`` broadcasts against ``values`` and is counted over
    its own shape. At one rank it is the local expression, bit for bit."""
    if world_size() == 1:
        if mask is None:
            return values.mean()
        return (values * mask).sum() / mask.sum().clamp(min=min_count)
    if mask is None:
        total, count = sum_over_ranks(values.sum(), values.numel())
    else:
        total, count = sum_over_ranks((values * mask).sum(), mask.sum())
    return total / count.clamp(min=min_count)


def sum_over_ranks(*values) -> list[torch.Tensor]:
    """Each of ``values`` (tensors, or numbers such as a count) summed over
    the ranks in one differentiable all-reduce, in the first tensor's dtype
    and device."""
    ref = next(v for v in values if isinstance(v, torch.Tensor))
    parts = [torch.as_tensor(v, dtype=ref.dtype, device=ref.device) for v in values]
    flat = all_reduce_sum(torch.cat([p.reshape(-1) for p in parts]))
    return [f.reshape(p.shape) for f, p in zip(flat.split([p.numel() for p in parts]), parts)]


# gradients are averaged in flat buckets of about this many bytes
BUCKET_BYTES = 32 << 20


def average_gradients(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over the ranks of each gradient, by flat all-reduces of up to
    :data:`BUCKET_BYTES` each, in order. Every rank gets the same bits."""
    n = world_size()
    out: list[torch.Tensor] = []
    bucket: list[torch.Tensor] = []

    def flush():
        flat = all_reduce(torch.cat([g.reshape(-1) for g in bucket])).div_(n)
        out.extend(f.view_as(g) for f, g in zip(flat.split([g.numel() for g in bucket]), bucket))
        bucket.clear()

    size = 0
    for g in grads:
        if bucket and (size + g.numel() * g.element_size() > BUCKET_BYTES
                       or g.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    if bucket:
        flush()
    return out
