"""Prefetching patch loader.

Counterpart of ``nextou_tpu/data/loader.py``. Host-side sampling and
augmentation run in background threads, producing channels-last batches
that the train step moves to the card: the stand-in for nnU-Net's
batchgenerators multi-process augmentation workers. With
``device_augment=True`` the threads only sample and draw each sample's
augmentation plan (``data/device_augment.py``); the train step applies the
plans on the card. Threads (not
processes), because the heavy lifting is NumPy, SciPy and the native
resampler, which release the GIL, and the card's work overlaps the host's
anyway. Each thread draws from its own ``numpy`` generator (seed + 1000 x
its index) into its own queue, and batches are served from the threads in
turn: the batch sequence is a function of the seed and the thread count,
whatever the scheduling.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from nextou_tpu_torch.data.augment import AugmentConfig, augment_batch, cascade_onehot_noise
from nextou_tpu_torch.data.device_augment import draw_augment_plan
from nextou_tpu_torch.data.sampler import PatchSampler
from nextou_tpu_torch.trace import span


class PatchDataLoader:
    """Iterator of {'data': (B, *sp, C) f32, 'seg': (B, *sp) i32} batches.

    For a cascade stage pass ``onehot_labels`` (the foreground label values):
    the previous stage's seg patch, augmented with the sample, is one-hot
    encoded over those labels, perturbed by :func:`cascade_onehot_noise`
    with ``cascade_noise`` (training), and appended to the data channels
    (nnU-Net's MoveSegAsOneHotToData). The noise draws from the thread's
    generator after the sample's augmentation, one sample after the other,
    as ``nextou_tpu/data/loader.py`` draws it.

    With ``device_augment`` (and an ``augment`` config) the batches are
    {'data': (B, C, *sp) f32, 'seg': (B, *sp) int16, 'plans': one
    :class:`~nextou_tpu_torch.data.device_augment.AugmentPlan` per sample}:
    the sampled patches as they are, channels first (CPU tensors, in
    page-locked memory where a CUDA card is visible), and the same draws from
    the same generator as the host path's, so that
    ``device_augment_batch`` gives the host path's batch. A cascade
    dataset is refused in this mode (its one-hot noise stays on the host)."""

    def __init__(
        self,
        sampler: PatchSampler,
        augment: AugmentConfig | None = None,
        seed: int = 0,
        num_threads: int = 2,
        prefetch: int = 4,
        onehot_labels: tuple[int, ...] | None = None,
        cascade_noise: bool = False,
        device_augment: bool = False,
    ):
        if device_augment and augment is None:
            raise ValueError("device_augment needs an augment config")
        self.sampler = sampler
        self.augment = augment
        self.device_augment = device_augment
        self.onehot_labels = tuple(onehot_labels) if onehot_labels else None
        self.cascade_noise = cascade_noise
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self._rngs = [
            np.random.default_rng(seed + 1000 * i) for i in range(self.num_threads)
        ]
        # one queue per thread, served in turn
        self._qs = [queue.Queue(maxsize=max(1, prefetch // self.num_threads))
                    for _ in range(self.num_threads)]
        self._turn = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._errors: list[BaseException] = []

    def _produce(self, tid: int):
        try:
            self._produce_loop(tid)
        except BaseException as e:  # noqa: BLE001 — surfaced by __next__
            self._errors.append(e)

    def _produce_loop(self, tid: int):
        rng = self._rngs[tid]
        while not self._stop.is_set():
            # each thread draws from its own generator, so sampling takes no
            # lock (the sampler's case cache has its own insert lock)
            data, seg, prev = self.sampler.sample_batch(rng=rng)
            if self.device_augment:
                self._put(tid, self._plan_batch(data, seg, prev, rng))
            else:
                self._put(tid, self._host_batch(data, seg, prev, rng))

    def _plan_batch(self, data, seg, prev, rng) -> dict:
        if prev is not None:
            raise ValueError("a cascade dataset keeps host augmentation (device_augment=False)")
        plans = [draw_augment_plan(self.augment, d.shape, rng) for d in data]
        data, seg = torch.from_numpy(data), torch.from_numpy(seg)
        if torch.cuda.is_available():
            # page-locked, so that the train step's upload of the raw patches
            # is an asynchronous copy instead of a synchronous staged one
            data, seg = data.pin_memory(), seg.pin_memory()
        return {"data": data, "seg": seg, "plans": plans}

    def _host_batch(self, data, seg, prev, rng) -> dict:
        if self.augment is not None:
            data, seg, prev = augment_batch(data, seg, self.augment, rng, prev)
        if prev is not None:
            if self.onehot_labels is None:
                raise ValueError("a cascade dataset (seg_prev present) needs onehot_labels "
                                 "on the PatchDataLoader")
            hot = np.stack([prev == label for label in self.onehot_labels],
                           axis=1).astype(np.float32)  # (B, F, *sp)
            if self.cascade_noise:
                for b in range(hot.shape[0]):
                    hot[b] = cascade_onehot_noise(hot[b], rng)
            data = np.concatenate([data, hot], axis=1)
        return {
            # (B, C, *sp) -> channels-last
            "data": np.ascontiguousarray(np.moveaxis(data, 1, -1)),
            "seg": seg.astype(np.int32),
        }

    def _put(self, tid: int, batch: dict):
        while not self._stop.is_set():
            try:
                self._qs[tid].put(batch, timeout=0.25)
                return
            except queue.Full:
                continue

    def start(self):
        if self._threads:
            return self
        for i in range(self.num_threads):
            t = threading.Thread(target=self._produce, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []

    def __iter__(self):
        self.start()
        return self

    def __next__(self):
        # the consumer's wait is the span loader.next while tracing is on
        with span("loader.next"):
            return self._next()

    def _next(self):
        # a producer that died (a corrupt case, a missing prev-stage file) must
        # surface its exception promptly — checked BEFORE serving the next
        # batch, and polled with a timeout instead of blocking forever on the
        # dead thread's empty queue.
        while True:
            if self._errors:
                self._stop.set()
                raise RuntimeError(
                    "PatchDataLoader producer thread failed"
                ) from self._errors[0]
            try:
                batch = self._qs[self._turn].get(timeout=1.0)
                self._turn = (self._turn + 1) % self.num_threads
                return batch
            except queue.Empty:
                if self._threads and not any(
                    t.is_alive() for t in self._threads
                ):
                    raise RuntimeError(
                        "all PatchDataLoader producer threads exited"
                    )

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
