"""Prefetching patch loader.

Counterpart of ``nextou_tpu/data/loader.py``. Host-side sampling and
augmentation run in background threads, producing channels-last batches
that the train step moves to the card: the stand-in for nnU-Net's
batchgenerators multi-process augmentation workers. Threads (not
processes), because the heavy lifting is NumPy, SciPy and the native
resampler, which release the GIL, and the card's work overlaps the host's
anyway. Each thread draws from its own ``numpy`` generator (seed + 1000 x
its index): with one thread the batch order is fully determined by the
seed; with more it depends on scheduling.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from nextou_tpu_torch.data.augment import AugmentConfig, augment_batch
from nextou_tpu_torch.data.sampler import PatchSampler


class PatchDataLoader:
    """Iterator of {'data': (B, *sp, C) f32, 'seg': (B, *sp) i32} batches.

    Cascade datasets (a previous stage's seg beside each case) are not
    ported yet (ROADMAP M6b): a producer that samples one raises."""

    def __init__(
        self,
        sampler: PatchSampler,
        augment: AugmentConfig | None = None,
        seed: int = 0,
        num_threads: int = 2,
        prefetch: int = 4,
    ):
        self.sampler = sampler
        self.augment = augment
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self._rngs = [
            np.random.default_rng(seed + 1000 * i) for i in range(self.num_threads)
        ]
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
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
            if prev is not None:
                raise NotImplementedError(
                    "cascade datasets (a previous stage's seg) are not ported yet: ROADMAP M6b")
            if self.augment is not None:
                data, seg, _ = augment_batch(data, seg, self.augment, rng)
            batch = {
                # (B, C, *sp) -> channels-last
                "data": np.ascontiguousarray(np.moveaxis(data, 1, -1)),
                "seg": seg.astype(np.int32),
            }
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.25)
                    break
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
        # a producer that died (a corrupt case, a cascade dataset) must
        # surface its exception promptly — checked BEFORE serving the next
        # batch (a surviving second thread can keep the queue non-empty
        # forever, which would bury the error), and polled with a timeout
        # instead of blocking forever on an empty queue.
        while True:
            if self._errors:
                self._stop.set()
                raise RuntimeError(
                    "PatchDataLoader producer thread failed"
                ) from self._errors[0]
            try:
                return self._q.get(timeout=1.0)
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
