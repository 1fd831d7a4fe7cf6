"""DataModule: phase datasets, prefetching loaders, fixed-capacity batching
(counterpart of ``nerf_downstream_tpu/data/data_module.py``, the port's own
copy: the same seed gives the same batch order and subsampling draws).
Shard-partitioned batches (``shards > 1``) wait for the multi-GPU trainer
(ROADMAP.md Queue 1 item 4) and raise.

Differences by design:
- workers prefetch ``__getitem__``, ``train_num_workers`` of them:
  threads (``worker_mode = "thread"``; numpy releases the GIL in the hot
  ops) or a fork-based process pool (``"process"``, the reference's
  DataLoader workers; threads where fork is unavailable). With more than
  one, batch ``i`` of an epoch draws its host transforms and subsampling
  from its own generator, seeded from (the epoch's worker seed, ``i``),
  so what a batch holds depends neither on which worker loads it nor on
  the worker kind; with one, the draws come from the module streams in
  order, as the reference's. Process workers return numpy batches and
  never touch the card (the parent may have initialised CUDA before it
  forks); the caller moves batches to the device.
- per-host sharding replaces DistributedSampler: each process takes
  ``files[process_index::process_count]``.
- batches are padded to a static capacity; oversized batches are randomly
  subsampled per sample to fit (the reference instead truncates the batch in
  pt_limited_collate_fn_factory, transforms.py:722-760).
"""

from __future__ import annotations

import logging
import queue
from typing import Iterator, Optional

import numpy as np

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data import transforms
from nerf_downstream_tpu_torch.data.datasets import get_dataset
from nerf_downstream_tpu_torch.data.utils import (
    COLLATE_FNS,
    collate_mink,
    next_bucket,
)


# the prune batches' per-batch generators are seeded from (seed,
# PRUNE_STREAM, i): apart from the val batches' (seed, i)
PRUNE_STREAM = 1


def _subsample_to_fit(samples: list[dict], capacity: int, rng) -> list[dict]:
    total = sum(len(s["coordinates"]) for s in samples)
    if total <= capacity:
        return samples
    keep_frac = capacity / total * 0.999
    out = []
    for s in samples:
        n = len(s["coordinates"])
        k = max(1, int(n * keep_frac))
        idx = rng.choice(n, k, replace=False)
        t = dict(s)
        t["coordinates"] = s["coordinates"][idx]
        t["features"] = s["features"][idx]
        lab = np.asarray(s["labels"]).reshape(-1)
        if len(lab) == n:
            t["labels"] = lab[idx]
        if "dists" in s:
            t["dists"] = np.asarray(s["dists"]).reshape(n, -1)[idx]
        if "xyzs" in s and len(s["xyzs"]) == n:
            t["xyzs"] = s["xyzs"][idx]
        out.append(t)
    return out


_PROC_FN = None


def _proc_init(fn):
    """Fork-pool initializer: install the batch loader (each batch seeds
    its own generator, so the workers need no streams of their own)."""
    global _PROC_FN
    _PROC_FN = fn


def _proc_call(arg):
    return _PROC_FN(arg)


class _Prefetcher:
    """Background workers mapping dataset[i] ahead of consumption, in
    order: ``mode="thread"`` a thread pool, ``"process"`` a fork-based
    process pool (threads where fork is unavailable). With more than one
    worker each batch draws from its own generator
    (``DataModule._seeded``)."""

    def __init__(self, fn, indices, num_workers: int, depth: int = 4,
                 mode: str = "thread"):
        if mode not in ("thread", "process"):
            raise ValueError(f"unknown worker_mode {mode!r}")
        self.fn = fn
        self.indices = list(indices)
        self.num_workers = max(1, num_workers)
        self.depth = depth
        self.mode = mode

    def __iter__(self):
        if self.num_workers <= 1:
            for i in self.indices:
                yield self.fn(i)
            return
        if self.mode == "process":
            import multiprocessing as mp

            try:
                ctx = mp.get_context("fork")
            except ValueError:
                logging.warning(
                    "fork unavailable; process workers fall back to threads")
            else:
                with ctx.Pool(self.num_workers, initializer=_proc_init,
                              initargs=(self.fn,)) as pool:
                    yield from pool.imap(_proc_call, self.indices)
                return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = queue.Queue()
            it = iter(self.indices)
            for _ in range(self.num_workers * self.depth):
                try:
                    pending.put(pool.submit(self.fn, next(it)))
                except StopIteration:
                    break
            while not pending.empty():
                fut = pending.get()
                try:
                    pending.put(pool.submit(self.fn, next(it)))
                except StopIteration:
                    pass
                yield fut.result()


@cfg.configurable
class DataModule:
    def __init__(
        self,
        batch_size: int = 8,
        val_batch_size: int = 2,
        train_num_workers: int = 4,
        val_num_workers: int = 2,
        collate_func_name: str = "collate_mink",
        train_phase: str = "train",
        val_phase: str = "val",
        test_phase: str = "test",
        capacity: Optional[int] = None,
        val_capacity: Optional[int] = None,
        ignore_label: int = -100,
        min_capacity: int = 1024,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        dataset_cls=None,
        shards: int = 1,
        worker_mode: str = "thread",
    ):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        self.worker_mode = worker_mode
        self.batch_size = batch_size
        self.val_batch_size = val_batch_size
        self.train_num_workers = train_num_workers
        self.val_num_workers = val_num_workers
        self.collate_name = collate_func_name
        self.collate = COLLATE_FNS[collate_func_name]
        self.phases = {
            "train": train_phase, "val": val_phase, "test": test_phase,
        }
        self.capacity = capacity
        self.val_capacity = val_capacity or capacity
        self.ignore_label = ignore_label
        self.min_capacity = min_capacity
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # per phase: whether each batch draws from its own generator (more
        # than one loader thread); fixed here, so that a copy with one
        # thread (the calibration's) draws as the run does
        self._seeded = {"train": train_num_workers > 1,
                        "val": val_num_workers > 1,
                        "prune": val_num_workers > 1}
        self.process_index = process_index
        self.process_count = process_count
        self._dataset_cls = dataset_cls
        # shards > 1: emit shard-partitioned batches for the data-parallel
        # Trainer (whole samples per shard, identical per-shard capacity)
        self.shards = shards
        if shards > 1:
            raise NotImplementedError(
                "shard-partitioned batches wait for the multi-GPU trainer "
                "(ROADMAP.md Queue 1 item 4)")
        self._datasets: dict = {}

    def dataset(self, split: str):
        if split not in self._datasets:
            cls = self._dataset_cls or get_dataset()
            self._datasets[split] = cls(phase=self.phases.get(split, split))
        return self._datasets[split]

    def _loaded(self, ds, idx_group, capacity, rng=None, pad_to_batch=None):
        """The collated batch of ``ds[idx_group]``; its host transforms and
        subsampling draw from ``rng`` when given, else from the module
        streams."""
        if rng is None:
            return self._collate([ds[int(i)] for i in idx_group], capacity,
                                 self.rng, pad_to_batch)
        with transforms.drawing_from(rng):
            return self._collate([ds[int(i)] for i in idx_group], capacity,
                                 rng, pad_to_batch)

    def _collate(self, samples, capacity, rng, pad_to_batch=None):
        if self.collate_name == "collate_mink":
            if capacity is not None:
                samples = _subsample_to_fit(samples, capacity, rng)
            return collate_mink(
                samples,
                capacity=capacity,
                ignore_label=self.ignore_label,
                min_capacity=self.min_capacity,
                pad_to_batch=pad_to_batch,
            )
        return self.collate(samples)

    def _auto_capacity(self, ds, batch_size: int) -> int:
        """Probe a few samples to pick a stable power-of-two capacity."""
        probe = min(4, len(ds))
        sizes = [len(ds[i]["coordinates"]) for i in range(probe)]
        est = int(np.mean(sizes) * batch_size * 1.6)
        return next_bucket(max(est, self.min_capacity), self.min_capacity)

    def train_batches(self) -> Iterator[dict]:
        ds = self.dataset("train")
        cap = self.capacity
        if cap is None and self.collate_name == "collate_mink":
            cap = self._auto_capacity(ds, self.batch_size)
            logging.info(f"train capacity bucket: {cap}")
        shard = list(range(self.process_index, len(ds), self.process_count))
        while True:
            order = self.rng.permutation(shard)
            batches = [
                order[i : i + self.batch_size]
                for i in range(0, len(order) - self.batch_size + 1, self.batch_size)
            ]

            # the reference draws a worker seed here; the draw keeps the
            # module's stream (and so its batch order) the reference's
            worker_seed = int(self.rng.integers(2**31))
            seeded = self._seeded["train"]

            def load(job):
                i, idx_group = job
                rng = (np.random.default_rng([worker_seed, i]) if seeded
                       else None)
                return self._loaded(ds, idx_group, cap, rng)

            yield from _Prefetcher(load, enumerate(batches),
                                   self.train_num_workers,
                                   mode=self.worker_mode)

    def prune_batches(self, num_batches: int = 8,
                      batch_size: Optional[int] = None) -> Iterator[dict]:
        """Calibration batches for pruning (the reference's
        ``prune_batches``): ``num_batches`` groups of ``batch_size``
        (default the train batch size) sequential train samples, the train
        collate and capacity (automatic when none is set), on
        ``val_num_workers`` workers."""
        ds = self.dataset("train")
        bs = batch_size or self.batch_size
        cap = self.capacity
        if cap is None and self.collate_name == "collate_mink":
            cap = self._auto_capacity(ds, bs)
        groups = [list(range(i * bs, min((i + 1) * bs, len(ds))))
                  for i in range(num_batches) if i * bs < len(ds)]
        seeded = self._seeded["prune"]

        def load(job):
            i, idx_group = job
            rng = (np.random.default_rng([self.seed, PRUNE_STREAM, i])
                   if seeded else None)
            return self._loaded(ds, idx_group, cap, rng)

        return iter(_Prefetcher(load, enumerate(groups),
                                self.val_num_workers, mode=self.worker_mode))

    def val_batches(self, phase: str = "val") -> Iterator[dict]:
        ds = self.dataset(phase)
        cap = self.val_capacity
        if cap is None and self.collate_name == "collate_mink":
            cap = self._auto_capacity(ds, self.val_batch_size)
        shard = list(range(self.process_index, len(ds), self.process_count))
        batches = [
            shard[i : i + self.val_batch_size]
            for i in range(0, len(shard), self.val_batch_size)
        ]

        seeded = self._seeded["val"]

        def load(job):
            i, idx_group = job
            rng = np.random.default_rng([self.seed, i]) if seeded else None
            return self._loaded(ds, idx_group, cap, rng,
                                pad_to_batch=self.val_batch_size)

        return iter(_Prefetcher(load, enumerate(batches),
                                self.val_num_workers, mode=self.worker_mode))
