"""Batch loader: epoch-seeded enlarged-permutation sampling + multiprocess prefetch.

The counterpart of the JAX package's ``hcflow_tpu/data/loader.py`` (numpy only), with
the same batch streams, after the reference's data/data_sampler.py (DistIterSampler
with the dataset enlarged xratio so epoch restarts are rare, deterministic per-epoch
permutation) and data/__init__.py (dataloader construction, ``n_workers``): a
host-side numpy permutation over an enlarged index space, sliced per process, with a
worker pool decoding ahead of the device (PNG decode is GIL-bound, so honoring
``n_workers`` needs real processes, not threads).  Batches are assigned round-robin
and re-ordered on receipt, so the worker count never changes the batch stream;
per-item RNG is (seed, epoch, index)-derived, so placement doesn't either.

The workers are started with ``spawn``, not ``fork`` as the JAX package's are: the
parent may hold a CUDA context (and its threads), which a forked child must not
inherit.  They receive the dataset pickled and touch only numpy.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import traceback
from typing import Iterator, Optional

import numpy as np


class EnlargedSampler:
    """Deterministic epoch-seeded permutation of ratio * len(dataset) indices."""

    def __init__(
        self,
        num_samples: int,
        ratio: int = 1,
        num_replicas: int = 1,
        rank: int = 0,
        seed: int = 0,
    ):
        self.num_samples = num_samples
        self.ratio = ratio
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        total = int(np.ceil(num_samples * ratio / num_replicas)) * num_replicas
        self.total_size = total
        self.per_replica = total // num_replicas

    def indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, epoch])
        idx = rng.permutation(self.total_size) % self.num_samples
        return idx[self.rank : self.total_size : self.num_replicas]


def _collate(items):
    batch = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            batch[k] = np.stack(vals).astype(np.float32)
        else:
            batch[k] = vals
    return batch


class DataLoader:
    """Minimal dataset -> batched-numpy iterator with optional thread prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 0,
        sampler: Optional[EnlargedSampler] = None,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.sampler = sampler
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = self.sampler.per_replica if self.sampler else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def _index_order(self) -> np.ndarray:
        if self.sampler is not None:
            return self.sampler.indices(self.epoch)
        if self.shuffle:
            rng = np.random.default_rng([self.seed, self.epoch])
            return rng.permutation(len(self.dataset))
        return np.arange(len(self.dataset))

    def __iter__(self) -> Iterator[dict]:
        order = self._index_order()
        n_batches = len(self)
        batches = [
            order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(n_batches)
        ]
        if self.num_workers <= 0 or n_batches == 0:
            for b in batches:
                yield _collate([self.dataset[int(i)] for i in b])
            return
        if self.num_workers == 1:
            yield from self._iter_threaded(batches)
            return
        yield from self._iter_pool(batches)

    def _iter_threaded(self, batches) -> Iterator[dict]:
        """Single prefetch thread — enough when decode is cheap (pkl/npy in RAM)."""
        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def worker():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(_collate([self.dataset[int(i)] for i in b]))
            except Exception as e:  # raised by the consumer below
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def _iter_pool(self, batches) -> Iterator[dict]:
        """num_workers decode processes; round-robin batch assignment with in-order
        reassembly (worker count never changes the batch stream).  A worker's
        exception is raised here with its traceback."""
        ctx = mp.get_context("spawn")
        n_workers = min(self.num_workers, len(batches))
        result_q = ctx.Queue(maxsize=2 * n_workers)
        procs = [ctx.Process(target=_pool_worker,
                             args=(self.dataset, batches, w, n_workers, result_q), daemon=True)
                 for w in range(n_workers)]
        try:
            for p in procs:
                p.start()
        except OSError:  # no worker processes can start here: decode in one thread
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            yield from self._iter_threaded(batches)
            return
        pending: dict = {}
        next_j, done = 0, 0
        try:
            while next_j < len(batches):
                while next_j not in pending:
                    j, payload = result_q.get()
                    if j == _FAILED:
                        raise RuntimeError(f"a decode worker failed:\n{payload}")
                    if j < 0:
                        done += 1
                        if done == n_workers and next_j not in pending and len(pending) == 0:
                            raise RuntimeError("decode workers exited before finishing")
                        continue
                    pending[j] = payload
                yield pending.pop(next_j)
                next_j += 1
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)
            for p in procs:  # decode workers never hold device state: safe to kill
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)


_DONE, _FAILED = -1, -2


def _pool_worker(dataset, batches, wid: int, n_workers: int, result_q) -> None:
    """Decode the batches wid, wid + n_workers, ... into result_q as (index, batch),
    then (_DONE, wid); on an exception (_FAILED, its traceback)."""
    try:
        for j in range(wid, len(batches), n_workers):
            result_q.put((j, _collate([dataset[int(i)] for i in batches[j]])))
        result_q.put((_DONE, wid))
    except KeyboardInterrupt:
        pass
    except Exception:  # the parent raises it: a worker that just died would hang it
        result_q.put((_FAILED, traceback.format_exc()))


def create_dataloader(dataset, dataset_opt: dict, sampler=None, num_replicas: int = 1):
    """Train/val dataloader construction matching the reference's data/__init__.py."""
    phase = dataset_opt.get("phase", "train")
    if phase == "train":
        batch_size = max(dataset_opt.get("batch_size", 16) // num_replicas, 1)
        return DataLoader(
            dataset,
            batch_size=batch_size,
            shuffle=sampler is None and dataset_opt.get("use_shuffle", True),
            drop_last=True,
            num_workers=dataset_opt.get("n_workers", 1),
            sampler=sampler,
            seed=dataset_opt.get("seed", 0),
        )
    return DataLoader(dataset, batch_size=1, shuffle=False, num_workers=0)
