"""Batched data loading with per-epoch shuffling, per-process sharding and
background prefetch.

The port's own copy of ucd_tpu/data/loader.py: each process reads its
contiguous shard of the epoch permutation and gets NHWC numpy batches
(uint8 images, uint8 labels on the default pipeline), which the steps upload
to the device. Drop-last semantics for training. `prefetch > 0` overlaps the
host's decode/augment with device work in a daemon thread; `workers > 1`
loads the items of a batch in a thread pool (PIL releases the GIL). Each
item draws from its own generator seeded by (seed, epoch, index), so the
batches do not depend on the worker count. In a multi-process run
(ucd_torch/parallel) the Experiment passes the process's rank and the
group's size as `process_index` and `process_count`: every process draws
the same permutation and takes its own `len // process_count` items."""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # intra-batch item parallelism: PIL's resampling releases the
        # GIL, so threads scale with the host's cores
        # (torch DataLoader num_workers equivalent, process-free)
        self.workers = workers
        # one pool for the loader's lifetime: a per-epoch pool released with
        # shutdown(wait=False) leaks worker threads when a consumer abandons
        # the prefetch generator mid-epoch
        self._pool = None

    def _get_pool(self):
        if self.workers > 1 and self._pool is None:
            import weakref
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(self.workers)
            # nothing in a long multi-step run is guaranteed to call
            # close(); tie the pool's lifetime to the loader's so dropped
            # loaders (e.g. one Experiment per incremental step) don't
            # accumulate idle worker threads. The finalizer captures the
            # pool, not self, so it cannot keep the loader alive.
            weakref.finalize(self, self._pool.shutdown, wait=False,
                             cancel_futures=True)
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Epoch iterator, prefetched in a background thread when
        `prefetch > 0`."""
        if self.prefetch <= 0:
            yield from self._epoch_sync(epoch)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _END = object()

        def worker():
            try:
                for b in self._epoch_sync(epoch):
                    q.put(b)
            finally:
                q.put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is _END:
                break
            yield b

    def _epoch_sync(self, epoch: int) -> Iterator[dict]:
        """DistributedSampler.set_epoch equivalent (reference train.py:92):
        epoch-seeded permutation, per-host contiguous shard."""
        rng = np.random.default_rng(self.seed + epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        per_host = len(order) // self.process_count
        order = order[self.process_index * per_host:
                      (self.process_index + 1) * per_host]

        def load_item(i):
            # per-item seeded rng: identical stream regardless of worker
            # count or scheduling (SURVEY §5.2 determinism)
            item_rng = np.random.default_rng((self.seed, epoch, int(i)))
            if hasattr(self.dataset, "get"):
                return self.dataset.get(int(i), item_rng)
            return self.dataset[int(i)]

        pool = self._get_pool()
        n_batches = len(self)
        for b in range(n_batches):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idxs) == 0:
                break
            if pool is not None:
                pairs = list(pool.map(load_item, [int(i) for i in idxs]))
            else:
                pairs = [load_item(int(i)) for i in idxs]
            # uint8 images pass through untouched (the device-normalize
            # pipeline: the model applies the ImageNet affine on device);
            # anything else is already host-normalized float
            images = np.stack([p[0] for p in pairs])
            if images.dtype != np.uint8:
                images = images.astype(np.float32)
            labels = np.stack([p[1] for p in pairs])
            # uint8 labels ship as-is (the steps widen them on the device —
            # 4x less H2D); anything else normalizes to int32 without a
            # redundant same-dtype copy
            if labels.dtype not in (np.uint8, np.int32):
                labels = labels.astype(np.int32)
            yield {"image": images, "label": labels}


def split_train_val(dataset, val_frac: float = 0.2, seed: int = 42):
    """80/20 random split (reference run.py:98-106 random_split)."""
    n = len(dataset)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_train = int((1 - val_frac) * n)
    return _Delegate(dataset, order[:n_train]), _Delegate(dataset, order[n_train:])


class _Delegate:
    """Index-remapped view over an already-transformed dataset."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(int(i) for i in indices)

    def get(self, idx, rng=None):
        if hasattr(self.dataset, "get"):
            return self.dataset.get(self.indices[idx], rng)
        return self.dataset[self.indices[idx]]

    def __getitem__(self, idx):
        return self.get(idx)

    def __len__(self):
        return len(self.indices)
