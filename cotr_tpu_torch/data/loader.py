"""Prefetching batch loader with bounded in-flight work (counterpart of
cotr_tpu/data/loader.py).

Sample synthesis runs in a worker pool while the device steps; batches come
out as numpy dicts with static shapes, and the ``Trainer`` uploads them.

Memory is bounded end to end: at most ``num_workers + prefetch`` batches are
in flight in the pool (submission is lazy, not the whole epoch up front) and
at most ``prefetch`` finished batches wait in the hand-off queue, so a
stalled consumer stalls the producers.

Workers are threads by default (numpy releases the interpreter lock in its
array loops); ``executor="process"`` runs a pool of spawned processes, each
holding its own copy of the dataset, for synthesis that holds the lock.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Tuple

import numpy as np

# A process pool cannot close over the loader; the dataset is installed once
# in each worker by its initializer.
_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _stack(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _build_batch_in_worker(idx_list):
    return _stack([_WORKER_DATASET[int(i)] for i in idx_list])


class PrefetchLoader:
    """Iterate fixed-shape batches with background sample synthesis.

    Each ``iter()`` (or call) is one epoch; shuffling is deterministic in
    (seed, epoch). Batches come in submission order whatever the workers'
    timing. An exception raised while building a batch is raised to the
    consumer at that batch.

    Parameters
    ----------
    executor: "thread" (default) or "process" (the dataset must then be
        picklable).
    prefetch: most finished batches buffered ahead of the consumer.
    shard: (index, count) under data parallelism: ``batch_size`` stays the
        global batch and each batch holds only the ``index``-th of its
        ``count`` equal row blocks, the sample indices the one-process
        loader would put there (``parallel.mesh.process_shard()`` gives a
        rank's pair).
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch: int = 4, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, executor: str = "thread",
                 shard: Tuple[int, int] = (0, 1)):
        if executor not in ("thread", "process"):
            raise ValueError(f"executor must be 'thread' or 'process', got "
                             f"{executor!r}")
        index, count = shard
        if not 0 <= index < count or batch_size % count:
            raise ValueError(f"shard {shard}: needs 0 <= index < count and "
                             f"a batch ({batch_size}) of count equal blocks")
        self.shard = (index, count)
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.executor = executor
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _make_pool(self):
        if self.executor == "process":
            return ProcessPoolExecutor(
                self.num_workers, mp_context=multiprocessing.get_context(
                    "spawn"),
                initializer=_init_worker, initargs=(self.dataset,))
        return ThreadPoolExecutor(self.num_workers)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1

        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        index, count = self.shard
        if count > 1:
            if len(batches) and len(batches[-1]) % count:
                raise ValueError(f"a last batch of {len(batches[-1])} does "
                                 f"not split over {count} ranks: use "
                                 "drop_last")
            batches = [np.array_split(b, count)[index] for b in batches]

        out_q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def build(idx_list):
            return _stack([self.dataset[int(i)] for i in idx_list])

        submit_fn = (_build_batch_in_worker
                     if self.executor == "process" else build)

        def put_respecting_stop(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            max_inflight = self.num_workers + max(1, self.prefetch)
            pending: deque = deque()
            it = iter(batches)
            try:
                with self._make_pool() as pool:
                    try:
                        while not stop.is_set():
                            while len(pending) < max_inflight:
                                try:
                                    b = next(it)
                                except StopIteration:
                                    break
                                pending.append(pool.submit(submit_fn, b))
                            if not pending:
                                break
                            fut = pending.popleft()
                            try:
                                item = fut.result()
                            except Exception as e:  # raised to the consumer
                                item = e
                            if not put_respecting_stop(item):
                                break
                    finally:
                        for f in pending:
                            f.cancel()
            except Exception as e:  # the pool itself failed
                put_respecting_stop(e)
            put_respecting_stop(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    # a loader factory for the Trainer
    __call__ = __iter__
