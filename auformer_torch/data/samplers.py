"""Index samplers + loader (counterpart of auformer/data/samplers.py;
reference dataloader/utils.py:5-48 equivalents). Plain Python and numpy,
not ``torch.utils.data``: the batches are the JAX package's, item for item.

The loader is where the reference's num_workers=0, synchronous-one-ahead
Prefetcher bottleneck (SURVEY.md §3.2) is replaced: samples are fetched by a
thread pool (mmap reads + the native reader's batched JPEG decode release
the GIL) and whole batches are assembled ahead of consumption, optionally
sharded per host for multi-host data parallelism.
"""
from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np


class SubsetSequentialSampler:
    """Iterate a fixed index subset, optionally shuffled ONCE at
    construction (reference dataloader/utils.py:5-16)."""

    def __init__(self, indices: Sequence[int], shuffle: bool = False):
        self.indices = list(indices)
        if shuffle:
            random.shuffle(self.indices)

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return len(self.indices)


class SubsetRandomSampler:
    """Fresh permutation each epoch (reference dataloader/utils.py:18-30)."""

    def __init__(self, indices: Sequence[int]):
        self.indices = list(indices)

    def __iter__(self) -> Iterator[int]:
        perm = np.random.permutation(len(self.indices))
        return (self.indices[i] for i in perm)

    def __len__(self) -> int:
        return len(self.indices)


class BlockShuffleSampler:
    """Locality-aware shuffle: cut the index list into contiguous runs of
    ``run_len`` and draw a fresh permutation of the RUNS each epoch.

    Samples inside a run are consecutive labeled frames, so their dilated
    clip windows (dataset.py::_clip_keys — clip_len frames, stride
    dilation) overlap pairwise: a run of L indices references only about
    L + (clip_len-1)*dilation unique frames while issuing clip_len*L frame
    reads. Feeding runs intact turns the decoded-frame LRU (or the
    frame-dedup batch assembly) into a ~clip_len-fold JPEG-decode and H2D
    reduction — the difference between a loader that starves a train step
    and one that feeds it, on hosts with few cores.

    The trade is batch composition: a batch holds batch/run_len contiguous
    runs instead of batch independent samples (the classic shard/block
    shuffle of tf.data and WebDataset pipelines). run_len == batch_size
    maximizes reuse; run_len == 1 degenerates to SubsetRandomSampler.
    """

    def __init__(self, indices: Sequence[int], run_len: int,
                 seed: int | None = None):
        self.indices = list(indices)
        self.run_len = max(1, int(run_len))
        self.seed = seed
        self._epoch = 0

    def __iter__(self) -> Iterator[int]:
        runs = [self.indices[i:i + self.run_len]
                for i in range(0, len(self.indices), self.run_len)]
        rng = np.random.RandomState(
            None if self.seed is None else (self.seed + self._epoch))
        self._epoch += 1
        for r in rng.permutation(len(runs)):
            yield from runs[r]

    def __len__(self) -> int:
        return len(self.indices)


def shard_indices(indices: Sequence[int], host_id: int,
                  num_hosts: int) -> list[int]:
    """Per-host contiguous-stride shard for multi-host input pipelines."""
    return list(indices)[host_id::num_hosts]


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into batched numpy arrays."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if np.isscalar(vals[0]):
            out[k] = np.asarray(vals)
        else:
            out[k] = np.stack(vals)
    return out


class DataLoader:
    """Threaded map-style loader: sampler -> batches of collated numpy.

    drop_last matches the reference's training loader (train.py:190-192).
    """

    def __init__(self, dataset, batch_size: int, sampler: Iterable[int],
                 num_threads: int = 4, drop_last: bool = False,
                 prefetch_batches: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_threads = max(1, num_threads)
        self.drop_last = drop_last
        self.prefetch_batches = max(1, prefetch_batches)

    def _batches(self) -> Iterator[list[int]]:
        batch = []
        for idx in self.sampler:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self) -> int:
        n = len(self.sampler)  # type: ignore[arg-type]
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        # frame-dedup batches are assembled as a unit (a pool of unique
        # frames and a (B, T) map, dataset.assemble_batch), so a batch is
        # one pool task and the decode runs in parallel inside the native
        # batched decoder; otherwise per-sample tasks and collate
        assemble = (self.dataset.assemble_batch
                    if getattr(self.dataset, "frame_dedup", False) else None)
        # a dataset may finish a collated batch as a unit (the host
        # AutoAugment's worker pool, dataset.augment_batch)
        finish = getattr(self.dataset, "augment_batch", lambda b: b)
        with ThreadPoolExecutor(self.num_threads) as pool:
            pending: queue.Queue = queue.Queue()
            batch_iter = self._batches()

            def load_batch(idxs):
                return assemble([self.dataset[i] for i in idxs])

            def submit_next():
                try:
                    idxs = next(batch_iter)
                except StopIteration:
                    return False
                if assemble is not None:
                    pending.put([pool.submit(load_batch, idxs)])
                else:
                    pending.put([pool.submit(self.dataset.__getitem__, i)
                                 for i in idxs])
                return True

            for _ in range(self.prefetch_batches):
                if not submit_next():
                    break
            while not pending.empty():
                done = [f.result() for f in pending.get()]
                submit_next()
                yield (done[0] if assemble is not None
                       else finish(collate(done)))


class Prefetcher:
    """One-ahead prefetch on a background thread (upgrades the reference's
    synchronous Prefetcher, dataloader/utils.py:32-48, to true overlap).

    ``stop()`` abandons the rest of the epoch and joins the producer —
    callers that break out early (benchmarks, step-capped epochs) would
    otherwise leave decode threads burning CPU behind the next consumer."""

    def __init__(self, loader: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop_ev = threading.Event()
        self._finished = False

        def run():
            it = iter(loader)
            try:
                while not self._stop_ev.is_set():
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    while not self._stop_ev.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            pass
            finally:
                # drop the generator: DataLoader.__iter__ unwinds its
                # thread-pool context (waits for in-flight __getitem__s)
                it = None
                while True:
                    try:
                        self._q.put(self._done, timeout=0.1)
                        break
                    except queue.Full:
                        try:
                            self._q.get_nowait()
                        except queue.Empty:
                            pass

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def next(self):
        if self._finished:
            return None
        item = self._q.get()
        if item is self._done:
            self._finished = True
            return None
        return item

    def stop(self) -> None:
        """Abandon the remaining epoch: signal the producer, drain the
        queue to its done sentinel, join. Idempotent; a no-op after the
        loader was consumed to exhaustion."""
        if self._finished:
            return
        self._stop_ev.set()
        while True:
            item = self._q.get()
            if item is self._done:
                break
        self._finished = True
        self._t.join(timeout=60)
