"""Thread-pool prefetch loader: indexable dataset -> shuffled, batched,
host-prefetched numpy batches (counterpart of the JAX package's
``data/loader.py``; the same batches in the same order for a seed).

A thread pool maps ``dataset[i]`` and a bounded queue keeps ``prefetch``
batches ready, so the host prepares the next batches while the card runs
the step. Batches are stacked numpy trees; the trainer copies them to the
card through pinned memory without waiting (``train/trainer.py``). An
error in ``dataset[i]`` (a file that does not decode) is raised by the
iterator, where the JAX package's loader would wait for the batch forever.

Given a ``mesh`` (``parallel/mesh.py``), ``batch_size`` is the global
batch: every rank walks the same epoch permutation and loads only its rows
of each batch, yielded as a ``Shard`` (the rows and their tree), which the
trainer takes as it is. Each rank then runs ``num_workers // ranks on the
host`` threads (at least one), so that the ranks of a host share its cores.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np

from dgm_img_super_resolution_tpu_torch.parallel.mesh import Mesh, Shard, batch_rows, local_world


def _stack(samples: list) -> Any:
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class _Failed:
    """An error of the producer thread, on its way to the consumer."""

    def __init__(self, error: Exception):
        self.error = error


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, drop_last: bool = True, endless: bool = False,
                 collate_fn: Callable | None = None, mesh: Mesh | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.mesh = mesh
        self.num_workers = max(1, num_workers // (local_world() if mesh is not None else 1))
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.endless = endless
        self.collate_fn = collate_fn or _stack

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Any]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def producer():
            epoch = 0
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    while not stop.is_set():
                        idx = self._epoch_indices(epoch)
                        for b in range(len(self)):
                            if stop.is_set():
                                return
                            sel = idx[b * self.batch_size: (b + 1) * self.batch_size]
                            if self.mesh is None:
                                q.put(self.collate_fn(list(pool.map(self.dataset.__getitem__, sel))))
                                continue
                            rows = batch_rows(len(sel), self.mesh)
                            data = self.collate_fn(list(pool.map(self.dataset.__getitem__, rows.take(sel))))
                            q.put(Shard(data, rows))
                        if not self.endless:
                            break
                        epoch += 1
            except Exception as e:  # handed to the consumer, which raises it
                q.put(_Failed(e))
                return
            q.put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            stop.set()
            while not q.empty():  # drain so that the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
