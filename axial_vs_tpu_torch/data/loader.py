"""Training data loader on ``torch.utils.data`` (counterpart of
``axial_vs_tpu/data/loader.py``).

An ``IterableDataset`` yields whole batches, each drawn as the JAX loader
draws it (``_make_batch``: ``batch_size`` videos picked at random, each
through the mapper, the samples stacked, the clip frames folded into the
batch axis); worker ``wid`` draws from ``RandomState(seed * 1000 + wid)``.
``num_workers=0`` runs the mapper in the caller, synchronously, in the JAX
loader's batch order. With workers, a ``DataLoader`` runs them as processes
of a ``forkserver`` (else ``spawn``) context, never ``fork``, with
``timeout`` seconds for each batch: a dead or stuck worker raises instead
of hanging. Batches arrive as torch tensors, pinned when asked.

Shutdown goes through the ``DataLoader``'s own iterator (``close()``); the
JAX loader's queue drain is not ported. ``device_prefetch`` keeps a batch
in flight to the device: its copies are issued non-blocking one batch
ahead of the one the caller is given.
"""
from __future__ import annotations

import multiprocessing as mp
import time
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
from torch.utils.data import DataLoader, IterableDataset, get_worker_info


def _stack_tree(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack_tree([s[k] for s in samples]) for k in first}
    return np.stack(samples)


def _make_batch(dataset, mapper, batch_size, rng):
    n = len(dataset)
    idxs = rng.randint(0, n, batch_size)
    samples = [mapper(dataset[i], dataset=dataset) for i in idxs]
    batch = _stack_tree(samples)
    # (B, T, H, W, 3) -> (B*T, H, W, 3) for the model
    imgs = batch["images"]
    if imgs.ndim == 5:
        batch["images"] = imgs.reshape(-1, *imgs.shape[2:])
    return batch


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


class BatchStream(IterableDataset):
    """Endless batches of one worker: ``_make_batch`` from
    ``RandomState(seed * 1000 + worker id)``."""

    def __init__(self, dataset: Sequence, mapper: Callable, batch_size: int,
                 seed: int = 0):
        self.dataset = list(dataset)
        self.mapper = mapper
        self.batch_size = batch_size
        self.seed = seed

    def __iter__(self):
        info = get_worker_info()
        wid = info.id if info is not None else 0
        rng = np.random.RandomState(self.seed * 1000 + wid)
        while True:
            yield _to_tensors(_make_batch(self.dataset, self.mapper,
                                          self.batch_size, rng))


def _mp_context():
    try:
        return mp.get_context("forkserver")
    except ValueError:  # a platform without forkserver
        return mp.get_context("spawn")


class ClipDataLoader:
    """Endless batches over a video dataset. ``num_workers=0``: synchronous
    in the caller; otherwise worker processes, ``prefetch`` batches ahead
    each, ``timeout`` seconds at most for a batch."""

    def __init__(self, dataset: Sequence, mapper: Callable, batch_size: int,
                 num_workers: int = 4, prefetch: int = 2, seed: int = 0,
                 timeout: float = 120.0, pin_memory: bool = False):
        self.stream = BatchStream(dataset, mapper, batch_size, seed)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.timeout = timeout
        self.pin_memory = pin_memory
        self._iter = None

    def __iter__(self) -> Iterator:
        if self.num_workers == 0:
            return iter(self.stream)
        self.close()
        loader = DataLoader(
            self.stream, batch_size=None, num_workers=self.num_workers,
            prefetch_factor=max(self.prefetch, 1), timeout=self.timeout,
            pin_memory=self.pin_memory, multiprocessing_context=_mp_context())
        self._iter = iter(loader)
        return self._iter

    def workers(self):
        """The live iterator's worker processes (empty without one)."""
        return list(getattr(self._iter, "_workers", ()))

    def close(self) -> float:
        """Stop the workers of the live iterator through the DataLoader's
        own shutdown; returns the seconds it took. Raises if a worker is
        still alive after it."""
        it, self._iter = self._iter, None
        if it is None:
            return 0.0
        t0 = time.perf_counter()
        workers = list(getattr(it, "_workers", ()))
        it._shutdown_workers()
        alive = [w.pid for w in workers if w.is_alive()]
        if alive:
            raise RuntimeError(f"loader workers {alive} outlived the shutdown")
        return time.perf_counter() - t0


def to_device(batch, device):
    """The batch's tensors on ``device`` (non-blocking copies from pinned
    memory)."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return batch.to(device, non_blocking=True)


def device_prefetch(iterator, placement_fn):
    """Yield ``placement_fn(batch)`` for each batch, the next batch placed
    before the current one is yielded."""
    it = iter(iterator)
    try:
        ahead = placement_fn(next(it))
    except StopIteration:
        return
    for batch in it:
        nxt = placement_fn(batch)
        yield ahead
        ahead = nxt
    yield ahead
