"""Batched, per-process-sharded input pipeline, the port's replacement of
partseg_tpu/data/loader.py (which is built on grain, and grain imports
JAX). Host workers only decode and crop; the paired augmentation runs on
the device inside the train step.

Every backend cuts its batches from one index stream (``batch_indices``),
the JAX package's native-loader order (partseg_tpu/data/native.py): the
process's shard ``idxs[process_index::process_count]``, one
``np.random.default_rng(seed)`` permutation of it per epoch, repeated and
cut into batches, an epoch's remainder carried into the next batch. So
batch #N covers stream positions [N·bs, (N+1)·bs) and ``start_batch``
seeks without decoding anything. With ``backend="grain"`` the JAX package
shuffles with grain's own permutation, which cannot be reproduced without
grain: there the port's order is JAX's ``backend="native"`` order.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Any, Iterator

import numpy as np


def batch_indices(n: int, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                  process_index: int = 0, process_count: int = 1, start_batch: int = 0,
                  num_epochs: int | None = None,
                  drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """The dataset indices of each batch, from batch #start_batch on;
    endless unless ``num_epochs`` bounds the stream. A bounded stream's
    last partial batch is dropped, or with ``drop_remainder=False``
    yielded short (an eval must score the whole split)."""
    idxs = np.arange(n)[process_index::process_count]
    n_shard = len(idxs)
    if n_shard == 0:
        raise ValueError("empty shard: no examples for this process")
    rng = np.random.default_rng(seed)
    pos = start_batch * batch_size           # the stream position
    for _ in range(pos // n_shard):          # one permutation per crossed epoch
        if shuffle:
            rng.permutation(idxs)
    order = rng.permutation(idxs) if shuffle else idxs
    offset = pos % n_shard
    end = None if num_epochs is None else num_epochs * n_shard
    while end is None or pos + batch_size <= end:
        sel = []
        while len(sel) < batch_size:
            take = min(batch_size - len(sel), n_shard - offset)
            sel.extend(order[offset:offset + take])
            offset += take
            if offset == n_shard:
                order = rng.permutation(idxs) if shuffle else idxs
                offset = 0
        pos += batch_size
        yield np.asarray(sel)
    if not drop_remainder and pos < end:
        yield np.asarray(order[offset:offset + end - pos])


def make_loader(
    dataset: Any,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    num_epochs: int | None = None,
    num_workers: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    backend: str = "grain",
    start_batch: int = 0,
    drop_remainder: bool = True,
) -> Iterator[dict]:
    """Wrap a dataset into a batched iterator of dicts of stacked numpy
    arrays. ``batch_size`` is the per-process batch.

    backend="native" decodes an ImageListDataset's files in the C++ pool
    (partseg_native; uint8 images only); any other backend calls the
    dataset's ``__getitem__`` on a pool of max(num_workers, 1) threads.
    ``start_batch`` seeks: the first batch is batch #start_batch of the
    start_batch=0 stream. The train loop takes one batch per
    ``data_echo`` steps, so its resume passes start_step // data_echo.
    ``drop_remainder=False`` (with ``num_epochs``) yields the last partial
    batch too, as the eval protocols need.
    """
    if backend == "native":
        if num_epochs is not None:
            raise ValueError("the native backend streams without end: num_epochs must be None")
        from partseg_tpu_torch.data.native import native_loader

        return native_loader(
            dataset, batch_size, shuffle=shuffle, seed=seed,
            num_threads=max(num_workers, 1) * 2,
            process_index=process_index, process_count=process_count,
            start_batch=start_batch,
        )
    batches = batch_indices(len(dataset), batch_size, shuffle=shuffle, seed=seed,
                            process_index=process_index, process_count=process_count,
                            start_batch=start_batch, num_epochs=num_epochs,
                            drop_remainder=drop_remainder)
    return _indexed_batches(dataset, batches, max(num_workers, 1))


def _indexed_batches(dataset, batches: Iterator[np.ndarray], workers: int) -> Iterator[dict]:
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for sel in batches:
            yield _stack(list(pool.map(dataset.__getitem__, sel.tolist())))


def _stack(examples: list[dict]) -> dict:
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples]) for k in keys}


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a daemon thread with a bounded queue so host
    batch assembly overlaps the device step. An exception the iterator
    raises in the thread is raised again by the consumer's ``next`` (the
    JAX package's prefetch ends the stream instead)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    failed: list[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:      # handed to the consumer below
            failed.append(e)
        finally:
            q.put(_END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            if failed:
                raise failed[0]
            return
        yield item
