"""Batched, prefetching host data loading.

Counterpart of ``rpg_ramnet_tpu/data/loader.py`` (reference: torch
DataLoader + ConcatDatasetCustom, RAM_Net/train.py:23-75,189-196):
``concatenate_subfolders``, ``ConcatSequenceDataset``, a ``BatchLoader``
whose thread or process workers produce fixed-shape numpy batches, two
batches in flight, and ``device_prefetch``, which copies the next batches
to the card on a side CUDA stream while the current one trains.
Augmentation seeds are per (seed, epoch, index), so an epoch is
reproducible and resume continues the exact data order.  Under
data-parallel training every rank draws the same global order and loads
only its items of each global batch (``shard``).
"""
from __future__ import annotations

import multiprocessing
import os
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from os.path import join
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.registry import DATASETS
from ..parallel.input_pipeline import as_shard, local_indices


def concatenate_subfolders(base_folder: str, dataset_type: str,
                           event_folder: str, depth_folder: str,
                           frame_folder: str, sequence_length: int,
                           transform=None, proba_pause_when_running: float = 0.0,
                           proba_pause_when_paused: float = 0.0,
                           step_size: int = 1, clip_distance: float = 100.0,
                           every_x_rgb_frame: int = 1, normalize: bool = True,
                           scale_factor: float = 1.0, reg_factor: float = 5.7,
                           load_semantic: bool = False,
                           use_phased_arch: bool = False, baseline=False,
                           loss_composition=False, recurrency: bool = True
                           ) -> "ConcatSequenceDataset":
    """One dataset per sequence subfolder, concatenated (train.py:37-75);
    baseline, loss_composition and recurrency go to each dataset (JAX
    loader.py:29-48)."""
    cls = DATASETS.get(dataset_type)
    return ConcatSequenceDataset([
        cls(base_folder=join(base_folder, name), event_folder=event_folder,
            depth_folder=depth_folder, frame_folder=frame_folder,
            sequence_length=sequence_length, transform=transform,
            proba_pause_when_running=proba_pause_when_running,
            proba_pause_when_paused=proba_pause_when_paused,
            step_size=step_size, clip_distance=clip_distance,
            every_x_rgb_frame=every_x_rgb_frame, normalize=normalize,
            scale_factor=scale_factor, reg_factor=reg_factor,
            load_semantic=load_semantic, use_phased_arch=use_phased_arch,
            baseline=baseline, loss_composition=loss_composition,
            recurrency=recurrency)
        for name in sorted(os.listdir(base_folder))])


class ConcatSequenceDataset:
    """Concatenation that also reports which sequence an index fell in
    (the reference's ConcatDatasetCustom, train.py:23-34)."""

    def __init__(self, datasets: Sequence):
        self.datasets = [d for d in datasets if len(d) > 0]
        self.cumulative = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self) -> int:
        return self.cumulative[-1] if self.cumulative else 0

    def locate(self, idx: int) -> Tuple[int, int]:
        if idx < 0:
            idx += len(self)
        d = int(np.searchsorted(self.cumulative, idx, side="right"))
        return d, idx - (self.cumulative[d - 1] if d > 0 else 0)

    def __getitem__(self, idx: int):
        d, local = self.locate(idx)
        return self.datasets[d][local], d

    def get(self, idx: int, seed: Optional[int] = None):
        d, local = self.locate(idx)
        return self.datasets[d].__getitem__(local, seed), d


def _stack_items(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


# process-worker plumbing, at module level so that it pickles under spawn
_WORKER_DATASET = None


def _proc_worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _proc_load_item(idx: int, seed: int) -> Dict[str, np.ndarray]:
    return _WORKER_DATASET.get(int(idx), seed=seed)[0]


class BatchLoader:
    """Shuffled epoch iterator over a ConcatSequenceDataset producing
    batched numpy dicts ('events' [B, L, K, H, W, C], 'image'
    [B, L, H, W, C], ...); num_workers workers load the items, two batches
    ahead.  drop_last as torch's DataLoader (False by default).

    worker_mode: 'thread' (the default: the decoding is numpy and PIL,
    which release the GIL for the heavy parts) or 'process' (the
    reference's DataLoader runs 4 process workers, train.py:192-196: for
    hosts where per-item Python work, not IO, bounds the loading).  The
    process pool lives as long as the loader, is started by spawn (no
    fork of a process with CUDA or torch threads), gets the dataset once
    through its initializer, never touches CUDA, and is shut down by
    ``close()``.  Both modes draw the same per-(seed, epoch, index)
    augmentation seeds, so their batches are bit-identical.

    shard: (rank, world[, grad_accum]): batch_size is the global batch,
    whose order is the same on every rank, and each batch holds only
    rank's items of it (``local_indices``: its share of each
    micro-batch); a global batch that does not divide raises."""

    def __init__(self, dataset: ConcatSequenceDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 4,
                 drop_last: bool = False, seed: int = 0, shard=None,
                 worker_mode: str = "thread"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}: 'thread' or "
                             "'process'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.shard = as_shard(shard)
        self.worker_mode = worker_mode
        self._proc_pool: Optional[ProcessPoolExecutor] = None

    def _get_proc_pool(self) -> ProcessPoolExecutor:
        if self._proc_pool is None:
            self._proc_pool = ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_proc_worker_init, initargs=(self.dataset,))
        return self._proc_pool

    def close(self) -> None:
        """Shut the process pool down (a no-op in thread mode); the next
        epoch would start a new one."""
        if self._proc_pool is not None:
            self._proc_pool.shutdown(cancel_futures=True)
            self._proc_pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle/augmentation epoch; the trainer calls this so a
        resumed run reproduces the data order."""
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        epoch = self.epoch
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.shard is not None:
            batches = [b[local_indices(len(b), *self.shard)] for b in batches]

        def item_seed(i) -> int:
            return zlib.crc32(f"{self.seed}/{epoch}/{int(i)}".encode()) \
                & 0x7FFFFFFF

        if self.worker_mode == "process":
            yield from self._run(self._get_proc_pool(), _proc_load_item,
                                 batches, item_seed)
        else:
            def load(i: int, seed: int):
                return self.dataset.get(i, seed=seed)[0]

            with ThreadPoolExecutor(self.num_workers) as pool:
                yield from self._run(pool, load, batches, item_seed)

    @staticmethod
    def _run(pool, load, batches, item_seed):
        def schedule(b):
            return [pool.submit(load, int(i), item_seed(i)) for i in b]

        inflight = [schedule(b) for b in batches[:2]]
        for b in batches[2:]:
            futs = inflight.pop(0)
            inflight.append(schedule(b))
            yield _stack_items([f.result() for f in futs])
        for futs in inflight:
            yield _stack_items([f.result() for f in futs])


def device_prefetch(iterator: Iterable[Dict[str, np.ndarray]],
                    device: torch.device, size: int = 2, stage=None
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields the batches of ``iterator`` (dicts of numpy arrays) as
    tensors on ``device``, the next ``size`` already copied or in flight
    while the consumer computes on the current one (JAX
    ``device_prefetch``, loader.py:206-233).  On a CUDA device each batch
    is staged in pinned host memory and copied on a side stream; the
    consumer's stream waits for the copy before it gets the batch, and the
    tensors are recorded on the consumer's stream, so the allocator keeps
    their memory until the work queued on them is done.  On the CPU the
    arrays become tensors without a copy.  stage: a function of the
    batch's device tensors run after the copy, on the side stream (the
    raw pipeline's voxelization), whose dict is yielded."""
    if device.type != "cuda":
        for batch in iterator:
            out = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}
            yield out if stage is None else stage(out)
        return
    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in batch.items()}
        with torch.cuda.stream(copy_stream):
            out = {k: v.to(device, non_blocking=True)
                   for k, v in pinned.items()}
            if stage is not None:
                out = stage(out)
            done = torch.cuda.Event()
            done.record(copy_stream)
        # the pinned buffers stay referenced until the copy has completed
        return out, done, pinned

    buf = []
    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) == size:
            break
    while buf:
        out, done, pinned = buf.pop(0)
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for v in out.values():
            v.record_stream(consumer)
        yield out
        # the staging goes back to torch's pinned-memory cache, which
        # reuses a block only once the copies recorded on it have completed
        del out, pinned
