"""Batched, prefetching host data loading.

Counterpart of ``rpg_ramnet_tpu/data/loader.py`` (reference: torch
DataLoader + ConcatDatasetCustom, RAM_Net/train.py:23-75,189-196):
``concatenate_subfolders``, ``ConcatSequenceDataset``, a thread-pooled
``BatchLoader`` producing fixed-shape numpy batches, two batches in
flight, and ``device_prefetch``, which copies the next batches to the
card on a side CUDA stream while the current one trains.
Augmentation seeds are per (seed, epoch, index), so an epoch is
reproducible and resume continues the exact data order.  Under
data-parallel training every rank draws the same global order and loads
only its items of each global batch (``shard``).
"""
from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
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
    if dataset_type not in DATASETS:
        raise NotImplementedError(
            f"dataset type {dataset_type!r} is not ported yet: ROADMAP queue "
            "1, item 6")
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


class BatchLoader:
    """Shuffled epoch iterator over a ConcatSequenceDataset producing
    batched numpy dicts ('events' [B, L, K, H, W, C], 'image'
    [B, L, H, W, C], ...); num_workers threads load the items, two batches
    ahead.  drop_last as torch's DataLoader (False by default).  JAX's
    process workers have no caller there and are not ported (ROADMAP
    queue 1, item 8).  shard: (rank, world[, grad_accum]): batch_size is
    the global batch, whose order is the same on every rank, and each
    batch holds only rank's items of it (``local_indices``: its share of
    each micro-batch); a global batch that does not divide raises."""

    def __init__(self, dataset: ConcatSequenceDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 4,
                 drop_last: bool = False, seed: int = 0, shard=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.shard = as_shard(shard)

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

        def load(i: int):
            seed = zlib.crc32(f"{self.seed}/{epoch}/{int(i)}".encode()) \
                & 0x7FFFFFFF
            return self.dataset.get(int(i), seed=seed)[0]

        with ThreadPoolExecutor(self.num_workers) as pool:
            inflight = [[pool.submit(load, i) for i in b] for b in batches[:2]]
            for b in batches[2:]:
                futs = inflight.pop(0)
                inflight.append([pool.submit(load, i) for i in b])
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
