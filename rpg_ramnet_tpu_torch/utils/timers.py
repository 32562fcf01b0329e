"""Profiling timers.

Counterpart of ``rpg_ramnet_tpu/utils/timers.py`` (reference
RAM_Net/utils/timers.py: Timer:29 / CudaTimer:10 context managers
accumulating per-name lists in module globals, printed at exit via
atexit): ``Timer`` (wall clock), ``DeviceTimer`` (the CudaTimer analog:
CUDA events around the block after a device barrier; the host clock for
a CPU device), and ``profile_trace``, a ``torch.profiler`` trace of the
block written to a log directory.
"""
from __future__ import annotations

import atexit
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import torch

timers: Dict[str, List[float]] = defaultdict(list)


class Timer:
    """Wall-clock timer accumulating into the module-level `timers` dict."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.interval = time.perf_counter() - self.start
        timers[self.name].append(self.interval)
        return False


class DeviceTimer:
    """Synchronized device timer: waits for all queued device work before
    starting, then times the block by two CUDA events on the current
    stream (seconds, into `timers`).  device: a CUDA device (None: the
    current one, which must exist) or the CPU, where the barrier is a
    no-op and the host clock times the block.  `sync()` takes the
    block's outputs, as the JAX timer's does; the end event covers them."""

    def __init__(self, name: str, device=None):
        from .device import require_cuda
        self.name = name
        self.device = require_cuda() if device is None else torch.device(device)
        self._outputs = None

    def sync(self, *tensors):
        self._outputs = tensors
        return tensors if len(tensors) != 1 else tensors[0]

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            self.interval = self._start.elapsed_time(end) / 1e3
        else:
            self.interval = time.perf_counter() - self.start
        timers[self.name].append(self.interval)
        return False


@contextmanager
def profile_trace(logdir: str):
    """torch.profiler over the block (the CPU, and the card where there is
    one), its Chrome trace written to ``logdir/trace.json`` (view it in
    Perfetto or chrome://tracing); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def print_timing_info():
    if not timers:
        return
    print("== Timing statistics ==")
    for name, values in timers.items():
        mean_ms = 1000.0 * sum(values) / len(values)
        print(f"{name}: {mean_ms:.2f} ms ({len(values)} samples)")


atexit.register(print_timing_info)
