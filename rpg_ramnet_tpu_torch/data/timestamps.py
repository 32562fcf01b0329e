"""Timestamp index of an on-disk sensor stream folder.

Counterpart of ``rpg_ramnet_tpu/data/timestamps.py`` (reference
RAM_Net/data_loader/event_dataset.py:37-110 and RAM_Net/utils/util.py:17-36):
timestamps.txt parsing, start/stop windowing, the initial-stamp offset, the
MVSEC length-1 quirk, and the searchsorted helpers with the MVSEC 0.01 s
tolerance fix.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np


def first_element_greater_than(values: np.ndarray, req: float) -> Tuple[int, Optional[float]]:
    """Min i with values[i] >= req; with the reference's MVSEC fix: if the
    found stamp is more than 0.01s away, step back one (util.py:17-27)."""
    i = int(np.searchsorted(values, req))
    if i < len(values) and abs(values[i] - req) > 0.01:
        i -= 1
    elif i >= len(values):
        # out of range: mirror reference behavior (index error there); clamp
        # with the same -1 fix so callers can assert on tolerance themselves
        i -= 1
    val = float(values[i]) if 0 <= i < len(values) else None
    return i, val


def last_element_less_than(values: np.ndarray, req: float) -> Tuple[int, Optional[float]]:
    i = int(np.searchsorted(values, req, side="right")) - 1
    val = float(values[i]) if i >= 0 else None
    return i, val


def is_mvsec_folder(base_folder: str) -> bool:
    """The reference gates MVSEC code paths on the folder name
    (event_dataset.py:28-31)."""
    return "mvsec" in base_folder and "javi" not in base_folder


@dataclasses.dataclass
class TimestampIndex:
    """Windowed timestamp table for one sensor stream folder."""
    stamps: np.ndarray          # offset so stream starts at 0
    initial_stamp: float
    first_valid_idx: int
    last_valid_idx: int
    length: int

    @staticmethod
    def load(folder: str, start_time: float = 0.0, stop_time: float = 0.0,
             mvsec_drop_last: bool = False) -> "TimestampIndex":
        raw = np.loadtxt(os.path.join(folder, "timestamps.txt"))
        if raw.size == 0:
            raise IOError(f"Dataset is empty: {folder}")
        if raw.ndim == 1:
            raw = raw.reshape(1, -1)
        stamps = raw[:, 1]
        if not np.all(np.diff(stamps) > 0):
            raise ValueError(
                f"timestamps are not unique and monotonically increasing: {folder}")
        initial = float(stamps[0])
        stamps = stamps - initial

        if start_time <= 0.0:
            first_idx = 0
        else:
            first_idx, first_stamp = first_element_greater_than(stamps, start_time)
            assert first_stamp is not None
        if stop_time <= 0.0:
            last_idx = len(stamps) - 1
        else:
            last_idx, last_stamp = last_element_less_than(stamps, stop_time)
            assert last_stamp is not None
        assert stamps[first_idx] <= stamps[last_idx]

        length = last_idx - first_idx + 1
        if mvsec_drop_last:
            length -= 1  # event_dataset.py:79-80
        assert length > 0
        return TimestampIndex(stamps=stamps, initial_stamp=initial,
                              first_valid_idx=first_idx, last_valid_idx=last_idx,
                              length=length)

    def index_at(self, i: int) -> int:
        return self.first_valid_idx + i

    def stamp_at(self, i: int) -> float:
        return float(self.stamps[self.index_at(i)])

    def last_stamp(self) -> float:
        return float(self.stamps[self.last_valid_idx])
