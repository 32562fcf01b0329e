"""Streaming raw-event readers for text and zipped event logs.

Counterpart of ``rpg_ramnet_tpu/utils/event_readers.py`` (reference
RAM_Net/utils/event_readers.py: FixedSizeEventReader:8,
FixedDurationEventReader:32).  Rows are "t x y p" after one header line;
a ``.zip`` holds one such file.  Windows are [N, 4] float64 numpy arrays.
The fixed-size reader parses with numpy, not pandas, which the machines
the port runs on need not have.
"""
from __future__ import annotations

import io
import itertools
import zipfile
from typing import Optional

import numpy as np


def _open_text(path: str):
    """The event log as a text stream: the single member of a .zip, else
    the file."""
    if path.endswith(".zip"):
        archive = zipfile.ZipFile(path)
        names = archive.namelist()
        if len(names) != 1:
            archive.close()
            raise ValueError(f"{path} must hold one event file, holds {names}")
        return archive, io.TextIOWrapper(archive.open(names[0], "r"))
    return None, open(path, "r")


class FixedSizeEventReader:
    """Iterates windows of ``num_events`` events (the last may be shorter),
    after skipping the header and ``start_index`` rows."""

    def __init__(self, path_to_event_file: str, num_events: int = 10000,
                 start_index: int = 0):
        self._zip, self._file = _open_text(path_to_event_file)
        for _ in range(start_index + 1):
            self._file.readline()
        self.num_events = num_events

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._file.closed:
            raise StopIteration
        lines = list(itertools.islice(self._file, self.num_events))
        if not lines:
            self.close()
            raise StopIteration
        return np.loadtxt(lines, dtype=np.float64, ndmin=2)

    def close(self) -> None:
        self._file.close()
        if self._zip is not None:
            self._zip.close()


class FixedDurationEventReader:
    """Iterates windows of events spanning ``duration_ms`` (reference
    event_readers.py:32-88): a window closes at the first event more than
    the duration after the window's first stamp, and includes it."""

    def __init__(self, path_to_event_file: str, duration_ms: float = 50.0,
                 start_index: int = 0):
        self._zip, self._file = _open_text(path_to_event_file)
        for _ in range(start_index + 1):  # skip header + start offset
            self._file.readline()
        self.duration_s = duration_ms / 1000.0
        self.last_stamp: Optional[float] = None

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._file.closed:
            raise StopIteration
        event_list = []
        for line in self._file:
            t, x, y, pol = line.split(" ")
            t, x, y, pol = float(t), int(x), int(y), int(pol)
            event_list.append([t, x, y, pol])
            if self.last_stamp is None:
                self.last_stamp = t
            if t > self.last_stamp + self.duration_s:
                self.last_stamp = t
                return np.array(event_list)
        self.close()
        raise StopIteration

    def close(self) -> None:
        self._file.close()
        if self._zip is not None:
            self._zip.close()
