"""Vector clocks (paper §4.2).

Each client library maintains a vector clock over its worker threads; the
minimum entry is the process's progress.  The server keeps a vector clock
over processes.
"""
from __future__ import annotations

import numpy as np


class VectorClock:
    def __init__(self, n_entries: int):
        self._c = np.zeros(n_entries, dtype=np.int64)

    def tick(self, entry: int) -> int:
        self._c[entry] += 1
        return int(self._c[entry])

    def set(self, entry: int, value: int) -> None:
        if value < self._c[entry]:
            raise ValueError(
                f"vector clock entry {entry} would move backwards "
                f"({self._c[entry]} -> {value})")
        self._c[entry] = value

    def get(self, entry: int) -> int:
        return int(self._c[entry])

    def min(self) -> int:
        return int(self._c.min())

    def max(self) -> int:
        return int(self._c.max())

    def snapshot(self) -> np.ndarray:
        return self._c.copy()

    def __len__(self) -> int:
        return len(self._c)

    def __repr__(self) -> str:
        return f"VectorClock({self._c.tolist()})"
