"""Shard membership: the static epoch-0 partition.

Row ``r`` of every key lives on shard ``active[r % A]`` at local index
``r // A`` of that shard's dense block.  This slice of the port runs one
epoch with every shard active; live re-partitioning (add/remove shard, the
epoch barrier protocol) is ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# "infinitely caught up": a retired slot's frontier contribution
INF_CLOCK = 1 << 60

_EMPTY_ROWS = np.empty(0, dtype=np.int64)


class Partition:
    """Epoch-stamped ownership map: row ``r`` of every key is owned by
    ``active[r % len(active)]`` and stored at local index ``r // len(active)``
    in the owner's dense block.

    Immutable; built deterministically from ``(epoch, active, row_counts)``.
    """

    def __init__(self, epoch: int, active: Sequence[int],
                 row_counts: Dict[str, int]):
        if not active:
            raise ValueError("a partition needs at least one active shard")
        self.epoch = epoch
        self.active: Tuple[int, ...] = tuple(active)
        self.A = len(self.active)
        self._index = {sid: i for i, sid in enumerate(self.active)}
        self._rows: Dict[str, List[np.ndarray]] = {}
        for key, r in row_counts.items():
            rows = np.arange(r, dtype=np.int64)
            self._rows[key] = [np.ascontiguousarray(rows[rows % self.A == i])
                               for i in range(self.A)]

    def rows_of(self, key: str, sid: int) -> np.ndarray:
        """Global row ids of ``key`` owned by slot ``sid`` (empty if the
        slot is inactive in this epoch)."""
        i = self._index.get(sid)
        if i is None:
            return _EMPTY_ROWS
        return self._rows[key][i]

    def __repr__(self) -> str:
        return f"Partition(epoch={self.epoch}, active={self.active})"
