"""Wire protocol of the threaded parameter-server runtime.

All cross-thread communication goes through :class:`Channel` objects — FIFO
per (sender, receiver) pair, mirroring the simulator's per-channel delivery
ordering (``server.py`` ``_last_sched`` / ``_last_seq_seen``).  A channel
stamps every message with a per-channel sequence number under its lock so the
receiver can *assert* FIFO delivery instead of assuming it; violations are
recorded in ``RunStats.violations`` exactly like the simulator does.

Message flow (client process p, server shard s):

    p -> s : UpdateMsg   one hash-partitioned row-slice of an Inc
             ClockMsg    process p completed period `clock`
             AckBatchMsg coalesced acks: one frame per (client, shard, flush)
    s -> p : DeliverMsg  propagate an update part to a peer process cache
             ClockMarker shard-side echo of a peer's ClockMsg (frontier)
             FullyDelivered
                         every peer acked an update part — the origin
                         worker's unsynchronized accumulator may shrink

Messages carry host numpy arrays: the shard copies a part's rows and delta
to the device only to apply them to its master block.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field

import numpy as np

SHUTDOWN = None  # sentinel put on an inbox to stop its thread


@dataclass
class UpdateMsg:
    uid: int                 # unique id of this update *part*
    worker: int              # global worker-thread id
    process: int             # origin client process
    ts: int                  # clock timestamp (0-based period index)
    key: str
    rows: np.ndarray         # row ids of the (R, C) key matrix in this part
    delta: np.ndarray        # (len(rows), C) row deltas
    epoch: int = 0           # membership epoch the sender routed under
    seq: int = -1

    @property
    def nbytes(self) -> int:
        return int(self.delta.nbytes)


@dataclass
class ClockMsg:
    process: int
    clock: int               # period just completed by `process`
    epoch: int = 0           # membership epoch at send time
    # optional (LOAD_LEN,) float64 snapshot of the process's load counters
    # (repro_torch.runtime.metrics), taken at this boundary and piggybacked
    # on the control message it already sends
    load: object = None
    seq: int = -1


@dataclass
class AckBatchMsg:
    """All acks of one (client, shard) flush in a single message: the uids
    travel as one int64 buffer instead of one message per delivered part."""
    uids: np.ndarray         # int64 uids of the DeliverMsgs applied
    process: int             # acking process
    seq: int = -1


@dataclass
class DeliverMsg:
    uid: int
    worker: int
    process: int             # origin process
    shard: int
    ts: int
    key: str
    rows: np.ndarray
    delta: np.ndarray
    seq: int = -1

    @property
    def nbytes(self) -> int:
        return int(self.delta.nbytes)


@dataclass
class ClockMarker:
    process: int             # origin process whose period completed
    shard: int
    clock: int
    epoch: int = 0           # sender shard's epoch at send
    seq: int = -1


@dataclass
class FullyDelivered:
    uid: int
    worker: int
    key: str
    rows: np.ndarray
    delta: np.ndarray
    shard: int
    seq: int = -1


@dataclass
class Channel:
    """FIFO edge into a receiver's inbox, stamping per-channel seq numbers.

    The stamp and the enqueue happen under one lock so the sequence numbers
    are monotone in *queue order* even with multiple sender threads sharing
    the channel (all workers of a process send on the same proc->shard edge).
    """

    name: str
    inbox: queue.Queue
    _seq: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def send(self, msg) -> None:
        with self._lock:
            msg.seq = self._seq
            self._seq += 1
            self.inbox.put(msg)

    def send_many(self, msgs) -> None:
        """Stamp and enqueue a batch atomically w.r.t. other senders."""
        with self._lock:
            for m in msgs:
                m.seq = self._seq
                self._seq += 1
                self.inbox.put(m)


def group_by_channel(pairs):
    """[(chan, msg), ...] -> [(chan, [msgs...]), ...], preserving each
    channel's message order (the unit senders batch into one frame)."""
    by = {}
    for chan, msg in pairs:
        by.setdefault(id(chan), (chan, []))[1].append(msg)
    return list(by.values())


def pump_inbox(inbox: queue.Queue, handle_batch, cap: int = 256) -> None:
    """Drain an inbox in coalesced batches (shared by shard and client comm
    loops): block for one message, greedily grab up to ``cap``, hand the
    batch to ``handle_batch`` (returns True on shutdown), mark all done."""
    while True:
        batch = [inbox.get()]
        try:
            while len(batch) < cap:
                batch.append(inbox.get_nowait())
        except queue.Empty:
            pass
        shutdown = handle_batch(batch)
        for _ in batch:
            inbox.task_done()
        if shutdown:
            return
