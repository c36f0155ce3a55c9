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

Elastic membership (the epoch protocol, :mod:`repro_torch.runtime.membership`):

    s -> p : EpochMsg      announce of the next epoch's active slots
    p -> s : EpochAckMsg   the client's barrier, FIFO-after its last
                           old-epoch Update/Clock on this channel
    manager -> s : EpochBeginMsg, InstallMsg  (in-process only)

Multi-process quiesce (forked clients over a wire transport):

    p -> s : ProcDoneMsg  process p finished all its clocks
    s -> p : ShardFinMsg  shard s has drained: nothing further follows

Serving tier (read replicas, :mod:`repro_torch.runtime.serving`):

    serving -> s : SubscribeMsg    a replica joins the shard's publish stream
                   UnsubscribeMsg  ... and leaves it
    s -> replica : ReplicaStateMsg in-stream bootstrap (partition + vc)
                   ReplicaDeltaMsg one coalesced delta per key per cycle
                   ReplicaVcMsg    applied vector clock, FIFO-behind deltas
                   ReplicaFinMsg   unsubscribe acknowledged, FIFO-last

Durability: a shard's write-ahead log stamps each group commit with a
:class:`ReplicaVcMsg` (its applied vector clock), the same stamp the
publish stream carries.

Messages carry host numpy arrays: the shard copies a part's rows and delta
to the device only to apply them to its master block, and a replica copies
a published delta to the device only to land it in its own buffers.  The
one exception never leaves this process: an :class:`InstallMsg` carries a
slot's re-partitioned master blocks as tensors on the runtime's device.
Every message that crosses a wire pickles, so the serving and epoch
messages ride the shm and tcp wires as pickle-5 frames
(:func:`repro_torch.runtime.transport.encode_frame`).
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
class EpochMsg:
    """Membership announce, manager -> every client (rides a designated
    active shard's FIFO channel; ``shard`` names it for the FIFO assert).
    The client swaps its key->shard router to ``(epoch, active)`` atomically
    w.r.t. its own sends, then acks on every involved channel."""
    epoch: int
    active: tuple            # active slot ids of the new epoch
    shard: int               # channel owner (the announce rides its FIFO)
    seq: int = -1


@dataclass
class EpochAckMsg:
    """Client -> shard epoch barrier: FIFO-after the client's last
    old-epoch Update/Clock on this channel.  A shard holding acks from
    every process will never see another old-epoch update."""
    process: int
    epoch: int
    seq: int = -1


@dataclass
class EpochBeginMsg:
    """Manager -> shard (in-process only, never pickled): the pending
    epoch's partition.  Enqueued before the client announce, so it always
    precedes the first ack in the shard's inbox."""
    epoch: int
    part: object             # membership.Partition
    seq: int = -1


@dataclass
class InstallMsg:
    """Manager -> shard (in-process only): adopt the new partition.
    ``blocks`` is the slot's re-partitioned dense state, ``{key: (n, C)
    float64 tensor on the runtime's device}``, or None for a retiring slot;
    ``seed_vc`` is the conservative applied-vc seed (host int64, the
    element-wise min over the handoff contributors)."""
    epoch: int
    part: object             # membership.Partition
    blocks: object           # Optional[Dict[str, torch.Tensor]]
    seed_vc: np.ndarray
    seq: int = -1


@dataclass
class ProcDoneMsg:
    """Client process finished all its clocks: no more Update/Clock msgs
    (acks for in-flight deliveries may still follow).  Multi-process quiesce,
    leg 1: every shard counts these."""
    process: int
    epoch: int = 0           # client's membership epoch at send (not held:
    seq: int = -1            # a pending install defers the fin instead)


@dataclass
class ShardFinMsg:
    """Shard has seen ProcDone from every process and drained its pending
    and queued deliveries: nothing further will be sent on this channel.
    Multi-process quiesce, leg 2: a client that has collected the fin of
    every shard holds its complete final state."""
    shard: int
    seq: int = -1


@dataclass
class SubscribeMsg:
    """A read replica subscribes to a shard's publish stream.  ``channel``
    is the live shard->replica publish channel (Channel or WireChannel):
    subscribe control always travels in-process (never over a wire), so the
    object reference is valid at the shard.  With ``want_state`` the shard
    first sends a :class:`ReplicaStateMsg` (in-stream bootstrap), then every
    later delta, all FIFO on the same channel."""
    replica: int
    channel: object
    want_state: bool = True
    seq: int = -1


@dataclass
class UnsubscribeMsg:
    """Stop publishing to this replica; the shard answers with a final
    :class:`ReplicaFinMsg` on the publish channel (FIFO-last), after which
    the serving tier may tear the channel down."""
    replica: int
    seq: int = -1


@dataclass
class ReplicaStateMsg:
    """In-stream bootstrap: the shard's dense partition at subscribe time,
    in the snapshot payload format (``{key: {"rows", "values"}}``, exactly
    :meth:`ServerShard.state`, host arrays), stamped with the shard's
    applied vector clock.  The replica writes the rows into its full-key
    buffers and adopts the stamp as its per-shard vector clock."""
    shard: int
    state: dict              # {key: {"rows": int64, "values": (n, C)}}
    clock_vc: np.ndarray     # (n_proc,) applied frontier at the cut
    seq: int = -1
    # membership epoch of the cut: the replica stamps the covered rows so
    # late older-epoch deltas (already folded into this state) are dropped
    epoch: int = -1


@dataclass
class ReplicaDeltaMsg:
    """Row deltas the shard applied in one cycle, coalesced per key (rows
    may repeat across source parts: they accumulate in order)."""
    shard: int
    key: str
    rows: np.ndarray         # global row ids
    delta: np.ndarray        # (len(rows), C)
    seq: int = -1
    epoch: int = -1          # membership epoch the publisher applied under

    @property
    def nbytes(self) -> int:
        return int(self.delta.nbytes)


@dataclass
class ReplicaVcMsg:
    """A shard's applied per-process vector clock, FIFO after every update
    part it covers (``clock_vc[p] == c``: every update of process p
    timestamped <= c that touches this shard's rows was applied).  The
    publish stream carries it behind the deltas it covers, and the
    write-ahead log stamps each group commit with it
    (:mod:`repro_torch.runtime.wal`)."""
    shard: int
    clock_vc: np.ndarray     # (n_proc,) int64
    seq: int = -1


@dataclass
class ReplicaFinMsg:
    """Unsubscribe acknowledged: nothing further on this publish channel."""
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
