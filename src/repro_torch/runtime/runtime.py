"""Real asynchronous parameter server, with its master state on the device.

Where :mod:`repro_torch.core.server` *simulates* the paper's
bounded-asynchronous semantics in a deterministic event loop, this module
*implements* them with actual concurrency, in the style of Petuum-PS:

  * N worker threads per client process share a **process cache**
    (read-my-writes: a worker's Incs are visible to its own process
    immediately);
  * **server shards** (one thread each) own hash-partitioned rows of the
    master state — row ``r`` of a key lives on the active shard
    ``active[r % A]`` of the current membership epoch — as dense float64
    tensors on the runtime's device, landed by the ``ps_apply`` kernel;
  * all edges are **FIFO per-channel queues** with sequence numbers the
    receivers assert in check mode;
  * the **Consistency Controller** (:mod:`repro_torch.core.controller`,
    shared with the simulator) gates progress: the clock bound blocks a
    worker whose period would outrun the delivery frontier
    (BSP/SSP/CAP/ESSP/CVAP), the value bound blocks an Inc that would push
    the element-wise unsynchronized accumulator past ``max(u, v_thr)``
    (VAP/CVAP), and the elastic bound blocks an Inc that would push the L2
    norm of the worker's *whole* unsynchronized sum past ``max(‖u‖₂, B)``;
  * within a period, updates are applied and sent **largest-magnitude first**
    (paper §4.2), in the order the ``topk_mag`` kernel computes; BSP/SSP
    hold them in a per-worker outbox until Clock().

Host and device: the controller, vector clocks, messages, process caches and
unsynchronized accumulators are host numpy, as in the reference (apps get
numpy views).  The device holds the shard master blocks and the kernels'
operands.  ``RuntimeConfig(device=...)`` picks it: ``"cuda"`` (default) runs
both kernels on the card, ``"cpu"`` runs their plain PyTorch versions.

Transports (``transport=``):

  * ``"queue"`` (default) — every client process is a *thread group* inside
    this Python process and channels are in-process FIFO queues;
  * ``"tcp"`` / ``"shm"`` — every client process is a **forked OS process**
    and channels run over the wire backends of
    :mod:`repro_torch.runtime.transport` (loopback sockets / shared-memory
    rings, the raw zero-copy wire unless ``zero_copy=False``), with per-row
    updates coalesced into multi-row frames.  ``"proc"`` is an alias for
    ``"shm"``.  The server shards stay in this process with their master
    blocks on the device, so every apply still goes through ``ps_apply``;
    workers escape the GIL.

Forked clients and the device: the fork happens after the master blocks are
on the card, so a child must never touch CUDA (a forked process cannot
re-initialize it).  The child's worker flow is host numpy only: it orders
each flush with ``np.argsort(-mags, kind="stable")``, the reference's own
child order, which is the ``topk_mag`` kernel's contract (its plain version
is held equal to it in the tests).  So on the wire transports ``topk_mag``
launches no time by design; on ``"queue"`` it orders every flush.  The
child enforces it: its first act is to make CUDA's lazy initialization
raise (:func:`_forbid_cuda`), so a child that touches the device fails the
run with that error, whether or not this process had initialized CUDA
before the fork.

**Elastic shard membership** (:mod:`repro_torch.runtime.membership`):
``n_slots`` shard slots (``max_shards``, default ``n_shards``) are
provisioned up front — threads and channels under every transport, so
forked clients inherit the wires — with ``n_shards`` active in epoch 0;
``add_shard()`` / ``remove_shard()`` (or a scripted ``MembershipPlan``)
re-partition **live**: an epoch barrier rides the existing FIFO channels,
the rows migrate on the device (a clone of each old block, a reassembled
master, the new blocks gathered from it), held next-epoch updates replay
through ``ps_apply``, and the clock and value bounds hold for accesses
issued *during* the migration, with a per-process zero-lost /
zero-duplicated update counter audit at the final checks.

Multi-process quiesce replaces the in-flight counter: clients send
``ProcDone`` after their last clock, shards answer ``ShardFin`` once their
delivery state has drained, and each child then ships its final cache,
stats, and update totals to the parent over a pipe, where they are merged
and checked exactly like the threaded run.  A child that fails ships its
error, and the parent's ``wait()`` raises it.

The simulator stays the executable specification: given the same
``update_fn`` both produce the same set of updates, so the quiesced runtime
state must equal the simulator's final state element-wise (updates are
additive and commutative).  The port's tests assert exactly that against
the JAX package's simulator.

Observability and durability, as in the reference:

  * ``rt.metrics()`` — one typed tree of every counter
    (:mod:`repro_torch.runtime.metrics`);
  * ``RuntimeConfig(trace=...)`` — sampled event tracing into per-thread
    rings (:mod:`repro_torch.runtime.trace`): the client-side spans
    (``outbox_flush``, ``send_part``, ``block_clock``, ``block_value``,
    ``clock``) are recorded here, the wire's in the channels, the shard's
    in the shard.  A forked client records into a hub of its own, built
    after the fork, and ships its rings with its final state; the parent
    adopts them.  ``rt.dump_trace(path)`` writes Chrome trace JSON,
    ``rt.explain_block()`` names the straggler a worker waited on,
    ``rt.explain_read(result)`` why a gateway read landed where it did and
    ``rt.staleness_timeline(shard)`` the replicas' measured lag over time;
  * the serving tier (:mod:`repro_torch.runtime.serving`) — read replicas
    subscribed to the shards' publish streams, with their value buffers on
    the runtime's device (each published delta lands through ``ps_apply``),
    behind a gateway that serves every read under a staleness SLO;
  * ``RuntimeConfig(wal_dir=...)`` — a per-shard write-ahead log
    (:mod:`repro_torch.runtime.wal`), and ``snapshot_every`` /
    ``snapshot_dir`` / ``snapshot_keep_last`` periodic snapshots of the
    masters (copied off the device), from which
    :func:`~repro_torch.runtime.snapshot.recover_to_vc` rebuilds the master
    at any vector clock, replaying the log on the card; ``restore_from``
    starts a runtime from a snapshot.  The log and the snapshots live in
    the parent, beside the shards.

``barrier_reads`` (conformance mode, requires ``threads_per_process == 1``):
peer updates stamped with the reader's current period or later are staged and
applied only at the period boundary, so reads see *exactly* the updates the
consistency model guarantees and nothing fresher.  Under BSP this makes the
runtime bit-deterministic, which is what lets differential tests compare LDA
trajectories against the simulator.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing
import os
import queue
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import canonical, state_from_reference
from repro_torch.core import controller
from repro_torch.core.server import RunStats
from repro_torch.kernels import resolve_device
from repro_torch.kernels.topk_mag import ops as topk_ops
from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime import transport as T
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.membership import (INF_CLOCK, MembershipManager,
                                            Partition)
from repro_torch.runtime.messages import (SHUTDOWN, AckBatchMsg, Channel,
                                          ClockMarker, ClockMsg, DeliverMsg,
                                          EpochAckMsg, EpochMsg,
                                          FullyDelivered, ProcDoneMsg,
                                          ShardFinMsg, UpdateMsg,
                                          group_by_channel, pump_inbox)
from repro_torch.runtime.metrics import (LOAD_BLOCK_CLOCK, LOAD_BLOCK_VALUE,
                                         LOAD_LEN, LOAD_UPDATES, MetricsHub,
                                         RuntimeMetrics)
from repro_torch.runtime.shard import ServerShard
from repro_torch.runtime.snapshot import (restore_into, save_snapshot,
                                          snapshot_files, snapshot_name,
                                          take_snapshot)
from repro_torch.runtime.wal import WalWriter, prune_segments

_PROC_ALIAS = "shm"          # what transport="proc" resolves to


def _ack_batches(pairs: List[Tuple[Channel, int]], pid: int
                 ) -> List[Tuple[Channel, AckBatchMsg]]:
    """[(shard chan, uid), ...] -> one coalesced :class:`AckBatchMsg` per
    channel (VAP ack batching: a flush's acks share a single message)."""
    return [(chan, AckBatchMsg(np.asarray(uids, dtype=np.int64), pid))
            for chan, uids in group_by_channel(pairs)]


def _unsynced_norm(unsynced: Dict[str, np.ndarray]) -> float:
    """L2 norm of one worker's whole unsynchronized accumulator set."""
    sq = sum(float(np.sum(v * v)) for v in unsynced.values())
    return math.sqrt(max(sq, 0.0))


def _elastic_norms(unsynced: Dict[str, np.ndarray], key: str,
                   d2: np.ndarray) -> Tuple[float, float]:
    """(‖unsynced‖₂ before, ‖unsynced‖₂ after applying d2 to key)."""
    sq = sum(float(np.sum(v * v)) for v in unsynced.values())
    cur = unsynced[key]
    new = cur + d2
    new_sq = sq - float(np.sum(cur * cur)) + float(np.sum(new * new))
    return math.sqrt(max(sq, 0.0)), math.sqrt(max(new_sq, 0.0))


class ClientProcess:
    """A client process: shared cache + comm thread for its worker threads.

    All of it is host numpy state: the cache the apps read and the
    per-worker unsynchronized accumulators.  Identical in both regimes —
    under ``transport="queue"`` it lives in the main interpreter; under a
    wire transport it lives in a forked child and ``rt`` is the child's
    :class:`_ClientHost`.
    """

    def __init__(self, rt, pid: int):
        self.rt = rt
        self.pid = pid
        self.cond = threading.Condition()     # guards every field below
        self.cache: Dict[str, np.ndarray] = {k: v.copy()
                                             for k, v in rt._x0.items()}
        self.workers = list(range(pid * rt.tpp, (pid + 1) * rt.tpp))
        # per-worker element-wise unsynchronized accumulators
        self.unsynced: Dict[int, Dict[str, np.ndarray]] = {
            w: {k: np.zeros_like(v) for k, v in rt._x0.items()}
            for w in self.workers}
        self.thread_clock: Dict[int, int] = {w: 0 for w in self.workers}
        self.sent_clock = 0                   # completed periods announced
        # elastic membership: this process's routing epoch.  route_lock
        # excludes worker flushes during the barrier swap, making the
        # EpochAck that follows FIFO-after every old-epoch frame.
        self.part: Partition = rt.partition
        self.route_lock = threading.Lock()
        self._pending_epoch: Optional[EpochMsg] = None
        # marks[p, s]: highest period of process p fully forwarded by shard
        # slot s.  Inactive slots sit at INF (they constrain nothing); a
        # slot (re)activated at epoch e resets to -1 until its seeded
        # markers land; a retiring slot is lifted to INF by the marker it
        # sends FIFO-behind its last delivery.
        self.marks = np.full((rt.n_proc, rt.n_slots), INF_CLOCK,
                             dtype=np.int64)
        self.marks[:, list(self.part.active)] = -1
        # epoch at which each slot was last activated: stale markers from a
        # slot's previous activation are filtered by this
        self.act_epoch = np.zeros(rt.n_slots, dtype=np.int64)
        self.staged: List[DeliverMsg] = []    # barrier_reads holding pen
        # load counters (repro_torch.runtime.metrics): bumped under locks the
        # hot paths already hold, snapshotted at clock boundaries and
        # piggybacked on the outgoing ClockMsg
        self.m_updates = 0
        self.m_block_clock = 0.0
        self.m_block_value = 0.0
        self.inbox: queue.Queue = queue.Queue()
        self._fifo = T.FifoAssert()           # per sender shard
        self._acks: List[Tuple[Channel, int]] = []      # (shard chan, uid)
        self.thread = threading.Thread(
            target=self._loop, name=f"ps-proc-{pid}", daemon=True)

    # ---------------------------------------------------------------- frontier
    def frontier_min(self) -> int:
        """Lowest period every peer process is known-delivered through."""
        peers = [p for p in range(self.rt.n_proc) if p != self.pid]
        if not peers:
            return 1 << 60
        return int(self.marks[peers, :].min())

    def cur_period(self) -> int:
        return min(self.thread_clock.values())

    # ---------------------------------------------------------------- comm
    def _loop(self) -> None:
        pump_inbox(self.inbox, self._handle_batch)

    def _handle_batch(self, batch: list) -> bool:
        rt = self.rt
        shutdown = False
        done = 0
        with self.cond:
            for msg in batch:
                if msg is SHUTDOWN:
                    shutdown = True
                    break
                done += 1
                try:
                    self._handle(msg)
                except BaseException as e:
                    rt._record_error(e)
            self.cond.notify_all()
        # zero-copy discipline: every view-backed delivery was either
        # applied above or materialized into `staged`, so drop the frame
        # pins NOW — before the blocking ack sends below.  Holding pins
        # across a wire write could deadlock two full rings against each
        # other (the shard may be blocked writing into our ring, waiting
        # for exactly this release to free its own inbound ring).
        T.release_msgs(batch)
        # the epoch swap runs outside self.cond (it takes route_lock, and
        # cond must never be held while waiting on it) but still on the
        # comm thread, so it can never deadlock against a gated worker
        pend, self._pending_epoch = self._pending_epoch, None
        if pend is not None:
            self._adopt_epoch(pend)
        # acks leave after the lock is dropped, coalesced into ONE AckBatch
        # message per (client, shard, flush)
        acks, self._acks = self._acks, []
        for chan, batch in _ack_batches(acks, self.pid):
            rt._send(chan, batch)
        # in-flight decrements strictly after the acks were enqueued, so the
        # quiesce wait never observes a transient 0 mid-conversation
        for _ in range(done):
            rt._msg_done()
        return shutdown

    def _handle(self, msg) -> None:
        """Process one message.  Caller holds ``self.cond``."""
        rt = self.rt
        if rt.check:
            err = self._fifo.check(msg.shard, msg.seq)
            if err:
                rt._violation(f"FIFO violation: shard {msg.shard}->proc "
                              f"{self.pid} {err}")
        if isinstance(msg, DeliverMsg):
            if rt.barrier_reads and msg.ts >= self.cur_period():
                # retained past this apply cycle: copy out of the ring
                self.staged.append(T.materialize_msg(msg))
            else:
                self._apply_delivery(msg)
                # acks only feed the unsynced accounting (VAP value bound /
                # elastic norm bound); clock-only policies skip the cycle
                if rt.policy.tracks_sync:
                    self._acks.append(
                        (rt._chan_ps[self.pid][msg.shard], msg.uid))
        elif isinstance(msg, ClockMarker):
            # max(): the frontier may never regress (channel FIFO already
            # orders markers per (proc, shard); this makes it local).  A
            # marker stamped before the slot's latest activation is stale —
            # it predates the re-partition and must not lift the reset mark.
            if msg.epoch >= self.act_epoch[msg.shard]:
                self.marks[msg.process, msg.shard] = max(
                    self.marks[msg.process, msg.shard], msg.clock)
        elif isinstance(msg, EpochMsg):
            self._pending_epoch = msg         # adopted after this batch
        elif isinstance(msg, FullyDelivered):
            # exact subtraction, mirroring the simulator's VAP accounting:
            # the accumulator received exactly msg.delta when the update
            # applied, so subtracting it back is exact.  The value/strong
            # gates carry their own > 1e-12 dead zone, so float residue from
            # *other* orderings never wedges a worker.
            acc = self.unsynced[msg.worker][msg.key]
            acc[msg.rows] -= msg.delta
        elif isinstance(msg, ShardFinMsg):
            rt._on_shard_fin(msg)
        else:
            raise TypeError(f"proc {self.pid}: unexpected message {msg!r}")

    def _apply_delivery(self, msg: DeliverMsg) -> None:
        self.cache[msg.key][msg.rows] += msg.delta

    def release_staged(self, new_period: int
                       ) -> List[Tuple[Channel, AckBatchMsg]]:
        """Apply staged deliveries now inside the staleness window.

        Caller holds ``self.cond`` (the ticking worker, at a period
        boundary).  Returns coalesced ack batches (one per shard channel)
        to send after the lock is dropped.
        """
        acks, keep = [], []
        for msg in self.staged:
            if msg.ts < new_period:
                self._apply_delivery(msg)
                if self.rt.policy.tracks_sync:
                    acks.append((self.rt._chan_ps[self.pid][msg.shard],
                                 msg.uid))
            else:
                keep.append(msg)
        self.staged = keep
        return _ack_batches(acks, self.pid)

    # ------------------------------------------------------------ membership
    def _adopt_epoch(self, msg: EpochMsg) -> None:
        """Swap the key->shard router at the epoch barrier.

        Runs on the comm thread, outside ``self.cond``.  ``route_lock``
        excludes in-flight worker flushes, so after the swap no old-epoch
        frame can be emitted — which makes the EpochAckMsg sent below a
        true barrier on every channel (FIFO-after the last old-epoch
        Update/Clock).  New-epoch frames may precede the ack; receivers
        hold them by their epoch stamp, not by ack order.
        """
        rt = self.rt
        with self.route_lock:
            old = self.part
            if msg.epoch <= old.epoch:
                return                        # duplicate announce
            new_part = Partition(msg.epoch, msg.active, rt._row_counts)
            with self.cond:
                for sid in new_part.active:
                    if not old.owns(sid):     # (re)activated slot: it now
                        self.marks[:, sid] = -1   # constrains the frontier
                        self.act_epoch[sid] = msg.epoch
            self.part = new_part
        for sid in sorted(set(old.active) | set(new_part.active)):
            rt._send(rt._chan_ps[self.pid][sid],
                     EpochAckMsg(self.pid, msg.epoch))


class RuntimeViewHandle:
    """Read API handed to update_fn — mirrors the simulator's ViewHandle."""

    def __init__(self, rt, proc: ClientProcess, worker: int):
        self._rt = rt
        self._proc = proc
        self.worker = worker
        self.gets = 0

    def get(self, key: str) -> np.ndarray:
        self.gets += 1
        with self._proc.cond:
            flat = self._proc.cache[key].copy()
        return flat.reshape(self._rt._shapes[key])

    def keys(self) -> Sequence[str]:
        return list(self._rt._x0.keys())


class _WorkerFlowMixin:
    """The client-side worker flow, shared by the in-process runtime
    (:class:`PSRuntime`, transport="queue") and the forked per-process host
    (:class:`_ClientHost`, wire transports).  Subclasses provide the state
    surface:
    ``procs``, ``policy``, ``stats``, ``_slock``, ``_total``, ``_chan_ps``,
    ``_send``/``_send_many``/``_msg_done``, ``_next_uid``, ``_check_alive``,
    ``_violation``, ``_record_error``, ``_note_global_clock``, ``device``,
    ``trace_on``/``_trace`` and the sizing/config attributes.
    """

    # ------------------------------------------------------------ worker flow
    def _worker_loop(self, w: int) -> None:
        proc = self.procs[self.proc_of(w)]
        rng = np.random.default_rng(self.seed * 7919 + w)
        try:
            for clock in range(self.n_clocks):
                self._clock_gate(w, clock, proc)
                view = RuntimeViewHandle(self, proc, w)
                upd = self.update_fn(w, clock, view, rng)
                items = [(k, np.asarray(d, dtype=np.float64))
                         for k, d in upd.items()]
                if self.prioritize and len(items) > 1:
                    # one magnitude pass per flush, then a stable descending
                    # order (identical to the reference's per-item sort,
                    # including ties)
                    mags = np.fromiter(
                        (np.abs(d).max() if d.size else 0.0
                         for _, d in items),
                        dtype=np.float64, count=len(items))
                    items = [items[int(i)]
                             for i in self._magnitude_order(mags)]
                outbox: List[Tuple[str, np.ndarray]] = []
                for key, delta in items:
                    d2 = self._apply_update(w, clock, proc, key, delta)
                    if self.policy.norm_bounded:
                        # elastic gates on the WHOLE accumulator: a delta
                        # parked in a per-period outbox could never be
                        # acknowledged and would wedge the gate on the next
                        # key.  Send per Inc, like the simulator does.
                        self._flush_outbox(w, clock, proc, [(key, d2)])
                    else:
                        outbox.append((key, d2))
                if not self.policy.push_at_clock_only:
                    # async policies push without waiting for Clock(): one
                    # coalesced multi-row batch per shard channel per period
                    self._flush_outbox(w, clock, proc, outbox)
                    outbox = []
                self._on_clock(w, clock, proc, outbox)
        except BaseException as e:
            self._record_error(e)

    def _magnitude_order(self, mags: np.ndarray) -> np.ndarray:
        """Largest-|Δ|-first send order (paper §4.2), stable on ties: the
        ``topk_mag`` kernel on the card, its plain version on the CPU (a
        forked client overrides this with host numpy)."""
        order = topk_ops.magnitude_order(torch.from_numpy(mags).to(self.device))
        return order.cpu().numpy()

    def _flush_outbox(self, w: int, clock: int, proc: ClientProcess,
                      outbox: List[Tuple[str, np.ndarray]]) -> None:
        """Split each update by the process's *current* partition and
        send, one batch per shard channel, FIFO preserved.

        Routing is deferred from Inc time to flush time on purpose: an SSP
        outbox filled under epoch e but flushed after the comm thread's
        barrier swap must route by e+1, or the old owner would receive an
        update after its EpochAck cut and lose it in the handoff.  The
        route_lock critical section is pure split+enqueue — it never waits
        on a consistency gate, so the swap can always get in promptly.
        """
        if not outbox:
            return
        trc = self._trace if self.trace_on else None
        t0_ns = time.monotonic_ns() if trc is not None else 0
        pairs: List[Tuple[Channel, UpdateMsg]] = []
        with proc.route_lock:
            part = proc.part
            for key, d2 in outbox:
                for sid in part.active:
                    rows = part.rows_of(key, sid)
                    if rows.size == 0:
                        continue
                    sub = d2[rows]
                    nz = np.any(sub != 0.0, axis=1)
                    if not nz.all():                 # elide all-zero rows
                        rows, sub = rows[nz], sub[nz]
                        if rows.size == 0:
                            continue
                    msg = UpdateMsg(self._next_uid(), w, proc.pid, clock,
                                    key, rows, sub, part.epoch)
                    pairs.append((self._chan_ps[proc.pid][sid], msg))
                    if trc is not None and trc.sampled(msg.uid):
                        # lifeline start: joined to the shard's apply_part
                        # on (proc, uid), which the wire already carries
                        trc.point(trace_mod.EV_SEND, proc.pid, msg.uid, key)
            for chan, msgs in group_by_channel(pairs):
                self._send_many(chan, msgs)
        if pairs:
            with self._slock:
                self._parts_sent[proc.pid] += len(pairs)
            if trc is not None:
                trc.span(trace_mod.EV_FLUSH, t0_ns, proc.pid, clock,
                         len(pairs))

    def _clock_gate(self, w: int, clock: int, proc: ClientProcess) -> None:
        """Block until the delivery frontier admits this period (clock bound)."""
        if self.n_proc == 1 or not self.policy.clock_bounded:
            return
        need = clock - self.policy.staleness - 1
        if need < 0:
            return
        t0 = time.monotonic()
        blocked = False
        strag = -1
        with proc.cond:
            while proc.frontier_min() < need:
                blocked = True
                if self.trace_on:
                    # who is holding the frontier right now?  the peer whose
                    # slowest shard mark is lowest (recomputed each wait lap,
                    # so the span blames the last straggler observed)
                    peers = [p for p in range(self.n_proc) if p != proc.pid]
                    strag = peers[int(proc.marks[peers, :]
                                      .min(axis=1).argmin())]
                self._check_alive()
                proc.cond.wait(0.25)
            if self.check:
                st = clock - proc.frontier_min() - 1
                with self._slock:
                    self.stats.max_observed_staleness = max(
                        self.stats.max_observed_staleness, st)
                    if st > self.policy.staleness:
                        self.stats.violations.append(
                            f"staleness violation: worker {w} clock {clock} "
                            f"observed {st}")
        if blocked:
            dt = time.monotonic() - t0
            with self._slock:
                self.stats.block_time_clock += dt
                proc.m_block_clock += dt
            if self.trace_on:
                self._trace.span(trace_mod.EV_BLOCK_CLOCK, int(t0 * 1e9),
                                 proc.pid, w, strag)

    def _apply_update(self, w: int, clock: int, proc: ClientProcess,
                      key: str, delta: np.ndarray) -> np.ndarray:
        """Value-gate and apply to the process cache; returns the canonical
        (R, C) delta for the flush-time shard split."""
        d2 = (delta.reshape(delta.shape[0], -1) if delta.ndim > 1
              else delta.reshape(-1, 1))
        t0 = time.monotonic()
        blocked = False
        with proc.cond:
            while True:
                ok, _ = controller.value_gate(
                    self.policy, proc.unsynced[w][key], d2)
                if ok and self.policy.norm_bounded:
                    # elastic: one bound on the whole accumulator's L2 norm,
                    # re-evaluated as FullyDelivered echoes shrink it
                    acc_n, new_n = _elastic_norms(proc.unsynced[w], key, d2)
                    ok = controller.elastic_gate(self.policy, acc_n, new_n)
                if ok:
                    break
                blocked = True
                self._check_alive()
                proc.cond.wait(0.25)
            proc.cache[key] += d2                       # read-my-writes
            acc = proc.unsynced[w][key]
            acc += d2
            mag = float(np.max(np.abs(d2))) if d2.size else 0.0
            proc.m_updates += 1                         # (under proc.cond)
            with self._slock:
                self.stats.n_updates += 1
                self.stats.max_update_mag = max(self.stats.max_update_mag, mag)
                self._total[key] += d2
                if blocked:
                    dt = time.monotonic() - t0
                    self.stats.block_time_value += dt
                    proc.m_block_value += dt
                if self.check and self.policy.value_bounded:
                    bound = controller.vap_unsynced_bound(
                        self.policy, self.stats.max_update_mag)
                    mx = float(np.max(np.abs(acc)))
                    self.stats.max_unsynced_mag = max(
                        self.stats.max_unsynced_mag, mx)
                    if mx > bound + 1e-9:
                        self.stats.violations.append(
                            f"VAP violation: worker {w} unsynced {mx} > {bound}")
                if self.policy.norm_bounded:
                    dn = float(np.linalg.norm(d2)) if d2.size else 0.0
                    self.stats.max_update_norm = max(
                        self.stats.max_update_norm, dn)
                    if self.check:
                        un = _unsynced_norm(proc.unsynced[w])
                        self.stats.max_unsynced_norm = max(
                            self.stats.max_unsynced_norm, un)
                        nb = controller.elastic_unsynced_bound(
                            self.policy, self.stats.max_update_norm)
                        if un > nb + 1e-9:
                            self.stats.violations.append(
                                f"elastic violation: worker {w} unsynced "
                                f"norm {un} > {nb}")
        if blocked and self.trace_on:
            self._trace.span(trace_mod.EV_BLOCK_VALUE, int(t0 * 1e9),
                             proc.pid, w, clock)
        return d2

    def _on_clock(self, w: int, clock: int, proc: ClientProcess,
                  outbox: List[Tuple[str, np.ndarray]]) -> None:
        """Clock(): flush the SSP outbox, tick, maybe advance the process."""
        # held updates must hit the channels *before* the tick (matching the
        # sim): a sibling worker's tick may advance the process clock, and
        # its ClockMsg for this period must be FIFO-after these updates —
        # the shard's marker echo relies on exactly that channel order
        self._flush_outbox(w, clock, proc, outbox)
        advanced: List[int] = []
        staged_acks: List[Tuple[Channel, AckBatchMsg]] = []
        with proc.cond:
            proc.thread_clock[w] += 1
            new_min = proc.cur_period()     # process clock = min of threads
            while proc.sent_clock < new_min:
                advanced.append(proc.sent_clock)
                proc.sent_clock += 1
            if advanced and self.barrier_reads:
                staged_acks = proc.release_staged(new_min)
            proc.cond.notify_all()
        if advanced:
            # metrics piggyback: snapshot this process's load counters at
            # the boundary and ride them on the ClockMsg it already sends.
            # Racy counter reads only wobble a rate estimate.
            load = None
            if self.metrics_on:
                load = np.zeros(LOAD_LEN, dtype=np.float64)
                load[LOAD_UPDATES] = proc.m_updates
                load[LOAD_BLOCK_CLOCK] = proc.m_block_clock
                load[LOAD_BLOCK_VALUE] = proc.m_block_value
            if self.trace_on:
                for c in advanced:
                    self._trace.point(trace_mod.EV_CLOCK, proc.pid, c)
            # ClockMsg routes by the current partition too; if the epoch
            # swapped between the update flush above and here, the old
            # owner's missing clock only *under*-states its applied vc
            # (conservative), and the new owner holds the early clock by
            # its epoch stamp until install
            with proc.route_lock:
                part = proc.part
                pairs = [(self._chan_ps[proc.pid][sid],
                          ClockMsg(proc.pid, c, part.epoch, load))
                         for c in advanced for sid in part.active]
                for chan, msgs in group_by_channel(pairs):
                    self._send_many(chan, msgs)
        for chan, msg in staged_acks:
            self._send(chan, msg)
        if advanced:
            self._note_global_clock()


class PSRuntime(_WorkerFlowMixin):
    """The concurrent asynchronous parameter server.

    Counterpart of :class:`repro_torch.core.server.AsyncPS` — same
    ``update_fn(worker, clock, view, rng)`` contract, same per-worker rng
    seeding, same :class:`RunStats` — but wall-clock concurrent instead of
    simulated.  ``NetworkModel`` / ``compute_time`` / ``straggler`` have no
    analogue here: latency and skew are real.

    ``transport="queue"`` runs worker *threads* in this process;
    ``"tcp"``/``"shm"``/``"proc"`` fork one OS process per client process
    and carry the same message protocol over the wire (module docstring).

    Built from a :class:`~repro_torch.runtime.config.RuntimeConfig`; the
    shards' master blocks live on ``config.device``.
    """

    def __init__(self, config: RuntimeConfig):
        if not isinstance(config, RuntimeConfig):
            raise TypeError("PSRuntime(config) takes a "
                            "repro_torch.runtime.RuntimeConfig")
        cfg = config
        self.config = cfg
        self.device = resolve_device(cfg.device)
        self.transport_kind = (_PROC_ALIAS if cfg.transport == "proc"
                               else cfg.transport)
        self._proc_mode = self.transport_kind != "queue"
        # zero_copy: raw RowCodec frames + in-ring view decode on the shm
        # transport (None -> on; other transports ignore it)
        self.zero_copy = True if cfg.zero_copy is None else bool(cfg.zero_copy)
        self.P = cfg.n_workers
        self.tpp = cfg.threads_per_process
        self.n_proc = cfg.n_workers // cfg.threads_per_process
        self.n_shards = cfg.n_shards          # initial active count
        # elastic membership: n_slots shard slots are provisioned (threads +
        # channels for every transport, so forked clients inherit the wires)
        # but only n_shards are active in epoch 0; add_shard()/remove_shard()
        # re-partition live (repro_torch.runtime.membership)
        self.n_slots = (cfg.n_shards if cfg.max_shards is None
                        else int(cfg.max_shards))
        self.policy = cfg.policy
        self.seed = cfg.seed
        self.prioritize = cfg.prioritize_by_magnitude
        self.check = cfg.check_invariants
        self.barrier_reads = cfg.barrier_reads
        self.metrics_on = bool(cfg.metrics)
        # tracing tier: one hub for the parent (shards, readers, queue-mode
        # workers); forked clients build their own after the fork and ship
        # their rings back with their final state
        self._trace_cfg = trace_mod.normalize_trace(cfg.trace)
        self.trace_on = self._trace_cfg is not None
        self._trace = (trace_mod.TraceHub(self._trace_cfg, "server")
                       if self.trace_on else None)

        # canonical (R, C) float64 state: on the device for the shards, on
        # the host for the process caches; original shapes for reads
        x0_dev = state_from_reference(cfg.init_params, self.device)
        self._shapes: Dict[str, Tuple[int, ...]] = {
            k: np.shape(v) for k, v in cfg.init_params.items()}
        self._x0: Dict[str, np.ndarray] = {
            k: canonical(v).copy() for k, v in cfg.init_params.items()}
        self._row_counts = {k: v.shape[0] for k, v in self._x0.items()}
        self.partition = Partition(0, tuple(range(cfg.n_shards)),
                                   self._row_counts)
        # upper bound on one shard's in-stream bootstrap frame (publish
        # backpressure: a resync is tried only when the sink has this room)
        self._state_frame_bytes = sum(
            v.nbytes + 8 * v.shape[0] for v in self._x0.values()) + 4096

        self.stats = RunStats()
        self._slock = threading.Lock()
        self._total = {k: np.zeros_like(v) for k, v in self._x0.items()}
        # zero-lost/zero-duplicated audit: update parts sent, per process
        # (matched against the shards' applied_parts at the final checks)
        self._parts_sent = np.zeros(self.n_proc, dtype=np.int64)
        self._uid = itertools.count()
        self._done_clock = 0
        self._t0 = 0.0
        self._deadline = float("inf")
        self._errors: List[BaseException] = []
        self._qcond = threading.Condition()   # guards _inflight
        self._inflight = 0

        # mid-run periodic snapshots: taken by the shard thread that moves
        # the applied frontier across a multiple of `snapshot_every` clocks
        self.snapshot_every = cfg.snapshot_every
        self.snapshot_dir = cfg.snapshot_dir
        self.snapshot_keep_last = cfg.snapshot_keep_last
        self.snapshots: List[Tuple[int, dict]] = []
        self._snap_lock = threading.Lock()
        self._next_snap_clock = (cfg.snapshot_every if cfg.snapshot_every
                                 else (1 << 62))
        # durability tier: per-shard write-ahead delta log, group-committed
        # at clock boundaries by the shard threads, in the raw wire codec
        # over the same key order the shm wire uses
        self.wal_dir = cfg.wal_dir
        self.wal_fsync = cfg.wal_fsync or "none"
        self.wal_segment_bytes = cfg.wal_segment_bytes
        # per-slot log positions at each membership epoch cut
        self._wal_epoch_marks: List[Tuple[int, dict]] = []
        if cfg.wal_dir:
            os.makedirs(cfg.wal_dir, exist_ok=True)
            self._wal_codec = T.RowCodec(list(self._x0.keys()))
        else:
            self._wal_codec = None

        self.shards = [ServerShard(self, s, x0_dev)
                       for s in range(self.n_slots)]
        del x0_dev                            # the shards hold their blocks
        self.membership = MembershipManager(self)
        self._membership_plan = cfg.membership_plan
        # serving-tier objects register here for rt.metrics()
        self._gateways: List[object] = []
        self._replica_sets: List[object] = []
        self._metrics_hub = MetricsHub(self)
        if cfg.restore_from is not None:
            restore_into(self, cfg.restore_from)
        if self._proc_mode:
            self.procs: List[ClientProcess] = []
            self._chan_ps = None              # lives in the children
            self._chan_sp: List[List] = []    # wire channels, built in start()
            self._children: List[multiprocessing.Process] = []
            self._pipes: List[int] = []       # read ends, one per client
            self._readers: List[threading.Thread] = []
            self._transport = None
            self._conns: Dict[Tuple[int, int], T.TcpConn] = {}
            self._reader_stop = threading.Event()
            self._final_caches: Dict[int, Dict[str, np.ndarray]] = {}
        else:
            self.procs = [ClientProcess(self, p) for p in range(self.n_proc)]
            # FIFO channels: client process -> shard slot, and back
            self._chan_ps = [[Channel(f"p{p}->s{s}", self.shards[s].inbox)
                              for s in range(self.n_slots)]
                             for p in range(self.n_proc)]
            self._chan_sp = [[Channel(f"s{s}->p{p}", self.procs[p].inbox)
                              for p in range(self.n_proc)]
                             for s in range(self.n_slots)]

        self.update_fn: Callable = None
        self.n_clocks = 0
        self._workers: List[threading.Thread] = []
        self._started = False
        self._finished = False

    # ------------------------------------------------------------- plumbing
    def proc_of(self, worker: int) -> int:
        return worker // self.tpp

    def _make_wal(self, sid: int):
        """Per-shard :class:`~repro_torch.runtime.wal.WalWriter`, or None
        when the durability tier is off (called once per slot by
        ServerShard)."""
        if not self.wal_dir:
            return None
        return WalWriter(self.wal_dir, sid, self._wal_codec, self.n_proc,
                         fsync=self.wal_fsync,
                         segment_bytes=self.wal_segment_bytes)

    def _close_wals(self) -> None:
        """Seal every shard's WAL at clean teardown (shard threads are
        joined, so the final vc and state are quiescent).  A crash path
        never gets here by design: it leaves an unsealed or torn tail,
        which :func:`repro_torch.runtime.wal.read_segment` recovers to the
        last complete record."""
        for s in self.shards:
            if s.wal is not None:
                s.wal.seal(s.clock_vc)

    def _wal_on_epoch(self, epoch: int, added, removed) -> None:
        """Membership hook: record each epoch cut's per-slot log positions
        (the kill-epoch bookmark point-in-time tooling starts from).  The
        sealing itself happens shard-side in ``_maybe_cut`` — a retiring
        slot seals its segment at the cut, stamped with its final vc."""
        if not self.wal_dir:
            return
        marks = {s.sid: s.wal.marks() for s in self.shards
                 if s.wal is not None}
        self._wal_epoch_marks.append((epoch, marks))

    def _next_uid(self) -> int:
        return next(self._uid)

    def _send(self, chan, msg) -> None:
        if not self._proc_mode:
            with self._qcond:
                self._inflight += 1
        chan.send(msg)

    def _send_many(self, chan, msgs: list) -> None:
        if not msgs:
            return
        if not self._proc_mode:
            with self._qcond:
                self._inflight += len(msgs)
        chan.send_many(msgs)

    def _msg_done(self) -> None:
        if self._proc_mode:
            return
        with self._qcond:
            self._inflight -= 1
            if self._inflight == 0:
                self._qcond.notify_all()

    def _violation(self, text: str) -> None:
        with self._slock:
            self.stats.violations.append(text)

    def _record_error(self, e: BaseException) -> None:
        with self._slock:
            self._errors.append(e)

    def _check_alive(self) -> None:
        if time.monotonic() > self._deadline:
            raise RuntimeError(
                "runtime deadlock: wall-clock deadline exceeded "
                f"(inflight={self._inflight})")
        if self._errors:
            raise RuntimeError("runtime aborted: peer thread failed")

    # ---------------------------------------------------------------- running
    def start(self, update_fn: Callable, n_clocks: int,
              timeout: float = 120.0) -> None:
        """Launch shard/comm/worker threads (and, under a wire transport,
        the client OS processes); pair with :meth:`wait`."""
        if self._started:
            raise RuntimeError("runtime already started")
        self._started = True
        self.update_fn = update_fn
        self.n_clocks = n_clocks
        self._deadline = time.monotonic() + timeout
        self._t0 = time.monotonic()
        if self._proc_mode:
            self._start_proc()
        else:
            for s in self.shards:
                s.thread.start()
            for p in self.procs:
                p.thread.start()
            self._workers = [
                threading.Thread(target=self._worker_loop, args=(w,),
                                 name=f"ps-worker-{w}", daemon=True)
                for w in range(self.P)]
            for t in self._workers:
                t.start()
        if self._membership_plan is not None:
            self.membership.start_plan(self._membership_plan)

    # ------------------------------------------------------- proc-mode start
    def _start_proc(self) -> None:
        """Build the wires, fork one client per process, then start the
        parent's reader and shard threads.  The fork comes first: no thread
        of this runtime is running while it forks."""
        ctx = multiprocessing.get_context("fork")
        if self.transport_kind == "tcp":
            self._transport = T.TcpTransport(self.n_proc, self.n_slots)
            self._transport.listen()
        else:
            # ring must hold the largest possible single row part (a whole
            # key) with frame overhead; batches above half the ring split
            # into multiple frames (WireChannel max_frame)
            max_part = max(v.nbytes + 8 * v.shape[0] + 4096
                           for v in self._x0.values())
            cap = max(1 << 20, 8 * max_part)
            self._shm_max_frame = cap // 2
            self._transport = T.ShmTransport(self.n_proc, self.n_slots,
                                             capacity=cap)
        for pid in range(self.n_proc):
            recv, send = os.pipe()
            child = ctx.Process(target=_client_child_main,
                                args=(self, pid, send),
                                name=f"ps-client-{pid}", daemon=True)
            child.start()
            os.close(send)                     # parent keeps the read end
            self._children.append(child)
            self._pipes.append(recv)

        # parent side: route each client->shard stream into the shard inbox,
        # hand each shard slot a write channel back to every client
        self._chan_sp = [[None] * self.n_proc for _ in range(self.n_slots)]
        trc = self._trace
        if self.transport_kind == "tcp":
            self._conns = self._transport.accept_all(self._deadline)
            for (p, s), conn in self._conns.items():
                self._chan_sp[s][p] = T.WireChannel(f"s{s}->p{p}", conn.write,
                                                    trace=trc)
                self._readers.append(T.start_reader(
                    f"rx-p{p}s{s}", conn.read_chunk, self.shards[s].inbox,
                    self._record_error, trace=trc))
        else:
            codec = (T.RowCodec(list(self._x0.keys())) if self.zero_copy
                     else None)
            for (p, s), edge in self._transport.edges.items():
                if codec is not None:
                    # zero-copy wire: raw row-block frames, doorbell batched
                    # to one wake per flush (per frame only when a batch
                    # splits), and an in-ring view reader on the receive side
                    bell_w = edge.s2c_bell[1]
                    self._chan_sp[s][p] = T.WireChannel(
                        f"s{s}->p{p}",
                        T.ring_parts_writer(edge.s2c, self._deadline),
                        max_frame=self._shm_max_frame, codec=codec,
                        on_flush=lambda w=bell_w: T.ShmEdge.ring_bell(w),
                        trace=trc)
                    self._readers.append(T.start_view_reader(
                        f"rx-p{p}s{s}",
                        T.RingViewReader(edge.c2s, codec, edge.c2s_bell[0],
                                         self._reader_stop, trace=trc),
                        self.shards[s].inbox, self._record_error))
                else:
                    self._chan_sp[s][p] = T.WireChannel(
                        f"s{s}->p{p}",
                        T.ring_writer(edge.s2c, edge.s2c_bell[1],
                                      self._deadline),
                        max_frame=self._shm_max_frame, trace=trc)
                    self._readers.append(T.start_reader(
                        f"rx-p{p}s{s}",
                        T.ring_reader(edge.c2s, edge.c2s_bell[0],
                                      self._reader_stop),
                        self.shards[s].inbox, self._record_error, trace=trc))
        for s in self.shards:
            s.thread.start()

    def wait(self) -> RunStats:
        """Join workers, quiesce all in-flight messages, run final checks."""
        if not self._started or self._finished:
            raise RuntimeError("runtime not running")
        if self._proc_mode:
            return self._wait_proc()
        for t in self._workers:
            while t.is_alive():
                t.join(timeout=0.5)
                if time.monotonic() > self._deadline:
                    self._record_error(RuntimeError(
                        f"worker {t.name} still alive at deadline"))
                    break
        # a scripted membership op may still be installing: let it finish
        # before draining (its messages are in-flight-counted like any other)
        self.membership.finish_plan(self._deadline - time.monotonic())
        if not self._errors:
            with self._qcond:
                while self._inflight > 0:
                    if time.monotonic() > self._deadline:
                        self._record_error(RuntimeError(
                            f"quiesce timed out ({self._inflight} in flight)"))
                        break
                    self._qcond.wait(0.25)
        self._finished = True
        for p in self.procs:
            p.inbox.put(SHUTDOWN)
        for s in self.shards:
            s.inbox.put(SHUTDOWN)
        for th in [p.thread for p in self.procs] + [s.thread for s in self.shards]:
            th.join(timeout=5.0)
        self._close_wals()
        self.stats.sim_time = time.monotonic() - self._t0
        if self._errors:
            raise RuntimeError(
                f"runtime failed: {self._errors[0]!r}") from self._errors[0]
        if self.check:
            self._final_checks()
        return self.stats

    # -------------------------------------------------------- proc-mode wait
    def _wait_proc(self) -> RunStats:
        finals: Dict[int, dict] = {}
        try:
            for pid, pipe in enumerate(self._pipes):
                budget = max(0.1, self._deadline - time.monotonic())
                fin = T.recv_state(pipe, time.monotonic() + budget)
                if fin is not None:
                    finals[pid] = fin
            for child in self._children:
                child.join(timeout=max(0.1, self._deadline - time.monotonic()))
                if child.is_alive():
                    child.terminate()
                    child.join(timeout=5.0)
                    self._record_error(RuntimeError(
                        f"client process {child.name} killed at deadline"))
            self.membership.finish_plan(self._deadline - time.monotonic())
            for pid, child in enumerate(self._children):
                if pid not in finals:
                    # exitcode read after the join above, so the diagnostic
                    # reflects how the child actually ended
                    self._record_error(RuntimeError(
                        f"client process {pid} sent no final state "
                        f"(exitcode={child.exitcode})"))
            # children exited => their EOF frames are on the wire; readers
            # drain them into the shard inboxes and stop
            for r in self._readers:
                r.join(timeout=max(0.1, self._deadline - time.monotonic()) + 5)
            for s in self.shards:
                s.inbox.put(SHUTDOWN)
            for s in self.shards:
                s.thread.join(timeout=5.0)
            self._close_wals()
        finally:
            self._finished = True
            self._cleanup_transport()
        self._merge_finals(finals)
        self.stats.sim_time = time.monotonic() - self._t0
        if self._errors:
            raise RuntimeError(
                f"runtime failed: {self._errors[0]!r}") from self._errors[0]
        if self.check:
            self._final_checks()
        return self.stats

    def _cleanup_transport(self) -> None:
        for fd in self._pipes:
            os.close(fd)
        self._pipes = []
        if self.transport_kind == "tcp":
            self._transport.close_listener()
            for conn in self._conns.values():
                conn.close()
        elif self._transport is not None:
            self._reader_stop.set()
            self._transport.close(unlink=True)
        self._transport = None

    def _merge_finals(self, finals: Dict[int, dict]) -> None:
        clock_times: List[List[float]] = []
        for pid, fin in sorted(finals.items()):
            st: RunStats = fin["stats"]
            for err in fin["errors"]:
                self._errors.append(RuntimeError(f"client {pid}: {err}"))
            self.stats.n_updates += st.n_updates
            self.stats.block_time_clock += st.block_time_clock
            self.stats.block_time_value += st.block_time_value
            self.stats.max_observed_staleness = max(
                self.stats.max_observed_staleness, st.max_observed_staleness)
            self.stats.max_unsynced_mag = max(
                self.stats.max_unsynced_mag, st.max_unsynced_mag)
            self.stats.max_update_mag = max(
                self.stats.max_update_mag, st.max_update_mag)
            self.stats.max_unsynced_norm = max(
                self.stats.max_unsynced_norm, st.max_unsynced_norm)
            self.stats.max_update_norm = max(
                self.stats.max_update_norm, st.max_update_norm)
            self.stats.violations.extend(st.violations)
            for k, v in fin["total"].items():
                self._total[k] += v
            self._parts_sent[pid] = fin.get("parts_sent", 0)
            self._final_caches[pid] = fin["cache"]
            if fin.get("trace") and self._trace is not None:
                self._trace.adopt(fin["trace"])
            clock_times.append(st.clock_times)
        if clock_times and all(clock_times):
            n = min(len(c) for c in clock_times)
            self.stats.clock_times = [
                max(c[i] for c in clock_times) for i in range(n)]

    def _on_shard_fin(self, msg: ShardFinMsg) -> None:
        raise TypeError("ShardFin must not reach the in-process runtime")

    def run(self, update_fn: Callable, n_clocks: int,
            timeout: float = 120.0) -> RunStats:
        """Run every worker for ``n_clocks`` periods (start + wait)."""
        self.start(update_fn, n_clocks, timeout=timeout)
        return self.wait()

    def _note_global_clock(self) -> None:
        done = min(p.sent_clock for p in self.procs)
        with self._slock:
            while self._done_clock < done:
                self._done_clock += 1
                self.stats.clock_times.append(time.monotonic() - self._t0)

    @property
    def running(self) -> bool:
        """True while workers are still producing updates."""
        if self._finished or not self._started:
            return False
        if self._proc_mode:
            return any(c.is_alive() for c in self._children)
        return any(t.is_alive() for t in self._workers)

    # ------------------------------------------------------------ membership
    @property
    def n_active_shards(self) -> int:
        """Shards active in the current membership epoch (``n_shards`` is
        the epoch-0 count; slots are ``n_slots``)."""
        return self.partition.A

    @property
    def _shard_rows(self) -> Dict[str, List[np.ndarray]]:
        """Per-slot row ownership under the *current* partition."""
        return {key: [self.partition.rows_of(key, s)
                      for s in range(self.n_slots)]
                for key in self._x0}

    def add_shard(self, sid: Optional[int] = None,
                  timeout: float = 30.0) -> int:
        """Activate a dormant shard slot mid-run (live re-partition; see
        :mod:`repro_torch.runtime.membership`).  Returns the activated
        sid."""
        return self.membership.add_shard(sid, timeout=timeout)

    def remove_shard(self, sid: int, timeout: float = 30.0) -> None:
        """Retire an active shard slot mid-run; its rows migrate to the
        survivors on the device."""
        self.membership.remove_shard(sid, timeout=timeout)

    def completed_clock(self) -> int:
        """Global applied-clock frontier: periods completed by every
        process and applied by every active shard (a cheap racy read,
        monotone — the membership-plan driver polls this for its
        clock-boundary triggers)."""
        done = None
        for s in self.shards:
            vc = s.vc_if_active()
            if vc is not None:
                lo = int(vc.min()) + 1
                done = lo if done is None else min(done, lo)
        return done or 0

    # ------------------------------------------------------------- metrics
    def metrics(self) -> RuntimeMetrics:
        """One typed snapshot of every runtime counter
        (:mod:`repro_torch.runtime.metrics`).  Windowed rates are measured
        against the previous call."""
        return self._metrics_hub.collect()

    # ------------------------------------------------------------- tracing
    def _require_trace(self) -> trace_mod.TraceHub:
        if self._trace is None:
            raise RuntimeError(
                "tracing is off; construct the runtime with "
                "RuntimeConfig(trace=True) (or a sample rate / TraceConfig) "
                "to record events")
        return self._trace

    def dump_trace(self, path: str) -> dict:
        """Export the recorded event log as Chrome trace-event JSON (load
        it in Perfetto's UI).  One track per thread per process; update
        lifelines ride flow events (client send -> shard apply).  Forked
        clients' rings ship only at quiesce, so call after :meth:`wait` to
        see the client side.  Returns ``{"events":, "dropped":, "path":}``."""
        return trace_mod.dump_chrome_trace(self._require_trace(), path)

    def explain_block(self, process=None, worker=None) -> dict:
        """Attribute recorded clock/value stalls to the straggler process
        the workers waited on (requires tracing)."""
        return trace_mod.explain_block(self._require_trace(),
                                       process=process, worker=worker)

    def explain_read(self, result) -> dict:
        """Consistency audit: why did this
        :class:`~repro_torch.runtime.serving.gateway.ReadResult` land where
        it did — names the lagging ``(shard, proc)`` pair and the vc gap
        that forced an escalation.  A pure function of the result's audit
        stamps (works with tracing off)."""
        return trace_mod.explain_read(result)

    def staleness_timeline(self, shard: int) -> dict:
        """Measured master-replica staleness over time for one shard,
        against the policy's clock bound (requires tracing; the points come
        from the replicas' vc adoptions)."""
        bound = (self.policy.staleness if self.policy.clock_bounded
                 else None)
        return trace_mod.staleness_timeline(self._require_trace(), shard,
                                            bound=bound)

    # ------------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        """Master shard state as a restorable snapshot, copied to the host
        (see :mod:`repro_torch.runtime.snapshot`)."""
        return take_snapshot(self)

    def _maybe_periodic_snapshot(self) -> None:
        """Called by a shard thread after its applied vector clock moved:
        take one snapshot each time the global applied frontier — completed
        clocks fully applied on every shard by every process — crosses a
        multiple of ``snapshot_every``.  Boundary-*triggered*, not
        barrier-exact: updates of later periods already in flight may be
        included, exactly like a parameter server checkpointing without a
        barrier (snapshot.py module doc)."""
        if not self.snapshot_every or self._finished:
            return
        # never block a shard thread against an in-flight membership install
        # (the manager waits for shard-side install confirms while holding
        # op_lock): skip the boundary and let the next ClockMsg re-trigger
        if not self.membership.op_lock.acquire(blocking=False):
            return
        try:
            # racy per-entry reads are fine: the frontier is monotone, so a
            # stale read only delays the trigger to the next ClockMsg
            done = self.completed_clock()
            if done < self._next_snap_clock:
                return
            with self._snap_lock:
                if done < self._next_snap_clock:   # another shard was first
                    return
                while self._next_snap_clock <= done:
                    self._next_snap_clock += self.snapshot_every
                snap = self.snapshot()
                self.snapshots.append((done, snap))
                if self.snapshot_dir:
                    os.makedirs(self.snapshot_dir, exist_ok=True)
                    save_snapshot(os.path.join(self.snapshot_dir,
                                               snapshot_name(done)), snap)
                if self.snapshot_keep_last:
                    self._prune_retained()
        finally:
            self.membership.op_lock.release()

    def _prune_retained(self) -> None:
        """Retention (``snapshot_keep_last=k``): drop periodic snapshots
        beyond the newest k — in memory and on disk — then drop WAL
        segments fully covered by the *oldest retained* snapshot, so every
        retained snapshot still recovers exactly (genesis replay stops
        working past the horizon: retention trades point-in-time depth for
        disk).  Caller holds ``_snap_lock``."""
        k = self.snapshot_keep_last
        if len(self.snapshots) > k:
            del self.snapshots[:len(self.snapshots) - k]
        if self.snapshot_dir:
            for _, path in snapshot_files(self.snapshot_dir)[k:]:
                try:
                    os.remove(path)
                except OSError:
                    pass
        if self.wal_dir and self.snapshots:
            wal = self.snapshots[0][1].get("wal")
            if wal is not None:
                prune_segments(self.wal_dir,
                               {sid: int(p)
                                for sid, p in enumerate(wal["parts"])})

    def latest_snapshot(self):
        """The most recent periodic snapshot, or None."""
        with self._snap_lock:
            return self.snapshots[-1][1] if self.snapshots else None

    # ------------------------------------------------------------- reads
    def read(self, key: str, process: int = 0) -> np.ndarray:
        """Serving read: a Get() against a live process cache (threaded
        mode), or against the live master shards / the final shipped cache
        (multi-process mode, where peer caches live in other processes)."""
        if self._proc_mode:
            if self._finished and self._final_caches:
                return self._final_caches[process][key].copy().reshape(
                    self._shapes[key])
            return self.master_value(key)
        proc = self.procs[process]
        with proc.cond:
            flat = proc.cache[key].copy()
        return flat.reshape(self._shapes[key])

    def master_value(self, key: str) -> np.ndarray:
        """Assemble the authoritative value from the shard tables, as a host
        array in the key's original shape.

        Exact once the runtime is quiesced (after :meth:`wait`); mid-run it
        is a live, per-shard-locked read of the master blocks.  Holds the
        membership op lock so it never observes a half-installed partition
        (a read racing a live re-partition waits out the short freeze).
        """
        out = np.zeros_like(self._x0[key])
        with self.membership.op_lock:
            for shard in self.shards:
                shard.read_rows(key, out)
        return out.reshape(self._shapes[key])

    def expected_value(self, key: str) -> np.ndarray:
        """``x0 + Σ updates`` for ``key`` as the clients tallied them (host,
        original shape): what the master must equal once quiesced."""
        with self._slock:
            total = self._x0[key] + self._total[key]
        return total.reshape(self._shapes[key])

    def view(self, process: int) -> Dict[str, np.ndarray]:
        """A process cache as {key: array in the original shape}."""
        if self._proc_mode:
            if not self._finished:
                raise RuntimeError("multi-process caches are only shipped "
                                   "back at wait(); use read() mid-run")
            cache = self._final_caches[process]
            return {k: v.copy().reshape(self._shapes[k])
                    for k, v in cache.items()}
        proc = self.procs[process]
        with proc.cond:
            return {k: v.copy().reshape(self._shapes[k])
                    for k, v in proc.cache.items()}

    # ------------------------------------------------------------- checks
    def _final_checks(self) -> None:
        """Eventual consistency: caches and master equal x0 + sum(updates)."""
        expected = {k: self.expected_value(k).reshape(self._x0[k].shape)
                    for k in self._x0}
        caches = (self._final_caches.items() if self._proc_mode
                  else ((p, proc.cache) for p, proc in enumerate(self.procs)))
        for p, cache in caches:
            for k in self._x0:
                if not np.allclose(cache[k], expected[k], atol=1e-6):
                    self._violation(
                        f"eventual-consistency violation on {k} (process {p})")
        for k in self._x0:
            master = self.master_value(k).reshape(self._x0[k].shape)
            if not np.allclose(master, expected[k], atol=1e-6):
                self._violation(
                    f"eventual-consistency violation on {k} (shard tables)")
        # zero-lost/zero-duplicated audit across membership changes: every
        # update part a client sent was applied by exactly one shard slot
        applied = np.zeros(self.n_proc, dtype=np.int64)
        for s in self.shards:
            applied += s.applied_parts
        if not np.array_equal(applied, self._parts_sent):
            self._violation(
                f"update audit: parts sent {self._parts_sent.tolist()} != "
                f"applied {applied.tolist()} (lost or duplicated updates)")


# ---------------------------------------------------------------------------
# forked client process (wire transports)
# ---------------------------------------------------------------------------


class _ClientHost(_WorkerFlowMixin):
    """Child-side runtime facade: owns one :class:`ClientProcess`, its
    worker threads, and the wire channels to every shard.  Mirrors the
    attribute surface :class:`_WorkerFlowMixin` and :class:`ClientProcess`
    expect from ``rt``.

    Everything it reads from the parent's runtime is host state (numpy
    arrays, the partition, the policy, ``update_fn``): the parent's master
    blocks stay on the device and the child never touches them, nor CUDA
    at all.
    """

    def __init__(self, rt: PSRuntime, pid: int):
        self.pid = pid
        self.policy = rt.policy
        self.seed = rt.seed
        self.check = rt.check
        self.barrier_reads = rt.barrier_reads
        self.prioritize = rt.prioritize
        self.metrics_on = rt.metrics_on
        # a hub of this process's own: the parent's hub, copied by the
        # fork, is never touched here (its rings are the parent's, and its
        # lock may have been copied held)
        self.trace_on = rt.trace_on
        self._trace = (trace_mod.TraceHub(rt._trace_cfg, f"client-p{pid}")
                       if rt.trace_on else None)
        self.n_shards = rt.n_shards
        self.n_slots = rt.n_slots
        self.n_proc = rt.n_proc
        self.tpp = rt.tpp
        self.update_fn = rt.update_fn
        self.n_clocks = rt.n_clocks
        self._deadline = rt._deadline
        self._x0 = rt._x0
        self._shapes = rt._shapes
        self._row_counts = rt._row_counts
        self.partition = rt.partition         # epoch at fork time (0)
        self._t0 = time.monotonic()

        self.stats = RunStats()
        self._slock = threading.Lock()
        self._total = {k: np.zeros_like(v) for k, v in self._x0.items()}
        self._parts_sent = np.zeros(rt.n_proc, dtype=np.int64)
        # globally unique uids without cross-process coordination
        self._uid = itertools.count(pid, rt.n_proc)
        self._errors: List[BaseException] = []
        self._fins: set = set()
        self._all_fins = threading.Event()

        self.proc = ClientProcess(self, pid)
        self.procs = {pid: self.proc}
        self._readers: List[threading.Thread] = []
        chans: List[T.WireChannel] = []
        trc = self._trace
        if rt.transport_kind == "tcp":
            self._conns = rt._transport.connect(pid)
            for s in range(rt.n_slots):
                conn = self._conns[s]
                chans.append(T.WireChannel(f"p{pid}->s{s}", conn.write,
                                           trace=trc))
                self._readers.append(T.start_reader(
                    f"rx-s{s}", conn.read_chunk, self.proc.inbox,
                    self._record_error, trace=trc))
        else:
            self._stop = threading.Event()
            codec = (T.RowCodec(list(self._x0.keys())) if rt.zero_copy
                     else None)
            for s in range(rt.n_slots):
                edge = rt._transport.edges[(pid, s)]
                if codec is not None:
                    bell_w = edge.c2s_bell[1]
                    chans.append(T.WireChannel(
                        f"p{pid}->s{s}",
                        T.ring_parts_writer(edge.c2s, self._deadline),
                        max_frame=rt._shm_max_frame, codec=codec,
                        on_flush=lambda w=bell_w: T.ShmEdge.ring_bell(w),
                        trace=trc))
                    self._readers.append(T.start_view_reader(
                        f"rx-s{s}",
                        T.RingViewReader(edge.s2c, codec, edge.s2c_bell[0],
                                         self._stop, trace=trc),
                        self.proc.inbox, self._record_error))
                else:
                    chans.append(T.WireChannel(
                        f"p{pid}->s{s}",
                        T.ring_writer(edge.c2s, edge.c2s_bell[1],
                                      self._deadline),
                        max_frame=rt._shm_max_frame, trace=trc))
                    self._readers.append(T.start_reader(
                        f"rx-s{s}", T.ring_reader(edge.s2c, edge.s2c_bell[0],
                                                  self._stop),
                        self.proc.inbox, self._record_error, trace=trc))
        self._channels = chans
        self._chan_ps = {pid: chans}

    # ---------------------------------------------------------- rt interface
    def proc_of(self, worker: int) -> int:
        return self.pid

    def _magnitude_order(self, mags: np.ndarray) -> np.ndarray:
        """The send order in host numpy: a forked child must not touch CUDA,
        and this is the reference child's own order — the ``topk_mag``
        contract (descending, ties in index order, NaN last), not a
        fallback.  So forked clients launch ``topk_mag`` no time."""
        return np.argsort(-mags, kind="stable")

    def _next_uid(self) -> int:
        return next(self._uid)

    def _send(self, chan, msg) -> None:
        chan.send(msg)

    def _send_many(self, chan, msgs: list) -> None:
        if msgs:
            chan.send_many(msgs)

    def _msg_done(self) -> None:
        pass

    def _violation(self, text: str) -> None:
        with self._slock:
            self.stats.violations.append(text)

    def _record_error(self, e: BaseException) -> None:
        with self._slock:
            self._errors.append(e)

    def _check_alive(self) -> None:
        if time.monotonic() > self._deadline:
            raise RuntimeError("client deadline exceeded (gate stuck)")
        if self._errors:
            raise RuntimeError("client aborted: peer thread failed")

    def _note_global_clock(self) -> None:
        # local completion times; the parent merges max() across processes
        now = time.monotonic() - self._t0
        with self._slock:
            while len(self.stats.clock_times) < self.proc.sent_clock:
                self.stats.clock_times.append(now)

    def _on_shard_fin(self, msg: ShardFinMsg) -> None:
        self._fins.add(msg.shard)
        if len(self._fins) == self.n_slots:
            self._all_fins.set()

    # ---------------------------------------------------------------- run
    def run(self) -> dict:
        self.proc.thread.start()
        workers = [threading.Thread(target=self._worker_loop, args=(w,),
                                    name=f"ps-worker-{w}", daemon=True)
                   for w in self.proc.workers]
        for t in workers:
            t.start()
        timed_out = False
        for t in workers:
            while t.is_alive():
                t.join(timeout=0.5)
                if time.monotonic() > self._deadline:
                    timed_out = True
                    self._record_error(RuntimeError(
                        f"worker {t.name} still alive at deadline"))
                    break
        if not timed_out:
            # quiesce leg 1: no more updates/clocks from this process (acks
            # for still-inbound deliveries continue from the comm thread).
            # A still-running (timed-out) worker forbids this promise — the
            # run is failing anyway; ship the error without the handshake.
            with self.proc.route_lock:
                ep = self.proc.part.epoch
            for chan in self._channels:
                self._send(chan, ProcDoneMsg(self.pid, ep))
            # quiesce leg 2: every shard's fin = our inbound stream is done
            if not self._all_fins.wait(
                    timeout=max(0.1, self._deadline - time.monotonic())):
                self._record_error(RuntimeError(
                    f"client {self.pid}: shard fins missing "
                    f"(have {sorted(self._fins)})"))
        self.proc.inbox.put(SHUTDOWN)
        self.proc.thread.join(timeout=5.0)
        for chan in self._channels:
            chan.close()                       # EOF frame ends parent readers
        return {
            "pid": self.pid,
            "stats": self.stats,
            "total": self._total,
            "cache": self.proc.cache,
            "parts_sent": int(self._parts_sent[self.pid]),
            "errors": [repr(e) for e in self._errors],
            "trace": (self._trace.export() if self._trace is not None
                      else None),
        }


def _forbid_cuda(pid: int) -> None:
    """Make any use of CUDA in this forked client raise.  Every CUDA call
    and every tensor made on a CUDA device first runs ``torch.cuda.
    _lazy_init`` (the fork marks the device for re-initialization even when
    the parent had initialized it), so replacing it refuses the device at
    the first touch, with a message that names the cause."""
    def refuse(*args, **kwargs):
        raise RuntimeError(
            f"forked client {pid} touched CUDA: the clients of a wire "
            f"transport run on the host only (the shards and the device "
            f"stay in the parent)")
    torch.cuda._lazy_init = refuse


def _client_child_main(rt: PSRuntime, pid: int, pipe: int) -> None:
    """Entry point of a forked client process; ships its final state to
    the parent through the pipe's write end ``pipe``."""
    try:
        _forbid_cuda(pid)
        # comm/reader threads must grab the GIL promptly from the
        # compute-bound worker: the default 5 ms switch interval adds a
        # multi-ms stall to every inbound frontier/delivery hop
        sys.setswitchinterval(1e-3)
        host = _ClientHost(rt, pid)
        payload = host.run()
    except BaseException as e:
        payload = {"pid": pid, "stats": RunStats(), "total": {},
                   "cache": {}, "errors": [repr(e)]}
    try:
        T.send_state(pipe, payload)
    finally:
        # skip the teardown inherited from the parent (its atexit hooks and
        # the device state a forked child must not touch)
        os._exit(0)
