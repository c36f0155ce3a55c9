"""Server shard of the PS runtime (paper §4.1), master state on the device.

Each shard is one thread owning a partition of every key's rows (row ``r``
of a key lives on ``active[r % len(active)]`` —
:class:`repro_torch.runtime.membership.Partition`), held as one **dense
contiguous float64 tensor per key on the runtime's device**.  A batch of row
updates lands in the block as one ordered scatter-add per key
(:mod:`repro_torch.kernels.ps_apply`): on the card every apply goes through
the CUDA kernel, which groups the batch's entries by row (a stable sort)
and walks each row's entries in submission order, one thread a (row,
column); on the CPU a single part (unique rows) is a fancy-index add
and a coalesced batch takes the kernel's plain version, the reference's two
branches.  Either way duplicates accumulate in submission order, so the
master stays bitwise ``x0 + Σ updates`` in the simulator's arithmetic.
``state()``/``load_state()`` and ``read_rows()`` (live locked master reads)
are the row-state interfaces; they copy between the device and the host
under the shard lock.

The shard applies incoming update parts to the master block, then
propagates them to every peer process cache, echoes client clock messages
as :class:`ClockMarker` (the delivery frontier the clock bound blocks on),
and tracks acks so the origin worker's unsynchronized accumulator can
shrink only once an update really is visible everywhere — the paper's
definition of a *synchronized* update.  That bookkeeping is host numpy: only
the master blocks live on the device.

Strong-VAP (paper §2, "half-synchronized" updates): before starting a
delivery the shard consults :func:`controller.strong_delivery_gate`; gated
updates queue FIFO per key and are released as acks free half-sync budget,
mirroring ``server.py`` ``_try_start_delivery`` / ``_on_deliver``.  As in
the simulator, a queued update is *not* counted against the clock frontier
— the marker echo is immediate — so the two bounds compose identically in
both implementations.  The half-sync/pending accounting is key-global (not
partition-local), so it survives membership change untouched.

Elastic membership (:mod:`repro_torch.runtime.membership`): the shard is a
*slot* — it may be inactive (owning no rows: ``(0, C)`` blocks on the
device), active, retired, or re-activated as epochs change.  Between a
pending epoch's announce and its install, any update or clock stamped with
the next epoch is **held** FIFO (copied out of the ring first) and replayed
through the normal apply/publish path at install — on the card through
``ps_apply`` with the new partition's ``A``, its launches counted under
:data:`REPLAY_SITE`.  A shard active in the old epoch *cuts* once every
client process acked (channel FIFO then guarantees no more old-epoch
updates), handing the manager ``(rows, values)`` per key — host row ids and
a device clone of its block — plus its applied vector clock.  A retiring
slot seals its write-ahead log segment at the cut and broadcasts
``clock=INF`` markers — FIFO-behind everything it ever delivered — so it
stops constraining the clock frontier exactly when its stream completes; a
(re)activated slot broadcasts *seeded* markers from its post-replay vector
clock so client frontiers unblock without waiting a period, and pushes an
in-stream re-bootstrap to every subscribed replica.

Multi-process quiesce: when the runtime runs with a wire transport, each
client sends :class:`ProcDoneMsg` after its last clock; once every process
is done and ``pending``/``queued``/ESSP-held deliveries have drained, the
shard broadcasts :class:`ShardFinMsg` (FIFO-after everything else it will
ever send), which is the client's signal that its inbound stream is
complete; a pending install (held traffic still to replay) defers it.  On
the shm transport with the zero-copy wire, an update part's ``rows`` and
``delta`` are numpy views into the client's ring: the apply copies them to
the device before the batch's frame pins are released, and anything
retained past the batch is materialized first.

Applied vector clock: ``clock_vc[p]`` is the highest period of process p
whose updates this shard has applied — exact because ClockMsg is
FIFO-after the period's updates on the p->shard channel.  Snapshots stamp
each shard's state with it, the write-ahead log stamps its group commits
with it, and the serving tier measures every read against it.

Serving tier (:mod:`repro_torch.runtime.serving`): the shard publishes to
subscribed read replicas one coalesced ``ReplicaDeltaMsg`` per key per
apply cycle (global rows, the host arrays the apply copied to the device,
copied out of the ring first under the zero-copy wire), followed by a
``ReplicaVcMsg`` stamp when the applied vector clock moved, all FIFO on the
replica's publish channel.  A replica subscribing mid-run is bootstrapped
**in-stream**: the shard answers with its current partition (the snapshot
payload format, copied off the device) plus a vc stamp before any further
delta, so the replica's view is exact from the first frame it applies.
Publish sends are **non-blocking** where the wire allows
(``WireChannel.try_send_many``): a wedged replica whose sink filled up is
marked *stale* and its frames are dropped instead of stalling the apply
loop; every later publish cycle retries a full in-stream re-bootstrap, and
the replica resumes exact once its sink drains.  Publish channels are
serving-owned and bypass the runtime's in-flight quiesce accounting.

Durability tier (:mod:`repro_torch.runtime.wal`): with
``RuntimeConfig(wal_dir=)`` the shard appends every applied update part to
a per-slot write-ahead log — ``WalWriter.log_parts`` at the end of the
apply's lock section (so the log marks stay consistent with the dense
state), ``commit`` (group commit + vc stamp) at the end of a batch in
which the applied vector clock moved, followed by the runtime's periodic
snapshot check, and ``seal`` at the epoch cut of a retiring slot.  The
frames are encoded from the host arrays before the batch's frame pins are
released.  :meth:`durability_cut` copies the
masters to the host with the vc and the log marks under one lock.

Exactly-once apply: :class:`UidDedup` records every applied part and drops
exact duplicates by uid under the per-process clock frontier instead of
double-applying.  The drop filter is armed from the start on WAL runs (log
replay is at-least-once by design) and arms permanently at the first
membership op on WAL-off runs — cross-epoch resends are the only WAL-off
source of duplicates.

Tracing (:mod:`repro_torch.runtime.trace`): with ``rt.trace_on`` the shard
records a ``shard_batch`` span per batch, an ``apply_part`` point per
sampled part, ``lock_wait``, ``apply``, ``wal_append`` and ``wal_commit``
spans, and with subscribers a ``publish`` span per cycle and a
``publish_part`` point per sampled delta (the start of the lifeline the
replica's ``ingest_part`` ends).  On the card the ``apply`` span ends after a synchronize of the
current stream, so it times the apply and not the launches' enqueue; with
tracing off the apply path gains no synchronize.

ESSP (eager server push, arXiv:1410.8043): under ``Policy("essp", ...)``
the shard parks each applied part's fan-out :class:`DeliverMsg`\\ s in a
per-destination hold instead of sending immediately, and releases the
whole hold — one coalesced batch per peer channel — whenever it processes a
client clock boundary.  Workers still gate on SSP's clock bound, but every
boundary pushes all applied deltas to all peers, so observed staleness
collapses well below s.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import controller
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime.membership import INF_CLOCK
from repro_torch.runtime.messages import (SHUTDOWN, AckBatchMsg, Channel,
                                          ClockMarker, ClockMsg, DeliverMsg,
                                          EpochAckMsg, EpochBeginMsg,
                                          FullyDelivered, InstallMsg,
                                          ProcDoneMsg,
                                          ReplicaDeltaMsg, ReplicaFinMsg,
                                          ReplicaStateMsg, ReplicaVcMsg,
                                          ShardFinMsg, SubscribeMsg,
                                          UnsubscribeMsg, UpdateMsg,
                                          group_by_channel, pump_inbox)
from repro_torch.runtime.transport import (FifoAssert, materialize_msg,
                                           release_msgs)

log = logging.getLogger("repro_torch.runtime.shard")

_BATCH = 256        # max messages coalesced per apply/dispatch cycle
# the name the held next-epoch replay's ps_apply launches count under
# (ps_apply's launches_by_site)
REPLAY_SITE = "epoch_replay"


class UidDedup:
    """Uid-level duplicate filter for the shard apply path.

    Exactly-once apply under *at-least-once* delivery: a part is fresh iff
    its clock timestamp is beyond the origin process's acknowledged
    frontier AND its uid has not been seen above that frontier.  The
    frontier is the per-process clock the shard has fully applied
    (advanced by ClockMsg, which is FIFO-behind every part it covers on
    the client->shard channel, so a live first delivery can never be
    mistaken for a duplicate); uids above the frontier are held in a
    per-process table and pruned as the frontier advances, bounding memory
    to the in-flight window.

    The transports deliver exactly once, so a shard without a WAL only
    records here until the first membership op; a WAL run arms the drop
    filter from the start (log replay is at-least-once by design), and the
    first ``EpochBeginMsg`` arms it for good (cross-epoch resends).
    :func:`~repro_torch.runtime.snapshot.recover_to_vc` runs one per slot
    over the replayed log.
    """

    def __init__(self, n_proc: int):
        self.frontier = np.full(n_proc, -1, dtype=np.int64)
        self._seen: List[Dict[int, int]] = [{} for _ in range(n_proc)]
        self.n_dropped = 0

    def fresh(self, uid: int, process: int, ts: int) -> bool:
        """Record-and-test: True exactly once per (uid, process) above the
        frontier; False (a duplicate) otherwise."""
        if ts <= self.frontier[process] or uid in self._seen[process]:
            self.n_dropped += 1
            return False
        self._seen[process][uid] = ts
        return True

    def advance(self, process: int, clock: int) -> None:
        """Raise the process frontier to ``clock`` and prune the uids it
        now covers (their ts-vs-frontier test subsumes the uid test)."""
        if clock > self.frontier[process]:
            self.frontier[process] = clock
            seen = self._seen[process]
            self._seen[process] = {u: t for u, t in seen.items()
                                   if t > clock}


class ServerShard:
    def __init__(self, rt, sid: int, x0: Dict[str, torch.Tensor]):
        self.rt = rt
        self.sid = sid
        self.inbox: queue.Queue = queue.Queue()
        self.lock = threading.Lock()      # guards .dense/.part/.clock_vc
        self.part = rt.partition          # current membership epoch's map
        self.epoch = self.part.epoch
        # master state: one dense (n_owned_rows, C) float64 tensor per key on
        # the runtime's device, in partition order (global row r at local
        # index r // part.A), gathered from the canonical x0 on that device;
        # a slot inactive in epoch 0 holds (0, C) blocks
        self.dense: Dict[str, torch.Tensor] = {
            key: v.index_select(0, torch.as_tensor(
                self.part.rows_of(key, sid), device=v.device))
            for key, v in x0.items()}
        # strong-VAP: per-key magnitude of half-synchronized updates
        # (key-global host state, untouched by the partition)
        self.halfsync: Dict[str, np.ndarray] = {
            key: np.zeros_like(x) for key, x in rt._x0.items()}
        # uid -> (msg, remaining acks)
        self.pending: Dict[int, Tuple[UpdateMsg, int]] = {}
        # per-key FIFO of updates waiting on the strong delivery gate
        self.queued: Dict[str, deque] = defaultdict(deque)
        self._fifo = FifoAssert()          # per origin process
        self._outbox: List[Tuple[Channel, object]] = []
        # elastic membership: pending epoch between Begin and Install
        self._pending_part = None          # next epoch's Partition
        self._pending_acks: set = set()    # procs that crossed the barrier
        self._cut_done = False
        self._held: List[object] = []      # next-epoch msgs, FIFO per proc
        # zero-lost/zero-duplicated audit: update parts applied, per origin
        self.applied_parts = np.zeros(rt.n_proc, dtype=np.int64)
        # durability tier: per-slot write-ahead log (None unless the runtime
        # was built with wal_dir)
        self.wal = rt._make_wal(sid)
        # at-least-once dedup: the per-process frontier and uid tables are
        # always kept current, but the drop filter arms only where
        # duplicates can exist — WAL runs (log replay) from the start,
        # WAL-off runs permanently from the first membership op
        self._dedup = UidDedup(rt.n_proc)
        self._dedup_armed = self.wal is not None
        # applied per-process vector clock (guarded by .lock); _vc_dirty:
        # it moved in this batch (group commit + snapshot check at its end)
        self.clock_vc = np.full(rt.n_proc, -1, dtype=np.int64)
        self._vc_dirty = False
        # serving tier: replica id -> publish channel, and the publishes
        # pending per replica for this cycle
        self.subscribers: Dict[int, object] = {}
        self._pub: Dict[int, List[object]] = {}
        # wedged replicas (drop-and-resync).  Treated as immutable: every
        # change rebinds a fresh set (atomic under the GIL), so other
        # threads (ReplicaSet.stale_replicas) iterate a snapshot safely
        self._stale_subs: frozenset = frozenset()
        self.pub_drops = 0                 # publish cycles dropped on a full
        self.pub_resyncs = 0               # sink / successful re-bootstraps
        # ESSP (eager server push): applied deltas held per destination and
        # released one coalesced batch per peer at every clock boundary
        self._essp_hold: Dict[int, List[DeliverMsg]] = {}
        # load counters: single-writer (this shard's thread), read racily.
        # proc_load maps pid -> (clock, counters) from the ClockMsg piggyback
        self.m_rows_applied = 0            # row-updates applied
        self.m_bytes_applied = 0           # delta bytes applied
        self.m_lock_wait = 0.0             # cumulative dense-lock wait (s)
        self.m_last_publish = 0.0          # monotonic ts of last publish
        self.proc_load: Dict[int, Tuple[int, np.ndarray]] = {}
        # multi-process quiesce: processes that sent ProcDone; fin sent once
        self._done_procs: set = set()
        self._fin_sent = False
        self.thread = threading.Thread(
            target=self._loop, name=f"ps-shard-{sid}", daemon=True)

    # ------------------------------------------------------------------ loop
    def _loop(self) -> None:
        pump_inbox(self.inbox, self._handle_batch, cap=_BATCH)

    def _handle_batch(self, batch: list) -> bool:
        """Coalesce runs of UpdateMsgs into one apply per key, dispatch
        everything else in arrival order, flush sends per channel.  Messages
        stamped with a pending (not yet installed) epoch are held FIFO and
        replayed at install."""
        rt = self.rt
        shutdown = False
        done = 0
        held = 0
        t_batch = time.monotonic_ns() if rt.trace_on else 0
        run: List[UpdateMsg] = []
        for msg in batch:
            if msg is SHUTDOWN:
                shutdown = True
                break
            done += 1
            try:
                if rt.check:
                    # serving control (subscribe) names no process: its
                    # channel is in-process and needs no FIFO audit here
                    sender = getattr(msg, "process", None)
                    if sender is not None:
                        err = self._fifo.check(sender, msg.seq)
                        if err:
                            rt._violation(f"FIFO violation: proc {sender}->"
                                          f"shard {self.sid} {err}")
                if self._should_hold(msg):
                    # held past this cycle (replayed at install): copy any
                    # ring-backed arrays out before the frame pin drops
                    self._held.append(materialize_msg(msg))
                    held += 1
                    continue
                if isinstance(msg, UpdateMsg):
                    run.append(msg)
                else:
                    self._flush_updates(run)
                    run = []
                    self._handle(msg)
            except BaseException as e:          # surface into wait()
                rt._record_error(e)
        try:
            self._flush_updates(run)
            if rt._proc_mode and not shutdown:
                self._maybe_fin()
            self._flush_publish()
        except BaseException as e:
            rt._record_error(e)
        if rt.trace_on and done:
            rt._trace.span(trace_mod.EV_SHARD_BATCH, t_batch, self.sid, done)
        # zero-copy discipline: every view consumed by the applies above is
        # done with, and everything retained (held/queued/pending/publish/
        # outbox) was materialized — release the frame pins BEFORE the
        # blocking outbox writes.  Blocking on a full s->c ring while still
        # pinning the c->s ring would let two full rings deadlock each other
        # (the client comm thread observes the mirror-image rule).
        release_msgs(batch)
        self._flush_outbox()
        # in-flight decrements must come *after* the sends this batch caused
        # were enqueued (incrementing the counter), else the quiesce wait can
        # observe a transient 0 and shut down ahead of late deliveries.
        # Held messages stay in flight until their replay.
        for _ in range(done - held):
            rt._msg_done()
        return shutdown

    def _should_hold(self, msg) -> bool:
        """Next-epoch traffic raced ahead of this slot's install: park it.

        Only updates and clocks need the epoch hold (they touch the dense
        layout / the marker echo); ProcDone is epoch-independent — an
        uninvolved slot's epoch never advances, and ``_maybe_fin`` defers
        the fin past any pending install and replay."""
        return (isinstance(msg, (UpdateMsg, ClockMsg))
                and msg.epoch > self.part.epoch)

    # --------------------------------------------------------------- sends
    def _send(self, chan: Channel, msg) -> None:
        self._outbox.append((chan, msg))

    def _flush_outbox(self) -> None:
        """Per-channel batched send (one batch per channel per cycle)."""
        if not self._outbox:
            return
        pairs, self._outbox = self._outbox, []
        for chan, msgs in group_by_channel(pairs):
            self.rt._send_many(chan, msgs)

    # ------------------------------------------------------------- dispatch
    def _handle(self, msg) -> None:
        rt = self.rt
        if isinstance(msg, AckBatchMsg):
            with rt._slock:
                rt.stats.n_ack_msgs += 1
                rt.stats.n_acked_updates += len(msg.uids)
            for uid in msg.uids:
                self._ack_uid(int(uid))
        elif isinstance(msg, ClockMsg):
            # applied vector clock: the process's period-<=clock updates are
            # FIFO-before this message, so they are already in .dense
            with self.lock:
                self.clock_vc[msg.process] = max(
                    self.clock_vc[msg.process], msg.clock)
            self._vc_dirty = True
            # every part of the period is FIFO-before this message:
            # the dedup frontier may advance and prune its uid table
            self._dedup.advance(msg.process, msg.clock)
            if msg.load is not None:
                # metrics piggyback: the process's boundary counter snapshot
                # (monotone per process; keep the newest boundary)
                cur = self.proc_load.get(msg.process)
                if cur is None or msg.clock >= cur[0]:
                    self.proc_load[msg.process] = (msg.clock, msg.load)
            # ESSP: the clock boundary is the server's push point — release
            # every held delivery (all destinations) FIFO-before the markers
            self._flush_essp_hold()
            # echo the period-completed marker to every peer.  All of the
            # process's period-<=clock updates precede this message on the
            # same FIFO channel, so their DeliverMsgs are already enqueued
            # ahead of the markers sent here.
            for q in range(rt.n_proc):
                if q != msg.process:
                    self._send(rt._chan_sp[self.sid][q],
                               ClockMarker(msg.process, self.sid, msg.clock,
                                           self.epoch))
        elif isinstance(msg, EpochBeginMsg):
            self._pending_part = msg.part
            self._pending_acks = set()
            self._cut_done = False
            # a membership op is in flight: cross-epoch at-least-once
            # resends are now possible (and remain so — late retried wires
            # can land after the install), so the duplicate filter arms
            # permanently.  The uid tables have been recording since shard
            # start, so parts applied before arming are covered too.
            self._dedup_armed = True
        elif isinstance(msg, EpochAckMsg):
            self._pending_acks.add(msg.process)
            self._maybe_cut()
        elif isinstance(msg, InstallMsg):
            self._install(msg)
        elif isinstance(msg, SubscribeMsg):
            self._on_subscribe(msg)
        elif isinstance(msg, UnsubscribeMsg):
            self._on_unsubscribe(msg)
        elif isinstance(msg, ProcDoneMsg):
            self._done_procs.add(msg.process)
            # ESSP: no further ClockMsg from this process will trigger a
            # boundary flush — release any backlog so the fin can drain
            self._flush_essp_hold()
        else:
            raise TypeError(f"shard {self.sid}: unexpected message {msg!r}")

    # ------------------------------------------------------- proc quiesce
    def _maybe_fin(self) -> None:
        """Broadcast ShardFin once every process is done and deliveries have
        fully drained — nothing further will ever leave this shard.  A
        pending membership install (held messages still to replay) defers
        the fin."""
        rt = self.rt
        if (self._fin_sent or len(self._done_procs) < rt.n_proc
                or self.pending or any(self.queued.values())
                or self._pending_part is not None or self._held
                or self._essp_hold):
            return
        self._fin_sent = True
        for q in range(rt.n_proc):
            self._send(rt._chan_sp[self.sid][q], ShardFinMsg(self.sid))

    # ------------------------------------------------------ epoch protocol
    def _maybe_cut(self) -> None:
        """All clients crossed the barrier: hand off (membership module
        docstring, step 3).  Channel FIFO guarantees no further old-epoch
        update can arrive, so the cut is final for this epoch."""
        rt = self.rt
        if (self._pending_part is None or self._cut_done
                or len(self._pending_acks) < rt.n_proc):
            return
        self._cut_done = True
        if self.part.owns(self.sid):
            rt.membership.inbox.put(
                ("handoff", self.sid, (self.device_cut(), self.vc_snapshot())))
        if not self._pending_part.owns(self.sid):
            if self.wal is not None:
                # the cut is final for this slot: no old-epoch update can
                # arrive (channel FIFO behind the acks) and next-epoch
                # updates route elsewhere — seal the segment at the epoch
                # cut; a later re-activation opens the next one
                self.wal.seal(self.vc_snapshot())
            # retiring: everything this slot will ever deliver (bar strong-
            # VAP-queued updates, which are exempt from the clock frontier
            # exactly like in the simulator) is FIFO-before these markers,
            # so clients may treat the slot as infinitely caught up.  ESSP
            # holds count as "ever deliver": release them first.
            self._flush_essp_hold()
            for q in range(rt.n_proc):
                for p in range(rt.n_proc):
                    if p != q:
                        self._send(rt._chan_sp[self.sid][q],
                                   ClockMarker(p, self.sid, INF_CLOCK,
                                               self.epoch))

    def _install(self, msg: InstallMsg) -> None:
        """Adopt the new epoch's partition and dense blocks (tensors on the
        device, or ``(0, C)`` ones for a slot left without rows), replay
        held next-epoch traffic, then broadcast seeded frontier markers."""
        rt = self.rt
        with self.lock:
            self.part = msg.part
            if msg.blocks is None:              # retiring / staying inactive
                self.dense = {key: v[:0].clone()
                              for key, v in self.dense.items()}
            else:
                self.dense = dict(msg.blocks)
                np.maximum(self.clock_vc, msg.seed_vc, out=self.clock_vc)
        self.epoch = msg.epoch
        self._pending_part = None
        self._pending_acks = set()
        self._cut_done = False
        held, self._held = self._held, []
        run: List[UpdateMsg] = []
        for m in held:
            if isinstance(m, UpdateMsg):
                run.append(m)
            else:
                self._flush_updates(run, site=REPLAY_SITE)
                run = []
                self._handle(m)
        self._flush_updates(run, site=REPLAY_SITE)
        for _ in held:
            rt._msg_done()
        # ESSP: deliveries the replay just parked must be FIFO-before the
        # seeded markers that vouch for them
        self._flush_essp_hold()
        if self.part.owns(self.sid):
            # seeded markers: deliveries for everything clock_vc covers are
            # FIFO-before this on each s->q channel (replayed just above or
            # published by the old owners, whose markers/INF still vouch),
            # and install strictly follows every client's swap+ack, so the
            # marker can never overtake the receiver's router swap
            vc = self.vc_snapshot()
            for q in range(rt.n_proc):
                for p in range(rt.n_proc):
                    if p != q and vc[p] >= 0:
                        self._send(rt._chan_sp[self.sid][q],
                                   ClockMarker(p, self.sid, int(vc[p]),
                                               self.epoch))
        # serving: existing subscribers lack the base values of rows that
        # migrated INTO this slot (they only ever saw this slot's deltas) —
        # push an in-stream re-bootstrap: a post-replay state + vc cut,
        # FIFO-after everything already published, superseding any replay
        # deltas still pending for them
        if self.part.owns(self.sid) and self.subscribers:
            for rid, chan in self.subscribers.items():
                self._pub.pop(rid, None)
                if rid in self._stale_subs:
                    continue               # the resync path re-bootstraps
                if not self._publish_send(chan, [ReplicaStateMsg(
                        self.sid, self.state(), self.vc_snapshot(),
                        epoch=msg.epoch)]):
                    self._stale_subs = self._stale_subs | {rid}
                    self.pub_drops += 1
                    log.warning(
                        "shard %d: replica %d re-bootstrap after epoch %d "
                        "install dropped on a full sink — marked stale for "
                        "resync", self.sid, rid, msg.epoch)
        self._vc_dirty = True
        rt.membership.inbox.put(("installed", self.sid, msg.epoch))

    # --------------------------------------------------------------- updates
    def _flush_updates(self, run: List[UpdateMsg],
                       site: Optional[str] = None) -> None:
        """Apply a run of update parts as one ordered scatter-add per key,
        then route each through the (per-message) delivery state machine.
        ``site`` names the launches' call site in ``ps_apply``'s count
        (the held replay at install)."""
        if not run:
            return
        rt = self.rt
        # record-and-test every part; with the filter armed, drop exact
        # duplicates before they touch the dense state, the audit counters
        # or the WAL (dropped messages' frame pins release with the batch)
        fresh = [self._dedup.fresh(m.uid, m.process, m.ts) for m in run]
        if self._dedup_armed:
            run = [m for m, f in zip(run, fresh) if f]
            if not run:
                return
        trc = rt._trace if rt.trace_on else None
        by_key: Dict[str, List[UpdateMsg]] = {}
        n_rows = n_bytes = 0
        for msg in run:
            by_key.setdefault(msg.key, []).append(msg)
            self.applied_parts[msg.process] += 1
            n_rows += msg.rows.size
            n_bytes += msg.nbytes
            if trc is not None and trc.sampled(msg.uid):
                # lifeline landing: joins the client's send_part on
                # (proc, uid).  Fresh parts only, so with sample=1.0 these
                # points reconcile exactly with sum(applied_parts).
                trc.point(trace_mod.EV_APPLY_PART, msg.process, msg.uid,
                          self.sid)
        t_apply = time.monotonic_ns() if trc is not None else 0
        # apply-lock wait: how long the dense blocks were contended (master
        # reads, snapshot cuts); one monotonic() pair per batch, only with
        # metrics or tracing on
        t_lock = time.monotonic() if (rt.metrics_on or trc is not None) \
            else 0.0
        with self.lock:
            if t_lock:
                dt_lock = time.monotonic() - t_lock
                if rt.metrics_on:
                    self.m_lock_wait += dt_lock
                if trc is not None and dt_lock > 1e-6:
                    trc.span(trace_mod.EV_LOCK_WAIT, int(t_lock * 1e9),
                             self.sid)
            self.m_rows_applied += n_rows
            self.m_bytes_applied += n_bytes
            A = self.part.A
            for key, msgs in by_key.items():
                dense = self.dense[key]
                if len(msgs) == 1:
                    if self.subscribers:
                        # the publish entry below keeps the part's arrays
                        # past this cycle: under the zero-copy wire they
                        # are views into the client's ring, valid only
                        # until the batch's pins are released
                        materialize_msg(msgs[0])
                    rows, delta = msgs[0].rows, msgs[0].delta
                else:
                    rows = np.concatenate([m.rows for m in msgs])
                    delta = np.concatenate([m.delta for m in msgs])
                local = rows // A
                # range check on the host, before the copy: the kernel's
                # wrapper would otherwise read it back from the card
                if local.size and (local.min() < 0
                                   or local.max() >= dense.shape[0]):
                    raise IndexError(
                        f"shard {self.sid} {key}: rows map to local "
                        f"[{local.min()}, {local.max()}], outside "
                        f"[0, {dense.shape[0]})")
                # synchronous copies from pageable host memory: the arrays
                # are free to be reused once these return.  Under the shm
                # zero-copy wire a single part's delta is a view into the
                # client's ring, and the batch's frame pins are released
                # right after this apply (_handle_batch): the copy must have
                # read every byte by then, so it stays synchronous — no
                # non_blocking=True and no pinned staging here.  torch.tensor
                # copies rather than shares (a pickle frame's arrays are
                # read-only views of the frame's bytes).
                idx = torch.from_numpy(local).to(dense.device)
                d = torch.tensor(np.ascontiguousarray(delta, dtype=np.float64),
                                 device=dense.device)
                if len(msgs) == 1 and dense.device.type == "cpu":
                    # rows are unique within one part: plain fancy-index add
                    dense[idx] += d
                else:
                    # rows may repeat across parts: accumulate duplicates in
                    # submission order (np.add.at order).  On the card every
                    # apply takes this kernel, which sorts the entries by row
                    # (stable) and walks each row's run in order; unique rows
                    # are runs of one, bitwise the same result.
                    apply_ops.scatter_add_(dense, idx, d, rows_checked=True,
                                           site=site)
                # serving: one coalesced delta per key per cycle per replica
                # (global rows, host arrays shared between the replicas,
                # which only read them)
                for rid in self.subscribers:
                    if rid not in self._stale_subs:
                        self._pub.setdefault(rid, []).append(
                            ReplicaDeltaMsg(self.sid, key, rows, delta,
                                            epoch=self.part.epoch))
            if self.wal is not None:
                # WAL append FIFO-behind the apply, inside the same lock
                # section so the log marks (parts/applied/max_ts) stay
                # consistent with the dense state a snapshot cuts.  The
                # frames are encoded to owned bytes here: under the shm
                # zero-copy wire the parts' arrays are views into the
                # client's ring, valid only until _handle_batch releases
                # the batch's frame pins.  They are written out at the
                # next clock-boundary group commit.
                t_wal = time.monotonic_ns() if trc is not None else 0
                self.wal.log_parts(run)
                if trc is not None:
                    trc.span(trace_mod.EV_WAL_APPEND, t_wal, self.sid,
                             len(run))
        if trc is not None:
            # the apply is done when its span ends: the launches above are
            # asynchronous on the card, so wait for the stream first
            if self.rt.device.type == "cuda":
                torch.cuda.current_stream(self.rt.device).synchronize()
            trc.span(trace_mod.EV_APPLY, t_apply, self.sid, len(run), n_rows)
        for msg in run:
            self._route_delivery(msg)

    def _route_delivery(self, msg: UpdateMsg) -> None:
        rt = self.rt
        if rt.n_proc == 1:
            # no peers to propagate to: the update is synchronized already
            if rt.policy.tracks_sync:
                materialize_msg(msg)
                self._send(rt._chan_sp[self.sid][msg.process],
                           FullyDelivered(msg.uid, msg.worker, msg.key,
                                          msg.rows, msg.delta, self.sid))
            return
        if self.queued[msg.key] or not controller.strong_delivery_gate(
                rt.policy, self.halfsync[msg.key][msg.rows], msg.delta):
            self.queued[msg.key].append(materialize_msg(msg))
            return
        self._start_delivery(msg)

    def _start_delivery(self, msg: UpdateMsg) -> None:
        rt = self.rt
        # the fan-out DeliverMsgs (and the VAP pending entry) outlive this
        # apply cycle
        materialize_msg(msg)
        # ack cycle feeds the unsynced accounting only (VAP value bound /
        # elastic norm bound)
        track = rt.policy.tracks_sync
        if track:
            hs = self.halfsync[msg.key]
            hs[msg.rows] += np.abs(msg.delta)
            if rt.check:
                mx = float(np.max(hs[msg.rows])) if msg.rows.size else 0.0
                with rt._slock:
                    rt.stats.max_halfsync_mag = max(
                        rt.stats.max_halfsync_mag, mx)
        hold = rt.policy.server_push_on_boundary
        n = 0
        for q in range(rt.n_proc):
            if q == msg.process:
                continue
            d = DeliverMsg(msg.uid, msg.worker, msg.process, self.sid,
                           msg.ts, msg.key, msg.rows, msg.delta)
            if hold:
                # ESSP: park until the next clock boundary, then one
                # coalesced batch per peer (see _flush_essp_hold)
                self._essp_hold.setdefault(q, []).append(d)
            else:
                self._send(rt._chan_sp[self.sid][q], d)
            n += 1
        with rt._slock:
            rt.stats.n_messages += n
            rt.stats.bytes_sent += msg.nbytes * n
        if track:
            self.pending[msg.uid] = (msg, n)

    def _flush_essp_hold(self) -> None:
        """ESSP server push: move every held delivery into the outbox, in
        apply order per destination.  Callers flush *before* emitting any
        marker that vouches for the held periods."""
        if not self._essp_hold:
            return
        hold, self._essp_hold = self._essp_hold, {}
        chans = self.rt._chan_sp[self.sid]
        for q, msgs in hold.items():
            for m in msgs:
                self._send(chans[q], m)

    def _ack_uid(self, uid: int) -> None:
        rt = self.rt
        msg, remaining = self.pending[uid]
        remaining -= 1
        if remaining > 0:
            self.pending[uid] = (msg, remaining)
            return
        del self.pending[uid]
        # exact subtraction: |delta| was added to halfsync verbatim at
        # _start_delivery, so the inverse is exact; the strong gate's own
        # > 1e-12 dead zone absorbs residue left by other interleavings
        hs = self.halfsync[msg.key]
        hs[msg.rows] -= np.abs(msg.delta)
        if rt.policy.tracks_sync:
            # the synchronized-update echo only feeds the unsynced
            # accounting (VAP / elastic)
            self._send(rt._chan_sp[self.sid][msg.process],
                       FullyDelivered(msg.uid, msg.worker, msg.key, msg.rows,
                                      msg.delta, self.sid))
        # freed half-sync budget: release queued deliveries for this key FIFO
        dq = self.queued.get(msg.key)
        while dq:
            nxt = dq[0]
            if controller.strong_delivery_gate(
                    rt.policy, self.halfsync[nxt.key][nxt.rows], nxt.delta):
                dq.popleft()
                self._start_delivery(nxt)
            else:
                break

    # ------------------------------------------------------- serving tier
    def _on_subscribe(self, msg: SubscribeMsg) -> None:
        """Register a replica publish channel; bootstrap in-stream.

        The state payload and the vc stamp are taken in the shard thread, so
        they form an exact cut: every delta published afterwards is FIFO
        behind them on this channel.  The bootstrap send is non-blocking
        like every publish: a subscriber whose (reused) edge is already
        wedged full starts out *stale* and gets its bootstrap from the
        resync path once the sink drains — the shard never stalls."""
        chan = msg.channel
        boot = (ReplicaStateMsg(self.sid, self.state(), self.vc_snapshot(),
                                epoch=self.part.epoch)
                if msg.want_state
                else ReplicaVcMsg(self.sid, self.vc_snapshot()))
        self.subscribers[msg.replica] = chan
        if self._publish_send(chan, [boot]):
            self._stale_subs = self._stale_subs - {msg.replica}
        else:
            self._stale_subs = self._stale_subs | {msg.replica}
            self.pub_drops += 1
            log.warning(
                "shard %d: replica %d subscribed on a wedged sink — "
                "bootstrap dropped, replica starts stale until the resync "
                "path gets through (epoch %d)", self.sid, msg.replica,
                self.part.epoch)

    def _on_unsubscribe(self, msg: UnsubscribeMsg) -> None:
        chan = self.subscribers.pop(msg.replica, None)
        self._stale_subs = self._stale_subs - {msg.replica}
        if chan is None:
            return
        # flush this replica's pending publishes FIFO-before the fin —
        # non-blocking: a wedged replica simply misses its fin (close()'s
        # fin wait is deadline-bounded) rather than stalling the shard
        msgs = self._pub.pop(msg.replica, [])
        msgs.append(ReplicaFinMsg(self.sid))
        if not self._publish_send(chan, msgs):
            self.pub_drops += 1

    def _publish_send(self, chan, msgs: list) -> bool:
        """Non-blocking publish where the wire supports it (module
        docstring); an in-process queue is unbounded and takes the send."""
        try_send = getattr(chan, "try_send_many", None)
        if try_send is None:
            chan.send_many(msgs)
            return True
        return try_send(msgs)

    def _try_resync(self, rid: int, chan) -> None:
        """Attempt the in-stream re-bootstrap of a stale replica: a fresh
        state + vc cut, exactly the subscribe path.  Skipped cheaply while
        the sink still lacks room for a state-sized frame."""
        if chan.room() < self.rt._state_frame_bytes:
            return
        if self._publish_send(chan, [ReplicaStateMsg(
                self.sid, self.state(), self.vc_snapshot(),
                epoch=self.part.epoch)]):
            self._stale_subs = self._stale_subs - {rid}
            self.pub_resyncs += 1
            log.info(
                "shard %d: replica %d resynced — in-stream re-bootstrap "
                "delivered after its sink drained (epoch %d, resyncs %d)",
                self.sid, rid, self.part.epoch, self.pub_resyncs)

    # --------------------------------------------------- clock boundaries
    def _flush_publish(self) -> None:
        """End of a batch: publish this cycle's coalesced deltas, plus a vc
        stamp if the applied frontier moved, to every subscribed replica
        (never blocking: a full sink marks the replica stale for
        drop-and-resync).  Then, if the frontier moved, the group commit of
        the WAL (pending delta frames + a vc stamp, FIFO on disk) and the
        runtime's periodic snapshot check (WAL-before-snapshot: the commit
        precedes any snapshot this boundary triggers)."""
        rt = self.rt
        trc = rt._trace if rt.trace_on else None
        vc_dirty, self._vc_dirty = self._vc_dirty, False
        if self.subscribers:
            t_pub = time.monotonic_ns() if trc is not None else 0
            self.m_last_publish = time.monotonic()
            stamp = self.vc_snapshot() if vc_dirty else None
            for rid, chan in self.subscribers.items():
                if rid in self._stale_subs:
                    self._pub.pop(rid, None)
                    self._try_resync(rid, chan)
                    continue
                msgs = self._pub.pop(rid, [])
                if stamp is not None:
                    msgs.append(ReplicaVcMsg(self.sid, stamp))
                if msgs and not self._publish_send(chan, msgs):
                    self._stale_subs = self._stale_subs | {rid}   # wedged:
                    self.pub_drops += 1         # drop now, resync later
                    log.warning(
                        "shard %d: replica %d publish sink full — marking "
                        "stale, dropping this cycle's deltas and retrying a "
                        "full re-bootstrap each cycle (epoch %d, drops so "
                        "far %d)", self.sid, rid, self.part.epoch,
                        self.pub_drops)
                elif trc is not None and msgs:
                    # publish lifeline: the send stamped the seqs, so the
                    # replica's ingest joins on (shard, replica, seq)
                    for m in msgs:
                        if (type(m) is ReplicaDeltaMsg
                                and trc.sampled(m.seq)):
                            trc.point(trace_mod.EV_PUBLISH_PART, self.sid,
                                      m.seq, rid)
            if trc is not None:
                stamp_min = int(stamp.min()) if stamp is not None else -1
                trc.span(trace_mod.EV_PUBLISH, t_pub, self.sid, stamp_min,
                         len(self.subscribers))
        elif self._pub:
            self._pub.clear()
        if not vc_dirty:
            return
        if self.wal is not None and self.part.owns(self.sid):
            vc = self.vc_snapshot()
            t_wal = time.monotonic_ns() if trc is not None else 0
            self.wal.commit(vc)
            if trc is not None:
                trc.span(trace_mod.EV_WAL_COMMIT, t_wal, self.sid,
                         int(vc.min()))
        self.rt._maybe_periodic_snapshot()

    def vc_snapshot(self) -> np.ndarray:
        """The applied per-process vector clock (consistent copy)."""
        with self.lock:
            return self.clock_vc.copy()

    def vc_if_active(self) -> Optional[np.ndarray]:
        """The applied vc, or None while this slot owns no rows (ownership
        and vc read under one lock)."""
        with self.lock:
            if not self.part.owns(self.sid):
                return None
            return self.clock_vc.copy()

    # ------------------------------------------------------------- row state
    def read_rows(self, key: str, out: np.ndarray) -> None:
        """Scatter this shard's live rows of `key` into the full (R, C) host
        buffer `out` (locked: safe against the apply loop mid-run)."""
        with self.lock:
            rows = self.part.rows_of(key, self.sid)
            if rows.size:
                out[rows] = self.dense[key].cpu().numpy()

    def state(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Snapshot payload: per key, global row ids + host copies of the
        dense values."""
        with self.lock:
            return self._state_locked()

    def device_cut(self) -> Dict[str, Tuple[np.ndarray, torch.Tensor]]:
        """The membership handoff: per key, the global row ids (host) and
        a clone of the block on the device, taken under the shard lock.
        The clone is queued on the current stream, behind every apply
        (the stream argument of :meth:`_state_locked`), so it holds the
        blocks as the applies under this lock left them; nothing is copied
        to the host."""
        with self.lock:
            return {key: (self.part.rows_of(key, self.sid).copy(),
                          self.dense[key].clone())
                    for key in self.dense}

    def _state_locked(self) -> Dict[str, Dict[str, np.ndarray]]:
        # The device-to-host copy runs on the current stream, which for
        # every thread of this process is the default stream: the same one
        # the apply's ps_apply launches went to.  So the copy waits for
        # every apply queued before it, and returns the blocks as the
        # applies under this lock left them.  Launching the applies on a
        # stream of their own would break that.
        return {key: {"rows": self.part.rows_of(key, self.sid).copy(),
                      "values": self.dense[key].to("cpu", copy=True).numpy()}
                for key in self.dense}

    def durability_cut(self):
        """``(state, vc, wal marks)`` under ONE lock acquisition.

        The WAL append in :meth:`_flush_updates` bumps the log marks in
        the same lock section as the dense apply, so a cut taken here is
        an exact per-slot log prefix: every part counted in ``marks`` is
        folded into ``state``, and none beyond.  That is what lets
        :func:`repro_torch.runtime.snapshot.recover_to_vc` skip replay of
        the covered prefix without double-applying or losing a part.
        """
        with self.lock:
            state = self._state_locked()
            vc = self.clock_vc.copy()
            marks = self.wal.marks() if self.wal is not None else None
        return state, vc, marks

    def load_state(self, state: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Adopt a payload taken by :meth:`state` (host to device)."""
        with self.lock:
            for key, part in state.items():
                mine = self.part.rows_of(key, self.sid)
                if (part["rows"].shape != mine.shape
                        or not np.array_equal(part["rows"], mine)):
                    raise ValueError(
                        f"snapshot rows for {key!r} do not match shard "
                        f"{self.sid}'s partition")
                if part["values"].shape != tuple(self.dense[key].shape):
                    raise ValueError(f"snapshot shape mismatch for {key!r}")
                self.dense[key].copy_(torch.from_numpy(
                    np.ascontiguousarray(part["values"], dtype=np.float64)))
