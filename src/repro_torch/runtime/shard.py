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
both implementations.

Multi-process quiesce: when the runtime runs with a wire transport, each
client sends :class:`ProcDoneMsg` after its last clock; once every process
is done and ``pending``/``queued``/ESSP-held deliveries have drained, the
shard broadcasts :class:`ShardFinMsg` (FIFO-after everything else it will
ever send), which is the client's signal that its inbound stream is
complete.  On the shm transport with the zero-copy wire, an update part's
``rows`` and ``delta`` are numpy views into the client's ring: the apply
copies them to the device before the batch's frame pins are released, and
anything retained past the batch is materialized first.

ESSP (eager server push, arXiv:1410.8043): under ``Policy("essp", ...)``
the shard parks each applied part's fan-out :class:`DeliverMsg`\\ s in a
per-destination hold instead of sending immediately, and releases the
whole hold — one coalesced batch per peer channel — whenever it processes a
client clock boundary.  Workers still gate on SSP's clock bound, but every
boundary pushes all applied deltas to all peers, so observed staleness
collapses well below s.
"""
from __future__ import annotations

import queue
import threading
from collections import defaultdict, deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import controller
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.runtime.messages import (SHUTDOWN, AckBatchMsg, Channel,
                                          ClockMarker, ClockMsg, DeliverMsg,
                                          FullyDelivered, ProcDoneMsg,
                                          ShardFinMsg, UpdateMsg,
                                          group_by_channel, pump_inbox)
from repro_torch.runtime.transport import (FifoAssert, materialize_msg,
                                           release_msgs)

_BATCH = 256        # max messages coalesced per apply/dispatch cycle


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

    The queue transport delivers exactly once, so the shard only records
    here; the tiers that redeliver (WAL replay, membership resends) arm the
    drop filter when they are ported.
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
        self.lock = threading.Lock()      # guards .dense
        self.part = rt.partition
        self.epoch = self.part.epoch
        # master state: one dense (n_owned_rows, C) float64 tensor per key on
        # the runtime's device, in partition order (global row r at local
        # index r // part.A), gathered from the canonical x0 on that device
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
        # zero-lost/zero-duplicated audit: update parts applied, per origin
        self.applied_parts = np.zeros(rt.n_proc, dtype=np.int64)
        self._dedup = UidDedup(rt.n_proc)
        # ESSP (eager server push): applied deltas held per destination and
        # released one coalesced batch per peer at every clock boundary
        self._essp_hold: Dict[int, List[DeliverMsg]] = {}
        # load counters: single-writer (this shard's thread), read racily.
        # proc_load maps pid -> (clock, counters) from the ClockMsg piggyback
        self.m_rows_applied = 0            # row-updates applied
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
        everything else in arrival order, flush sends per channel."""
        rt = self.rt
        shutdown = False
        done = 0
        run: List[UpdateMsg] = []
        for msg in batch:
            if msg is SHUTDOWN:
                shutdown = True
                break
            done += 1
            try:
                if rt.check:
                    err = self._fifo.check(msg.process, msg.seq)
                    if err:
                        rt._violation(f"FIFO violation: proc {msg.process}->"
                                      f"shard {self.sid} {err}")
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
        except BaseException as e:
            rt._record_error(e)
        # zero-copy discipline: every view consumed by the applies above is
        # done with, and everything retained (queued/pending/outbox) was
        # materialized — release the frame pins BEFORE the blocking outbox
        # writes.  Blocking on a full s->c ring while still pinning the c->s
        # ring would let two full rings deadlock each other (the client comm
        # thread observes the mirror-image rule).
        release_msgs(batch)
        self._flush_outbox()
        # in-flight decrements must come *after* the sends this batch caused
        # were enqueued (incrementing the counter), else the quiesce wait can
        # observe a transient 0 and shut down ahead of late deliveries
        for _ in range(done):
            rt._msg_done()
        return shutdown

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
        fully drained — nothing further will ever leave this shard."""
        rt = self.rt
        if (self._fin_sent or len(self._done_procs) < rt.n_proc
                or self.pending or any(self.queued.values())
                or self._essp_hold):
            return
        self._fin_sent = True
        for q in range(rt.n_proc):
            self._send(rt._chan_sp[self.sid][q], ShardFinMsg(self.sid))

    # --------------------------------------------------------------- updates
    def _flush_updates(self, run: List[UpdateMsg]) -> None:
        """Apply a run of update parts as one ordered scatter-add per key,
        then route each through the (per-message) delivery state machine."""
        if not run:
            return
        for m in run:                   # keeps the uid tables current
            self._dedup.fresh(m.uid, m.process, m.ts)
        by_key: Dict[str, List[UpdateMsg]] = {}
        n_rows = 0
        for msg in run:
            by_key.setdefault(msg.key, []).append(msg)
            self.applied_parts[msg.process] += 1
            n_rows += msg.rows.size
        with self.lock:
            self.m_rows_applied += n_rows
            A = self.part.A
            for key, msgs in by_key.items():
                dense = self.dense[key]
                if len(msgs) == 1:
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
                    apply_ops.scatter_add_(dense, idx, d, rows_checked=True)
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
            return {key: {"rows": self.part.rows_of(key, self.sid).copy(),
                          "values": self.dense[key].to(
                              "cpu", copy=True).numpy()}
                    for key in self.dense}

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
