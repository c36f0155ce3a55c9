"""Elastic shard membership: live re-partitioning of the PS runtime, with
the rows migrated on the device.

Shards can be added and removed **mid-run**, with the consistency bounds
(SSP clock bound, VAP value bound) holding across the migration, not just
after it — the transient divergence a live re-partition introduces is the
kind bounded-staleness SGD tolerates (*Elastic Consistency*, Nadiradze et
al., 2001.05918).

Slot model
----------
``PSRuntime(RuntimeConfig(n_shards=S, max_shards=M))`` provisions ``M``
shard *slots* at construction — shard objects, threads, and channels (for
every transport: in-process queues, shm rings, tcp loopback) all exist up
front, but only ``S`` slots are *active* in epoch 0.  Pre-provisioning is
what makes elasticity transport-uniform: forked clients inherit shm
mappings and tcp connections that cannot be created after the fork, while
activation and retirement are pure control-plane events.  An inactive
slot's master blocks are ``(0, C)`` float64 tensors on the runtime's
device.  Retired slots keep their threads and channels until quiesce so
in-flight deliveries and acks drain naturally.

Epoch protocol (one membership op = one epoch bump)
---------------------------------------------------
Shards always live in the parent process, beside their master blocks on
the device, so row migration never crosses the wire — only the epoch
*barrier* involves clients:

1. **Begin** — the manager enqueues ``EpochBeginMsg(epoch, part)`` to every
   involved shard slot (old ∪ new active), then announces
   ``EpochMsg(epoch, active)`` to every client over a designated active
   shard's FIFO channel.
2. **Swap + ack** — each client process, on receiving the announce, swaps
   its key->shard router atomically w.r.t. its own sends (a short
   ``route_lock`` critical section excludes in-flight flushes; routing is
   deferred to flush time so an SSP outbox filled under epoch e but flushed
   after the swap routes by e+1), then sends ``EpochAckMsg`` on every
   involved channel.  Channel FIFO makes the ack a barrier: no epoch-e
   update can follow it.
3. **Cut + handoff** — a shard active in epoch e that has collected acks
   from *every* client process will never see another epoch-e update; it
   hands the manager its blocks as ``(rows, values)`` per key — the global
   row ids on the host, and a device clone of the block taken under the
   shard lock, on the stream every apply went to, so the clone follows
   every queued apply — plus its applied vector clock.  A *retiring* slot
   additionally seals its write-ahead log segment at the cut and broadcasts
   ``ClockMarker(clock=INF)`` to every client — FIFO-behind all deliveries
   it ever sent — so it stops constraining the clock frontier exactly when
   its stream is complete.
4. **Install** — the manager reassembles the master on the device
   (:func:`assemble_on_device`: one ``(R, C)`` float64 tensor per key
   filled by ``index_copy_`` from every contributor, the contributors' row
   counts checked on the host to cover ``R`` exactly), gathers each
   new-active slot's rows with ``index_select`` and installs them with a
   conservative vector-clock seed (element-wise min over contributors, host
   numpy).  These are pure copies, so the blocks are bitwise what the
   reference's host reassembly installs, and no master block passes
   through the host.  New-active slots install first, retirees disclaim
   last, so at every instant at least one shard's applied vc vouches for
   every applied update (the serving tier's staleness measurement stays
   conservative mid-migration).
5. **Replay** — updates/clocks stamped with the *next* epoch that raced
   ahead of the install were held FIFO at the shard; they replay through
   the normal apply/publish path — on the card through ``ps_apply`` into
   blocks whose local index is ``row // A`` for the new ``A``, counted
   under the launch site ``"epoch_replay"`` — then the shard broadcasts
   *seeded* clock markers from its post-replay vc so clients' frontiers
   unblock (install happens only after every client acked, i.e. swapped —
   a seeded marker can never overtake its receiver's swap).

During the (short) freeze the clock-bound gate simply blocks — the same
mechanism that absorbs a straggler absorbs the migration — and the value
bound is untouched because delivery/ack accounting is key-global, not
partition-local.  No update is lost or double-applied: epoch-e updates are
applied by their epoch-e owner and included in the handoff; epoch-e+1
updates are held and replayed by their e+1 owner; the per-process counter
audit in ``PSRuntime._final_checks`` asserts exactly this.

Serving tier: the manager notifies listeners after install; the
:class:`~repro_torch.runtime.serving.replica.ReplicaSet` re-subscribes
every replica to newly-active slots (the shard answers with an in-stream
re-bootstrap: its partition copied to the host + vc stamp, FIFO-before
subsequent deltas) and unsubscribes retired ones.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime.messages import (Channel, EpochBeginMsg, EpochMsg,
                                          InstallMsg)

log = logging.getLogger("repro_torch.runtime.membership")

# "infinitely caught up": a retired slot's frontier contribution
INF_CLOCK = 1 << 60

_EMPTY_ROWS = np.empty(0, dtype=np.int64)


class Partition:
    """Epoch-stamped ownership map: row ``r`` of every key is owned by
    ``active[r % len(active)]`` and stored at local index ``r // len(active)``
    in the owner's dense block.

    Immutable; built deterministically from ``(epoch, active, row_counts)``
    so a forked client can reconstruct the parent's partition from the
    ``(epoch, active)`` pair an :class:`EpochMsg` carries.
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

    def owns(self, sid: int) -> bool:
        """Whether slot ``sid`` owns rows in this epoch."""
        return sid in self._index

    def rows_of(self, key: str, sid: int) -> np.ndarray:
        """Global row ids of ``key`` owned by slot ``sid`` (empty if the
        slot is inactive in this epoch)."""
        i = self._index.get(sid)
        if i is None:
            return _EMPTY_ROWS
        return self._rows[key][i]

    def __repr__(self) -> str:
        return f"Partition(epoch={self.epoch}, active={self.active})"


def assemble_on_device(handoffs: Sequence[Dict[str, tuple]],
                       shapes: Dict[str, Tuple[int, int]],
                       device) -> Dict[str, torch.Tensor]:
    """Reassemble the full flat ``(R, C)`` float64 master per key on
    ``device`` from the handoffs ``{key: (rows, values)}`` of every
    old-active slot (``rows``: host int64 global ids; ``values``: the
    slot's block, a tensor on ``device``).

    The device counterpart of :func:`repro_torch.runtime.snapshot.
    assemble_master`, and bitwise the same result: a zero buffer filled by
    ``index_copy_`` from every contributor.  The contributors' row counts
    must cover ``R`` exactly, checked on the host; a shortfall raises as
    ``assemble_master`` does for an incomplete snapshot."""
    out: Dict[str, torch.Tensor] = {}
    for key, (R, C) in shapes.items():
        full = torch.zeros((R, C), dtype=torch.float64, device=device)
        seen = 0
        for h in handoffs:
            rows, values = h[key]
            if rows.size:
                full.index_copy_(0, torch.from_numpy(rows).to(device),
                                 values)
            seen += int(rows.size)
        if seen != R:
            raise ValueError(f"membership handoff incomplete for {key!r}: "
                             f"{seen}/{R} rows")
        out[key] = full
    return out


@dataclass
class MembershipEvent:
    """One scripted membership change, fired when the global completed-clock
    frontier reaches ``clock``.  ``op`` is ``"add"`` (sid optional: the
    lowest free slot) or ``"remove"`` (sid required)."""
    clock: int
    op: str
    sid: Optional[int] = None


@dataclass
class MembershipPlan:
    """A scriptable schedule of membership events for tests and benches —
    pass as ``RuntimeConfig(membership_plan=...)``; a driver thread fires
    each event at its clock boundary.  ``results`` records ``(event,
    outcome)`` pairs; events unreachable because the run ended first are
    ``"skipped"``."""
    events: List[MembershipEvent] = field(default_factory=list)
    results: List[Tuple[MembershipEvent, str]] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: Sequence[Tuple[int, str, Optional[int]]]
              ) -> "MembershipPlan":
        """From ``[(clock, "add"|"remove", sid_or_None), ...]``."""
        evs = [MembershipEvent(c, op, sid) for c, op, sid in spec]
        return cls(sorted(evs, key=lambda e: e.clock))


class MembershipManager:
    """Parent-side coordinator of the epoch protocol (module docstring).

    ``op_lock`` (re-entrant) serializes membership ops and is the
    synchronization point for whole-master readers: ``master_value`` and
    ``take_snapshot`` hold it so they never observe a half-installed
    partition; the shard-thread periodic-snapshot path acquires it
    non-blocking and skips a cycle instead of deadlocking against an
    in-flight install.

    ``log`` holds ``(epoch, active)`` per completed op, ``ops`` one dict
    per completed op with its host-side walls (from the first
    ``EpochBeginMsg`` to the last handoff, the reassembly and install
    enqueue, the install confirms) and the device bytes it copied (the
    handoff clones, the reassembled master, the installed blocks).
    """

    def __init__(self, rt):
        self.rt = rt
        self.inbox: queue.Queue = queue.Queue()   # shard -> manager
        self.op_lock = threading.RLock()
        self.log: List[Tuple[int, Tuple[int, ...]]] = []   # (epoch, active)
        self.ops: List[dict] = []
        self._listeners: List[Callable] = []
        self._ctrl = [Channel(f"mm->s{s.sid}", s.inbox) for s in rt.shards]
        self._plan_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- listeners
    def add_listener(self, fn: Callable) -> None:
        """``fn(epoch, partition, added_sids, removed_sids)`` after each
        completed op (called on the op thread, after install everywhere)."""
        self._listeners.append(fn)

    # ------------------------------------------------------------------ ops
    def add_shard(self, sid: Optional[int] = None,
                  timeout: float = 30.0) -> int:
        """Activate a dormant slot mid-run; returns its sid.  Blocks until
        the epoch is installed everywhere (rows migrated, clients swapped)."""
        with self.op_lock:
            old = self.rt.partition
            free = [s for s in range(self.rt.n_slots) if not old.owns(s)]
            if sid is None:
                if not free:
                    raise ValueError(
                        f"no free shard slot (all {self.rt.n_slots} active); "
                        "construct the runtime with a larger max_shards")
                sid = free[0]
            elif old.owns(sid):
                raise ValueError(f"shard slot {sid} is already active")
            elif not 0 <= sid < self.rt.n_slots:
                raise ValueError(f"shard slot {sid} out of range "
                                 f"(0..{self.rt.n_slots - 1})")
            self._run_op(tuple(sorted(old.active + (sid,))), timeout)
            return sid

    def remove_shard(self, sid: int, timeout: float = 30.0) -> None:
        """Retire an active slot mid-run: its rows migrate to the survivors
        on the device."""
        with self.op_lock:
            old = self.rt.partition
            if not old.owns(sid):
                raise ValueError(f"shard slot {sid} is not active")
            if old.A == 1:
                raise ValueError("cannot remove the last active shard")
            self._run_op(tuple(s for s in old.active if s != sid), timeout)

    def _run_op(self, new_active: Tuple[int, ...], timeout: float) -> None:
        rt = self.rt
        if not rt._started or rt._finished:
            raise RuntimeError("membership ops require a running runtime")
        t0 = time.monotonic()
        deadline = t0 + timeout
        old = rt.partition
        epoch = old.epoch + 1
        part = Partition(epoch, new_active, rt._row_counts)
        involved = sorted(set(old.active) | set(new_active))
        added = [s for s in new_active if not old.owns(s)]
        removed = [s for s in old.active if not part.owns(s)]

        # 1) shards learn the pending epoch (enqueued before any client ack
        #    can arrive, so each shard processes Begin first)
        for sid in involved:
            rt._send(self._ctrl[sid], EpochBeginMsg(epoch, part))
        # 2) announce to every client over a surviving active shard's FIFO
        #    channel (the channel lock makes the parent-side send safe
        #    alongside the shard thread's own sends)
        leader = min(set(old.active) & set(new_active), default=old.active[0])
        for p in range(rt.n_proc):
            rt._send(rt._chan_sp[leader][p],
                     EpochMsg(epoch, part.active, shard=leader))
        # 3) every old-active shard cuts once all clients acked and hands
        #    off (rows, device clone) per key + its applied vector clock
        handoffs: Dict[int, dict] = {}
        vcs: Dict[int, np.ndarray] = {}
        want = set(old.active)
        while set(handoffs) < want:
            kind, sid, payload = self._next_msg(deadline, f"handoff {want}")
            if kind == "handoff" and sid in want:
                handoffs[sid], vcs[sid] = payload
        t_cut = time.monotonic()
        # 4) reassemble on the device and install: new-active slots first,
        #    retirees disclaim last, so every applied update is vouched for
        #    by some shard's vc at all times.  The copies run on the stream
        #    the shards apply on, so each slot's first apply follows them.
        shapes = {key: (r, rt._x0[key].shape[1])
                  for key, r in rt._row_counts.items()}
        master = assemble_on_device([handoffs[s] for s in old.active],
                                    shapes, rt.device)
        handoff_bytes = sum(int(v.nbytes) for h in handoffs.values()
                            for _, v in h.values())
        del handoffs
        seed_vc = np.min(np.stack([vcs[s] for s in old.active]), axis=0)
        install_bytes = 0
        for sid in new_active:
            blocks = {key: full.index_select(0, torch.from_numpy(
                part.rows_of(key, sid)).to(rt.device))
                for key, full in master.items()}
            install_bytes += sum(int(b.nbytes) for b in blocks.values())
            rt._send(self._ctrl[sid], InstallMsg(epoch, part, blocks,
                                                 seed_vc.copy()))
        master_bytes = sum(int(v.nbytes) for v in master.values())
        del master, blocks
        t_enq = time.monotonic()
        self._await_installs(set(new_active), epoch, deadline)
        for sid in removed:
            rt._send(self._ctrl[sid], InstallMsg(epoch, part, None,
                                                 seed_vc.copy()))
        self._await_installs(set(removed), epoch, deadline)
        rt.partition = part
        self.log.append((epoch, part.active))
        t_done = time.monotonic()
        self.ops.append({
            "epoch": epoch, "active": part.active, "added": added,
            "removed": removed, "wall_s": t_done - t0,
            "handoff_s": t_cut - t0, "migrate_s": t_enq - t_cut,
            "install_s": t_done - t_enq, "handoff_bytes": handoff_bytes,
            "master_bytes": master_bytes, "install_bytes": install_bytes})
        if rt.trace_on:
            rt._trace.point(trace_mod.EV_EPOCH, epoch, part.A)
        # durability tier: retiring slots already sealed their WAL segments
        # shard-side at the cut (step 3, stamped with their final vc); the
        # runtime hook just records the per-slot log positions of this cut
        rt._wal_on_epoch(epoch, added, removed)
        for fn in self._listeners:
            fn(epoch, part, added, removed)

    def _next_msg(self, deadline: float, what: str):
        budget = deadline - time.monotonic()
        try:
            if budget <= 0:
                raise queue.Empty
            return self.inbox.get(timeout=budget)
        except queue.Empty:
            log.warning("membership op timed out waiting for %s "
                        "(epoch %d active)", what, self.rt.partition.epoch)
            raise RuntimeError(
                f"membership op timed out waiting for {what}") from None

    def _await_installs(self, sids: set, epoch: int, deadline: float) -> None:
        done: set = set()
        while done < sids:
            kind, sid, payload = self._next_msg(
                deadline, f"install confirms {sids - done}")
            if kind == "installed" and payload == epoch:
                done.add(sid)

    # ------------------------------------------------------------------ plan
    def start_plan(self, plan: MembershipPlan) -> None:
        """Launch the scripted-membership driver (called from start())."""
        self._plan_thread = threading.Thread(
            target=self._drive_plan, args=(plan,), name="ps-membership-plan",
            daemon=True)
        self._plan_thread.start()

    def _drive_plan(self, plan: MembershipPlan) -> None:
        rt = self.rt
        for ev in plan.events:
            while rt.completed_clock() < ev.clock:
                if not rt.running:
                    plan.results.append((ev, "skipped"))
                    break
                time.sleep(0.01)
            else:
                try:
                    if ev.op == "add":
                        self.add_shard(ev.sid)
                    elif ev.op == "remove":
                        self.remove_shard(ev.sid)
                    else:
                        raise ValueError(f"unknown membership op {ev.op!r}")
                    plan.results.append((ev, "ok"))
                except BaseException as e:
                    log.warning("scripted membership op %s(sid=%s) at clock "
                                "%d failed: %r — plan driver stopping",
                                ev.op, ev.sid, ev.clock, e)
                    plan.results.append((ev, f"error: {e!r}"))
                    rt._record_error(e)
                    return

    def finish_plan(self, timeout: float) -> None:
        if self._plan_thread is not None:
            self._plan_thread.join(timeout=max(0.1, timeout))
