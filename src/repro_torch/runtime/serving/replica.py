"""Read replicas of the PS serving tier, with their value buffers on the
device.

A :class:`ReplicaSet` holds N :class:`Replica` objects, each subscribed to
every master shard's publish stream over one of the serving transports:

  * ``queue`` — in-process FIFO :class:`~repro_torch.runtime.messages.Channel`
    edges (shard thread -> replica inbox);
  * ``shm``   — the shard writes pickle-5 frames into a single-producer
    shared-memory ring with a pipe doorbell, a reader thread drains it into
    the replica inbox (the :class:`~repro_torch.runtime.transport.ShmRing` /
    :class:`~repro_torch.runtime.transport.WireChannel` machinery of the
    runtime's wire; refuses weakly-ordered ISAs via
    :func:`~repro_torch.runtime.transport.require_tso`);
  * ``tcp``   — the same frames over a loopback socket per (shard, replica),
    queued by a :class:`~repro_torch.runtime.transport.TcpSendQueue` of the
    ring's capacity so the publish send never blocks.

Device.  A replica's value buffers are float64 tensors of each key's flat
``(R, C)`` shape on the runtime's device, like the shard masters.  Every
ingest of a :class:`ReplicaDeltaMsg` is an ordered scatter-add, which is
exactly ``ps_apply``'s function: a batch's deltas of one key (there may be
many, from every shard and cycle the ingest thread drained at once) land in
one :func:`repro_torch.kernels.ps_apply.ops.scatter_add_` call, in arrival
order, so on the card each key of a batch is one kernel launch, and on the
CPU the plain version gives bitwise the reference's per-message
``np.add.at``.  The gathered deltas are landed before any
:class:`ReplicaStateMsg` overwrites rows and before the replica lock is
released.  Rows the epoch filter drops (below) map to the kernel's sentinel
row ``R``, a no-op.  The in-stream bootstrap writes its rows with
``index_copy_``.  Every launch and copy runs on the current stream, which
for every thread of the process is the default stream, and :meth:`Replica.
serve` copies a buffer to the host on it under the replica lock: the copy
waits for every ingest queued before it.  Reads return host arrays.

Consistency accounting.  Each replica keeps a **per-shard vector clock**
``vc[s, p]`` — the highest period of client process ``p`` whose updates it
has applied for shard ``s``'s rows, adopted from the ``ReplicaVcMsg``
stamps the shard publishes FIFO-behind the deltas they cover.  The master's
authoritative frontier is the live per-shard applied vector clock
(:meth:`ServerShard.vc_if_active`), so a read's **measured staleness** is

    max over shards s, processes p of (master_vc[s, p] - replica_vc[s, p])

in clock units — 0 means the replica has applied everything the master
shards have.  The vc is host numpy.

Bootstrap.  A replica joining mid-run is seeded **in-stream**: the shard
answers its Subscribe with the current partition in the snapshot payload
format (:class:`ReplicaStateMsg`, copied off the device by
:meth:`ServerShard.state`), stamped with the shard's vc, before any further
delta on that channel, so the replica's view of that partition is exact
from the first frame.  Optionally the replica warm-starts from the
runtime's latest **periodic snapshot** (``snapshot_every``), assembled by
:func:`~repro_torch.runtime.snapshot.assemble_master` with the
:func:`~repro_torch.runtime.snapshot.conservative_vc` seed, so it can serve
honestly-stamped stale reads before the in-stream states arrive.

Membership.  The shards stamp every publish with their partition's epoch,
and a shard whose partition changed pushes an in-stream re-bootstrap (its
new partition, copied off the device, + vc) to every subscriber at
install.  ``Replica.row_epoch`` records, per row, the epoch of the last
state cut that covered it, so a late older-epoch delta for a migrated row
(already folded into the cut) lands on the kernel's sentinel row instead
of being counted twice.  After each completed op, :meth:`ReplicaSet.
_on_epoch` (a membership listener) subscribes every replica to the newly
active slots and unsubscribes it from the retired ones; a replica added
mid-run reads the active slots under the membership op lock.

Forks.  The wire transports fork the client processes at ``start()``, and
the parent must start no thread before that; a replica set starts ingest
and reader threads.  So on a wire-transport runtime a replica set is built
after ``start()`` (it raises before); on ``transport="queue"`` it may be
built before, and the shards answer its subscriptions when they start.
"""
from __future__ import annotations

import logging
import os
import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.runtime import snapshot as SNAP
from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime import transport as T
from repro_torch.runtime.messages import (SHUTDOWN, Channel, ReplicaDeltaMsg,
                                          ReplicaFinMsg, ReplicaStateMsg,
                                          ReplicaVcMsg, SubscribeMsg,
                                          UnsubscribeMsg, pump_inbox)

SERVING_TRANSPORTS = ("queue", "shm", "tcp")
# the name replica ingest's ps_apply launches count under (ps_apply's
# launches_by_site)
INGEST_SITE = "replica_ingest"

log = logging.getLogger("repro_torch.runtime.serving.replica")


class Replica:
    """One read replica: full-key value buffers on the device + a per-shard
    vector clock, fed by a comm thread draining the shard publish streams."""

    def __init__(self, rset: "ReplicaSet", rid: int,
                 seed_snapshot: Optional[dict] = None):
        rt = rset.rt
        self.rset = rset
        self.rid = rid
        self.lock = threading.Lock()        # guards values / vc / counters
        if seed_snapshot is not None:
            # warm start from a periodic snapshot: full values through the
            # snapshot module's re-partition path + a conservative vc seed
            host = SNAP.assemble_master(seed_snapshot)
            if set(host) != set(rt._x0):
                raise ValueError("bootstrap snapshot keys do not match "
                                 "the runtime's")
            self.vc = SNAP.conservative_vc(seed_snapshot, rt.n_slots,
                                           rt.n_proc)
        else:
            host = rt._x0
            # per-slot vector clock: inactive slots sit at -1 and the master
            # frontier never claims them
            self.vc = np.full((rt.n_slots, rt.n_proc), -1, dtype=np.int64)
        self.values: Dict[str, torch.Tensor] = {
            k: torch.tensor(np.asarray(host[k], dtype=np.float64),
                            device=rt.device) for k in rt._x0}
        # per-row membership epoch of the last state cut that covered the
        # row (-1 = genesis).  A cut at epoch e folds in every row a prior
        # owner applied before handing it off, so an older-epoch delta for
        # a cut row is a late frame racing the new owner's bootstrap:
        # applying it would double-count.
        self.row_epoch: Dict[str, np.ndarray] = {
            k: np.full(v.shape[0], -1, dtype=np.int64)
            for k, v in rt._x0.items()}
        self.inbox: queue.Queue = queue.Queue()
        self.fins: set = set()              # shards that acked unsubscribe
        self.poisoned = False               # ingest failed: out of rotation
        self.retired = False                # drained by remove_replica()
        self.reads = 0                      # served reads (routing cost)
        self.deltas_applied = 0
        self.bytes_ingested = 0
        self.stale_row_drops = 0            # old-epoch delta rows filtered
        self.ingest_applies = 0             # ps_apply calls (launches: at
                                            # INGEST_SITE, on the card)
        self._fifo = T.FifoAssert()         # per publishing shard
        self.thread = threading.Thread(target=self._loop,
                                       name=f"ps-replica-{rid}", daemon=True)

    # ------------------------------------------------------------ ingest
    def _loop(self) -> None:
        pump_inbox(self.inbox, self._handle_batch)

    def _handle_batch(self, batch: list) -> bool:
        rt = self.rset.rt
        trc = rt._trace if rt.trace_on else None
        t0 = time.monotonic_ns() if trc is not None else 0
        vc_moved = False
        shutdown = False
        n_handled = 0
        with self.lock:
            runs: Dict[str, Tuple[list, list]] = {}
            for msg in batch:
                if msg is SHUTDOWN:
                    shutdown = True
                    break
                try:
                    vc_moved |= self._handle(msg, runs, trc)
                    n_handled += 1
                except BaseException as e:
                    self._poison(e)
            try:
                self._land(runs)
            except BaseException as e:
                self._poison(e)
            if trc is not None and n_handled:
                # the ingest is done when its span ends: the launches are
                # asynchronous on the card
                if rt.device.type == "cuda":
                    torch.cuda.current_stream(rt.device).synchronize()
                trc.span(trace_mod.EV_INGEST, t0, self.rid, n_handled)
        if vc_moved:
            self.rset._notify()             # gateway doorbell
        return shutdown

    def _poison(self, e: BaseException) -> None:
        # a partially applied message breaks the vc invariant ("vc[p]=c =>
        # every update <= c applied"): take this replica out of the serving
        # rotation for good rather than stamping corrupt values as fresh
        self.poisoned = True
        log.warning("replica %d poisoned by ingest failure (%s: %s) — out "
                    "of the serving rotation for good",
                    self.rid, type(e).__name__, e)
        self.rset._record_error(e)

    def _handle(self, msg, runs: Dict[str, Tuple[list, list]],
                trc=None) -> bool:
        """Take one publish message; returns True if the vc moved.  Deltas
        are gathered into ``runs`` (landed by :meth:`_land`).  Caller holds
        ``self.lock``."""
        if self.rset.check:
            err = self._fifo.check(msg.shard, msg.seq)
            if err:
                self.rset._violation(
                    f"FIFO violation: shard {msg.shard}->replica "
                    f"{self.rid} {err}")
        if isinstance(msg, ReplicaDeltaMsg):
            if trc is not None and trc.sampled(msg.seq):
                # flow end of the publish lifeline started at the shard's
                # EV_PUBLISH_PART; sampled on seq so both ends agree
                trc.point(trace_mod.EV_INGEST_PART, msg.shard, msg.seq,
                          self.rid)
            buf = self.values[msg.key]
            R, C = buf.shape
            rows = np.asarray(msg.rows, dtype=np.int64)
            if msg.delta.shape != (rows.size, C):
                raise ValueError(f"replica {self.rid} {msg.key}: delta "
                                 f"{msg.delta.shape} for {rows.size} rows "
                                 f"of width {C}")
            if rows.size and (rows.min() < 0 or rows.max() >= R):
                raise IndexError(f"replica {self.rid} {msg.key}: rows span "
                                 f"[{rows.min()}, {rows.max()}], outside "
                                 f"[0, {R})")
            # rows may repeat across coalesced source parts: they accumulate
            # in order.  Rows whose last cut epoch is newer than the delta's
            # already contain it (row_epoch above): the sentinel row R
            # makes them no-ops.
            ok = self.row_epoch[msg.key][rows] <= msg.epoch
            if not ok.all():
                self.stale_row_drops += int(np.count_nonzero(~ok))
                rows = np.where(ok, rows, R)
            rows_l, delta_l = runs.setdefault(msg.key, ([], []))
            rows_l.append(rows)
            delta_l.append(msg.delta)
            self.deltas_applied += 1
            self.bytes_ingested += msg.nbytes
            return False
        if isinstance(msg, ReplicaVcMsg):
            np.maximum(self.vc[msg.shard], msg.clock_vc,
                       out=self.vc[msg.shard])
            if trc is not None:
                self._trace_vc(trc, msg.shard)
            return True
        if isinstance(msg, ReplicaStateMsg):
            # in-stream bootstrap: overwrite this shard's partition rows
            # wholesale (exact cut), adopt the stamped vc.  Deltas gathered
            # before it land first: the state supersedes them.
            self._land(runs)
            dev = self.rset.rt.device
            for key, part in msg.state.items():
                rows = np.asarray(part["rows"], dtype=np.int64)
                if rows.size:
                    self.values[key].index_copy_(
                        0, torch.tensor(rows, device=dev),
                        torch.tensor(np.asarray(part["values"],
                                                dtype=np.float64),
                                     device=dev))
                if msg.epoch >= 0:
                    self.row_epoch[key][rows] = msg.epoch
            np.maximum(self.vc[msg.shard], msg.clock_vc,
                       out=self.vc[msg.shard])
            if trc is not None:
                self._trace_vc(trc, msg.shard)
            return True
        if isinstance(msg, ReplicaFinMsg):
            self.fins.add(msg.shard)
            return True                     # wakes close()'s fin wait
        raise TypeError(f"replica {self.rid}: unexpected message {msg!r}")

    def _land(self, runs: Dict[str, Tuple[list, list]]) -> None:
        """Land each key's gathered deltas with one ordered scatter-add
        (``ps_apply``: one launch a key on the card), then clear them.
        Caller holds ``self.lock``."""
        for key, (rows_l, delta_l) in runs.items():
            buf = self.values[key]
            rows = np.concatenate(rows_l)
            if rows.size == 0 or buf.numel() == 0:
                continue
            # owned, contiguous host copies; the copies to the device are
            # synchronous from pageable memory
            delta = np.concatenate(delta_l).astype(np.float64, copy=False)
            apply_ops.scatter_add_(
                buf, torch.from_numpy(rows).to(buf.device),
                torch.from_numpy(delta).to(buf.device), rows_checked=True,
                site=INGEST_SITE)
            self.ingest_applies += 1
        runs.clear()

    def _trace_vc(self, trc, shard: int) -> None:
        """Record the measured master-replica staleness for one shard after
        a vc adoption (feeds ``staleness_timeline``).  Safe under
        ``self.lock``: ``master_vc`` takes shard locks and shard threads
        never take a replica's."""
        mvc = self.rset.master_vc()[shard]
        lag = max(int((mvc - self.vc[shard]).max()), 0)
        trc.point(trace_mod.EV_REPLICA_VC, self.rid, shard, lag)

    # ------------------------------------------------------------ serving
    def serve(self, key: str) -> Tuple[np.ndarray, np.ndarray]:
        """Copy-out read: (flat host value, vc at the moment of the copy).
        The device-to-host copy runs on the default stream behind every
        ingest queued before it."""
        with self.lock:
            self.reads += 1
            return (self.values[key].to("cpu", copy=True).numpy(),
                    self.vc.copy())


class ReplicaSet:
    """N read replicas subscribed to a :class:`PSRuntime`'s master shards.

    Lives in the runtime's parent process under every runtime transport
    (the shards always do too); the *serving* transport only picks the wire
    the publish stream rides on.  ``close()`` unsubscribes (the shard
    answers with a FIFO-last ``ReplicaFinMsg``), then tears the channels
    down — safe mid-run or after the runtime quiesced.
    """

    def __init__(self, rt, n_replicas: int = 2, transport: str = "queue",
                 check: bool = True, bootstrap_from_snapshot: bool = False,
                 ring_capacity: Optional[int] = None):
        if transport not in SERVING_TRANSPORTS:
            raise ValueError(f"unknown serving transport {transport!r}; "
                             f"choose from {SERVING_TRANSPORTS}")
        if transport == "shm":
            T.require_tso("the shm serving transport")
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        if rt._proc_mode and not rt._started:
            raise RuntimeError(
                f"a replica set starts threads, and the {rt.transport_kind} "
                f"transport forks its client processes at start(): build "
                f"the replica set (or gateway) after rt.start()")
        self.rt = rt
        self.transport = transport
        self.check = check
        self.cond = threading.Condition()   # doorbell: rings on vc advance
        self.version = 0                    # bumps with every ring (guards
        self.replicas: List[Replica] = []   # against missed wakeups)
        self.violations: List[str] = []
        self.errors: List[BaseException] = []
        self._vlock = threading.Lock()
        self._closing = False
        self._closed = False
        self._next_rid = 0
        # control edges into the shard slot inboxes (in-process by
        # construction)
        self._ctrl = [Channel(f"serve->s{s.sid}", s.inbox) for s in rt.shards]
        self._edges: Dict[Tuple[int, int], dict] = {}
        self._subscribed: Dict[int, set] = {}    # rid -> sids subscribed
        # sinks sized so a whole in-stream bootstrap state frame fits; an
        # explicit (small) capacity lets tests exercise the drop-and-resync
        # backpressure path deterministically
        state_bytes = sum(v.nbytes + 8 * v.shape[0] + 4096
                          for v in rt._x0.values())
        self._cap = (max(2 * state_bytes, int(ring_capacity))
                     if ring_capacity else max(1 << 20, 4 * state_bytes))
        for _ in range(n_replicas):
            self.add_replica(bootstrap_from_snapshot=bootstrap_from_snapshot)
        # elastic membership: after each completed epoch, subscribe every
        # replica to newly activated slots (their in-stream bootstrap makes
        # the migrated rows exact) and unsubscribe from retired ones
        rt.membership.add_listener(self._on_epoch)
        rt._replica_sets.append(self)        # unified metrics registry

    # -------------------------------------------------------------- plumbing
    def _notify(self) -> None:
        with self.cond:
            self.version += 1
            self.cond.notify_all()

    def _violation(self, text: str) -> None:
        with self._vlock:
            self.violations.append(text)

    def _record_error(self, e: BaseException) -> None:
        if self._closing:
            return                          # teardown races are expected
        with self._vlock:
            self.errors.append(e)

    # ------------------------------------------------------------- topology
    def add_replica(self, bootstrap_from_snapshot: bool = False) -> Replica:
        """Create a replica and subscribe it to every shard (mid-run safe).

        With ``bootstrap_from_snapshot`` the replica warm-starts from the
        runtime's latest periodic snapshot (``snapshot_every``) when one
        exists; the in-stream per-shard state it receives on subscribe then
        supersedes the snapshot partition by partition, so the final view
        is exact either way.
        """
        if self._closed:
            raise RuntimeError("replica set is closed")
        snap = self.rt.latest_snapshot() if bootstrap_from_snapshot else None
        rid = self._next_rid
        self._next_rid += 1
        rep = Replica(self, rid, seed_snapshot=snap)
        rep.thread.start()
        self._subscribed[rid] = set()
        # subscribe to the *active* slots of the current epoch; membership
        # changes later adjust via the _on_epoch listener
        with self.rt.membership.op_lock:
            active = self.rt.partition.active
        for sid in active:
            self._subscribe(rep, sid)
        self.replicas.append(rep)
        return rep

    def _subscribe(self, rep: Replica, sid: int) -> None:
        edge = self._edges.get((rep.rid, sid))
        chan = edge["chan"] if edge else self._make_channel(rep, sid)
        rep.fins.discard(sid)
        self._subscribed[rep.rid].add(sid)
        self.rt._send(self._ctrl[sid], SubscribeMsg(rep.rid, chan,
                                                    want_state=True))

    def remove_replica(self, rid: Optional[int] = None) -> Optional[Replica]:
        """Drain a replica out of the serving rotation (scale-down).  The
        replica is marked ``retired`` — the gateway stops routing to it
        immediately — and unsubscribed from every shard; its ingest thread
        keeps draining in-flight publishes until ``close()`` tears the
        edges down, so the shard side never blocks on it.  Picks the
        least-loaded live replica when ``rid`` is None; refuses to retire
        the last live one.  Returns the retired replica or None."""
        if self._closed:
            raise RuntimeError("replica set is closed")
        live = [r for r in self.replicas if not (r.retired or r.poisoned)]
        if len(live) <= 1:
            return None                     # never drain the whole tier
        if rid is None:
            rep = min(live, key=lambda r: r.reads)
        else:
            rep = next((r for r in live if r.rid == rid), None)
            if rep is None:
                return None
        rep.retired = True
        for sid in sorted(self._subscribed.get(rep.rid, set())):
            self._subscribed[rep.rid].discard(sid)
            self.rt._send(self._ctrl[sid], UnsubscribeMsg(rep.rid))
        self._notify()                      # wake parked readers to re-pick
        return rep

    @property
    def n_live(self) -> int:
        """Replicas currently in the serving rotation."""
        return sum(1 for r in self.replicas
                   if not (r.retired or r.poisoned))

    def _on_epoch(self, epoch: int, part, added: List[int],
                  removed: List[int]) -> None:
        """Membership listener: re-wire every replica's subscriptions.

        Newly activated slots bootstrap the replica in-stream (state + vc,
        FIFO-before any delta); continuing slots already pushed their own
        re-bootstrap at install, so only the added/removed edges change
        here.  Channels are kept across retire/re-activate cycles so the
        per-channel FIFO sequence stays continuous."""
        if self._closed:
            return
        for rep in self.replicas:
            if rep.retired:
                continue
            for sid in added:
                self._subscribe(rep, sid)
            for sid in removed:
                if sid in self._subscribed.get(rep.rid, ()):
                    self._subscribed[rep.rid].discard(sid)
                    self.rt._send(self._ctrl[sid], UnsubscribeMsg(rep.rid))

    @property
    def ring_bytes(self) -> int:
        """Capacity of every wire publish edge built so far (shm rings or
        tcp send queues; an shm ring's pages are touched as it fills)."""
        return self._cap * sum(1 for e in self._edges.values()
                               if e["kind"] != "queue")

    def _make_channel(self, rep: Replica, sid: int):
        """The shard->replica publish edge for the chosen transport.

        Wire-backed edges (shm/tcp) are built with a non-blocking
        ``try_write`` sink so the shard's publish path can drop-and-resync
        instead of stalling on a wedged replica, and with a ``pause`` event
        the fault-injection harness uses to wedge the replica's reader
        deliberately."""
        name = f"s{sid}->r{rep.rid}"
        if self.transport == "queue":
            chan = Channel(name, rep.inbox)
            self._edges[(rep.rid, sid)] = {"kind": "queue", "chan": chan}
            return chan
        pause = threading.Event()
        if self.transport == "shm":
            ring = T.ShmRing.create(self._cap)
            bell_r, bell_w = os.pipe()
            os.set_blocking(bell_w, False)
            stop = threading.Event()
            inner = T.ring_reader(ring, bell_r, stop)

            def read_chunk(inner=inner, pause=pause, stop=stop):
                while pause.is_set() and not stop.is_set():
                    time.sleep(0.005)          # wedged: stop draining
                return inner()

            reader = T.start_reader(f"rx-{name}", read_chunk,
                                    rep.inbox, self._record_error)
            chan = T.WireChannel(name, T.ring_writer(ring, bell_w),
                                 max_frame=self._cap // 2,
                                 try_write=T.try_ring_writer(ring, bell_w),
                                 room=ring.free_bytes)
            self._edges[(rep.rid, sid)] = {
                "kind": "shm", "ring": ring, "bell": (bell_r, bell_w),
                "stop": stop, "reader": reader, "chan": chan, "pause": pause}
            return chan
        # tcp: a real loopback socket per (shard, replica), fed by a send
        # queue of the ring's capacity
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        w_sock = socket.create_connection(lsock.getsockname(), timeout=30)
        r_sock, _ = lsock.accept()
        lsock.close()
        w_conn, r_conn = T.TcpConn(w_sock), T.TcpConn(r_sock)
        sendq = T.TcpSendQueue(w_conn, self._cap, f"tx-{name}",
                               self._record_error)
        inner_tcp = r_conn.read_chunk

        def read_chunk_tcp(inner=inner_tcp, pause=pause):
            while pause.is_set():
                time.sleep(0.005)
            return inner()

        reader = T.start_reader(f"rx-{name}", read_chunk_tcp,
                                rep.inbox, self._record_error)
        chan = T.WireChannel(name, sendq.write, try_write=sendq.try_write,
                             room=sendq.room)
        self._edges[(rep.rid, sid)] = {
            "kind": "tcp", "sendq": sendq, "r": r_conn, "reader": reader,
            "chan": chan, "pause": pause}
        return chan

    # -------------------------------------------------------- fault injection
    def wedge(self, rid: int, wedged: bool = True) -> None:
        """Deliberately stop (or resume) draining a replica's publish edges
        — the chaos harness's wedged-replica fault.  Only meaningful on the
        wire transports (an in-process queue edge is unbounded and cannot
        exert backpressure)."""
        for (r, _sid), edge in self._edges.items():
            if r == rid and "pause" in edge:
                if wedged:
                    edge["pause"].set()
                else:
                    edge["pause"].clear()

    @property
    def stale_replicas(self) -> set:
        """Replica ids currently marked stale by at least one shard (their
        next successful publish cycle re-bootstraps them in-stream)."""
        out = set()
        for s in self.rt.shards:
            out |= s._stale_subs
        return out

    @property
    def pub_drops(self) -> int:
        """Publish cycles dropped on a full sink (wedged replicas)."""
        return sum(s.pub_drops for s in self.rt.shards)

    @property
    def pub_resyncs(self) -> int:
        """Successful in-stream re-bootstraps of recovered replicas."""
        return sum(s.pub_resyncs for s in self.rt.shards)

    # ---------------------------------------------------------- vc plumbing
    def master_vc(self) -> np.ndarray:
        """The live per-slot applied vector clocks, stacked (n_slots, P).

        Each shard claims its row only while it owns rows (ownership and vc
        read under one lock); a slot owning none drops out at -1."""
        out = np.full((self.rt.n_slots, self.rt.n_proc), -1, dtype=np.int64)
        for s in self.rt.shards:
            vc = s.vc_if_active()
            if vc is not None:
                out[s.sid] = vc
        return out

    @staticmethod
    def staleness(replica_vc: np.ndarray, master_vc: np.ndarray) -> int:
        """Clocks the replica trails the master frontier (0 = caught up)."""
        return max(int((master_vc - replica_vc).max()), 0)

    # ------------------------------------------------------------- teardown
    def close(self, timeout: float = 10.0) -> None:
        """Unsubscribe every replica, wait for the shard fins, tear down."""
        if self._closed:
            return
        self._closed = True
        alive = {s.sid for s in self.rt.shards if s.thread.is_alive()}
        needs = {rep.rid: self._subscribed.get(rep.rid, set()) & alive
                 for rep in self.replicas}
        for rep in self.replicas:
            for sid in sorted(needs[rep.rid]):
                self.rt._send(self._ctrl[sid], UnsubscribeMsg(rep.rid))
        # fins are published FIFO-last: once they land, nothing further
        # will ever be written on the publish channels
        deadline = time.monotonic() + timeout
        with self.cond:
            while (any(not needs[rep.rid] <= rep.fins
                       for rep in self.replicas)
                   and time.monotonic() < deadline):
                self.cond.wait(0.25)
        self._closing = True
        for rep in self.replicas:
            rep.inbox.put(SHUTDOWN)
        for rep in self.replicas:
            rep.thread.join(timeout=5.0)
        for edge in self._edges.values():
            if "pause" in edge:
                edge["pause"].clear()       # unwedge so readers can exit
            if edge["kind"] == "shm":
                edge["stop"].set()
                T.ShmEdge.ring_bell(edge["bell"][1])
                edge["reader"].join(timeout=5.0)
                edge["ring"].close()
                edge["ring"].unlink()
                for fd in edge["bell"]:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
            elif edge["kind"] == "tcp":
                edge["sendq"].close()       # FIN ends the reader loop
                edge["reader"].join(timeout=5.0)
                edge["r"].close()
