"""Unified runtime metrics: one typed read surface over every counter of
the PS runtime.

    m = rt.metrics()            # -> RuntimeMetrics (plain dataclass tree)
    m.shards[0].updates_per_s   # windowed apply rate of shard slot 0
    m.shard_imbalance()         # max/mean load across active shards

It folds ``RunStats`` (client-side update/block counters), the per-shard
load counters (parts, rows and bytes applied, the dense-lock wait), the
per-process load counters, the snapshot counters, the write-ahead log's
counters and the serving tier's (every registered replica set's replicas
and every gateway's read counters, the shards' publish backpressure) into
one tree, with the membership epoch, its active slots and the number of
completed membership ops (``MembershipMetrics``), and each slot's epoch.

Collection discipline (the "low-overhead" contract):

  * every hot-path counter is **single-writer**: owned by exactly one
    thread (the shard thread, one worker's ClientProcess under its cond,
    one replica's ingest thread) and bumped without any new lock;
  * the collector reads them **racily** — int/float loads are atomic under
    the GIL, and a slightly torn view across counters only wobbles a rate
    estimate, never the correctness audits (which run on the quiesced
    state);
  * client processes snapshot their counters **at clock boundaries** and
    piggyback them on the :class:`~repro_torch.runtime.messages.ClockMsg`
    they already send (``ClockMsg.load``), so with forked clients the load
    data rides the existing wire — no side channel, no extra wakeups;
  * rates are computed by :class:`MetricsHub` against the previous
    ``collect()`` call's snapshot (first call: since runtime start).

Every counter here is host state: reading the metrics never touches the
device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# indices of the ClockMsg.load counter vector (one float64 per slot; the
# array is tiny and rides the already-pickled control message)
LOAD_UPDATES = 0          # Incs applied by this process so far
LOAD_BLOCK_CLOCK = 1      # cumulative seconds blocked in the clock gate
LOAD_BLOCK_VALUE = 2      # cumulative seconds blocked in the value gate
LOAD_LEN = 3


@dataclass
class ShardMetrics:
    """One shard slot's load and publish health."""
    sid: int
    active: bool                  # owns rows under the current partition
    epoch: int                    # membership epoch the slot last adopted
    inbox_depth: int              # channel depth: messages queued, unread
    parts_applied: int            # update parts applied (audit counter)
    rows_applied: int             # row-updates applied (vectorized adds)
    bytes_applied: int            # delta bytes applied to the dense blocks
    apply_lock_wait_s: float      # cumulative wait for the dense-block lock
    applied_parts: List[int]      # per origin process (audit counter)
    clock_min: int                # min applied vc entry (-1 before clock 1)
    pub_pending: int              # publish messages coalesced, not yet sent
    pub_drops: int                # publish cycles dropped on a full sink
    pub_resyncs: int              # successful in-stream re-bootstraps
    publish_lag_s: float          # age of the oldest unpublished cycle
    updates_per_s: float = 0.0    # windowed: parts applied / s
    rows_per_s: float = 0.0       # windowed: row-updates applied / s
    # durability tier (repro_torch.runtime.wal) — zeros when wal_dir is unset
    wal_parts: int = 0            # update parts logged (pending + written)
    wal_commits: int = 0          # group commits (clock boundaries hit)
    wal_bytes: int = 0            # bytes written to segment files
    wal_segments: int = 0         # segment files opened by this writer
    wal_fsync_s: float = 0.0      # cumulative fsync time (policy cost)
    wal_append_lag_s: float = 0.0 # age of the oldest uncommitted frame


@dataclass
class ProcessMetrics:
    """One client process's load, snapshotted at its last clock boundary
    and shipped on the ClockMsg it already sends (proc mode: over the
    wire; queue mode: over the in-process channels — same path)."""
    process: int
    clock: int                    # boundary the snapshot was taken at
    n_updates: int
    block_time_clock: float
    block_time_value: float
    updates_per_s: float = 0.0    # windowed


@dataclass
class ReplicaMetrics:
    rid: int
    staleness: int                # clocks behind the live master frontier
    reads: int
    deltas_applied: int
    bytes_ingested: int
    poisoned: bool
    stale: bool                   # marked for drop-and-resync by a shard


@dataclass
class GatewayMetrics:
    n_reads: int
    n_replica_reads: int
    n_master_reads: int
    n_escalations: int
    n_shed: int                   # fresh reads refused by admission control
    n_cache_hits: int             # served from the gateway read cache
    reads_by_slo: Dict[str, int]  # per-SLO read counts ("0", "3", "any", ...)
    max_served_staleness: int
    block_time: float
    reads_per_replica: Dict[int, int]
    shedding_fresh: bool          # admission control currently engaged
    n_live_replicas: int = 0      # replicas in the serving rotation
    reads_per_s: float = 0.0      # windowed
    escalations_per_s: float = 0.0
    escalation_rate: float = 0.0  # windowed escalations / reads (SLO misses
                                  # that had to fall back to the master)


@dataclass
class MembershipMetrics:
    epoch: int
    active: Tuple[int, ...]
    n_slots: int
    n_ops: int                    # completed add/remove operations


@dataclass
class SnapshotMetrics:
    n_snapshots: int
    snapshot_every: int
    last_clock: int               # frontier of the latest snapshot (or -1)


@dataclass
class RunMetrics:
    """The client-side RunStats counters, unified.  In proc mode the
    mid-run values come from the ClockMsg load piggyback (the children own
    their RunStats until wait() merges them)."""
    n_updates: int
    n_messages: int
    bytes_sent: int
    n_ack_msgs: int
    n_acked_updates: int
    block_time_clock: float
    block_time_value: float
    max_observed_staleness: int
    max_unsynced_mag: float
    max_update_mag: float
    max_halfsync_mag: float
    n_violations: int


@dataclass
class RuntimeMetrics:
    """One consistent-enough snapshot of everything the runtime measures.

    ``shards``/``processes`` always populate; ``replicas``/``gateways``
    only when a serving tier is attached to this runtime."""
    t: float                      # monotonic collection timestamp
    wall_s: float                 # seconds since rt.start()
    window_s: float               # rate window (since previous collect())
    clock: int                    # global applied-clock frontier
    transport: str
    metrics_enabled: bool
    run: RunMetrics
    membership: MembershipMetrics
    snapshots: SnapshotMetrics
    shards: List[ShardMetrics] = field(default_factory=list)
    processes: List[ProcessMetrics] = field(default_factory=list)
    replicas: List[ReplicaMetrics] = field(default_factory=list)
    gateways: List[GatewayMetrics] = field(default_factory=list)
    # tracing tier (repro_torch.runtime.trace): whether sampled event
    # tracing is on, and how many events the bounded rings have dropped so
    # far (0 is the healthy steady state; a growing count means the rings
    # are undersized for the sample rate)
    trace_enabled: bool = False
    trace_dropped: int = 0

    # ------------------------------------------------------------- derived
    def active_shards(self) -> List[ShardMetrics]:
        return [s for s in self.shards if s.active]

    def total_updates_per_s(self) -> float:
        return sum(s.updates_per_s for s in self.shards)

    def shard_imbalance(self) -> float:
        """max/mean windowed load across active shards (1.0 = balanced;
        the autoscaler's split trigger)."""
        rates = [s.rows_per_s for s in self.active_shards()]
        if not rates:
            return 1.0
        mean = sum(rates) / len(rates)
        if mean <= 0.0:
            return 1.0
        return max(rates) / mean

    def hottest_shard(self) -> Optional[ShardMetrics]:
        act = self.active_shards()
        return max(act, key=lambda s: s.rows_per_s) if act else None

    def coldest_shard(self) -> Optional[ShardMetrics]:
        act = self.active_shards()
        return min(act, key=lambda s: s.rows_per_s) if act else None


def slo_key(slo) -> str:
    """Bucket label for the per-SLO read counters ("fresh", "any", "0",
    "1", ...)."""
    if slo is None:
        return "any"
    if isinstance(slo, str):
        return slo
    return str(int(slo))


class MetricsHub:
    """Collects :class:`RuntimeMetrics` from a live runtime and computes
    windowed rates against its previous collection.  One hub per runtime
    (``rt.metrics()`` delegates here); creating extra hubs is fine — each
    keeps its own rate window."""

    def __init__(self, rt):
        self.rt = rt
        self._prev_t: Optional[float] = None
        # sid -> (parts, rows); pid -> n_updates; gateway -> (reads, esc)
        self._prev_shard: Dict[int, Tuple[int, int]] = {}
        self._prev_proc: Dict[int, int] = {}
        self._prev_gw: Dict[int, Tuple[int, int]] = {}

    # ---------------------------------------------------------------- parts
    def _collect_run(self, loads: Dict[int, Tuple[int, np.ndarray]]
                     ) -> RunMetrics:
        rt = self.rt
        st = rt.stats
        n_updates = st.n_updates
        block_c = st.block_time_clock
        block_v = st.block_time_value
        if loads:
            # proc mode mid-run: the children own their RunStats; the
            # piggybacked boundary snapshots are the live view.  max():
            # after wait() merged the finals, stats dominates the (older)
            # boundary snapshots.
            n_updates = max(n_updates,
                            int(sum(v[1][LOAD_UPDATES]
                                    for v in loads.values())))
            block_c = max(block_c, float(sum(v[1][LOAD_BLOCK_CLOCK]
                                             for v in loads.values())))
            block_v = max(block_v, float(sum(v[1][LOAD_BLOCK_VALUE]
                                             for v in loads.values())))
        return RunMetrics(
            n_updates=n_updates,
            n_messages=st.n_messages,
            bytes_sent=st.bytes_sent,
            n_ack_msgs=st.n_ack_msgs,
            n_acked_updates=st.n_acked_updates,
            block_time_clock=block_c,
            block_time_value=block_v,
            max_observed_staleness=st.max_observed_staleness,
            max_unsynced_mag=st.max_unsynced_mag,
            max_update_mag=st.max_update_mag,
            max_halfsync_mag=st.max_halfsync_mag,
            n_violations=len(st.violations),
        )

    def _collect_shard(self, s, now: float, dt: float) -> ShardMetrics:
        w = s.wal
        parts = int(s.applied_parts.sum())
        rows = int(s.m_rows_applied)
        with s.lock:
            active = s.part.owns(s.sid)
            clock_min = int(s.clock_vc.min())
        try:
            pending = sum(len(v) for v in s._pub.values())
        except RuntimeError:                   # racy dict resize: skip once
            pending = 0
        last_pub = s.m_last_publish
        lag = max(0.0, now - last_pub) if (pending and last_pub) else 0.0
        prev_parts, prev_rows = self._prev_shard.get(s.sid, (0, 0))
        self._prev_shard[s.sid] = (parts, rows)
        return ShardMetrics(
            sid=s.sid,
            active=active,
            epoch=s.epoch,
            inbox_depth=s.inbox.qsize(),
            parts_applied=parts,
            rows_applied=rows,
            bytes_applied=int(s.m_bytes_applied),
            apply_lock_wait_s=float(s.m_lock_wait),
            applied_parts=[int(x) for x in s.applied_parts],
            clock_min=clock_min,
            pub_pending=pending,
            pub_drops=s.pub_drops,
            pub_resyncs=s.pub_resyncs,
            publish_lag_s=lag,
            updates_per_s=max(0, parts - prev_parts) / dt,
            rows_per_s=max(0, rows - prev_rows) / dt,
            # wal counters: single-writer (the shard thread), racy reads
            # here exactly like the other shard counters
            wal_parts=int(w.parts) if w is not None else 0,
            wal_commits=int(w.m_commits) if w is not None else 0,
            wal_bytes=int(w.m_bytes) if w is not None else 0,
            wal_segments=int(w.m_segments) if w is not None else 0,
            wal_fsync_s=float(w.m_fsync_s) if w is not None else 0.0,
            wal_append_lag_s=(float(w.pending_age_s)
                              if w is not None else 0.0),
        )

    def _collect_procs(self, loads: Dict[int, Tuple[int, np.ndarray]],
                       dt: float) -> List[ProcessMetrics]:
        out = []
        for pid in sorted(loads):
            clock, vec = loads[pid]
            n_upd = int(vec[LOAD_UPDATES])
            prev = self._prev_proc.get(pid, 0)
            self._prev_proc[pid] = n_upd
            out.append(ProcessMetrics(
                process=pid, clock=clock, n_updates=n_upd,
                block_time_clock=float(vec[LOAD_BLOCK_CLOCK]),
                block_time_value=float(vec[LOAD_BLOCK_VALUE]),
                updates_per_s=max(0, n_upd - prev) / dt))
        return out

    def _collect_serving(self, dt: float
                         ) -> Tuple[List[ReplicaMetrics],
                                    List[GatewayMetrics]]:
        reps: List[ReplicaMetrics] = []
        gws: List[GatewayMetrics] = []
        for rset in list(self.rt._replica_sets):
            mvc = rset.master_vc()
            stale = rset.stale_replicas
            for rep in list(rset.replicas):
                reps.append(ReplicaMetrics(
                    rid=rep.rid,
                    staleness=rset.staleness(rep.vc, mvc),
                    reads=rep.reads,
                    deltas_applied=rep.deltas_applied,
                    bytes_ingested=rep.bytes_ingested,
                    poisoned=rep.poisoned,
                    stale=rep.rid in stale))
        for gw in list(self.rt._gateways):
            with gw._slock:
                st = gw.stats
                reads = st.n_reads
                esc = st.n_escalations
                gm = GatewayMetrics(
                    n_reads=reads,
                    n_replica_reads=st.n_replica_reads,
                    n_master_reads=st.n_master_reads,
                    n_escalations=esc,
                    n_shed=st.n_shed,
                    n_cache_hits=st.n_cache_hits,
                    reads_by_slo=dict(st.reads_by_slo),
                    max_served_staleness=st.max_served_staleness,
                    block_time=st.block_time,
                    reads_per_replica=dict(st.reads_per_replica),
                    shedding_fresh=gw.shed_fresh,
                    n_live_replicas=gw.replicas.n_live)
            p_reads, p_esc = self._prev_gw.get(id(gw), (0, 0))
            self._prev_gw[id(gw)] = (reads, esc)
            d_reads = max(0, reads - p_reads)
            gm.reads_per_s = d_reads / dt
            gm.escalations_per_s = max(0, esc - p_esc) / dt
            gm.escalation_rate = (max(0, esc - p_esc) / d_reads
                                  if d_reads else 0.0)
            gws.append(gm)
        return reps, gws

    # -------------------------------------------------------------- collect
    def collect(self) -> RuntimeMetrics:
        rt = self.rt
        now = time.monotonic()
        t0 = rt._t0 or now
        dt = max(now - (self._prev_t if self._prev_t is not None else t0),
                 1e-6)
        self._prev_t = now
        # per-process boundary snapshots: latest clock wins across shards
        # (every active shard receives every ClockMsg)
        loads: Dict[int, Tuple[int, np.ndarray]] = {}
        for s in rt.shards:
            for pid, entry in list(s.proc_load.items()):
                if pid not in loads or entry[0] > loads[pid][0]:
                    loads[pid] = entry
        membership = MembershipMetrics(
            epoch=rt.partition.epoch,
            active=tuple(rt.partition.active),
            n_slots=rt.n_slots,
            n_ops=len(rt.membership.log))     # one log entry per completed op
        with rt._snap_lock:
            snaps = SnapshotMetrics(
                n_snapshots=len(rt.snapshots),
                snapshot_every=rt.snapshot_every,
                last_clock=rt.snapshots[-1][0] if rt.snapshots else -1)
        shards = [self._collect_shard(s, now, dt) for s in rt.shards]
        reps, gws = self._collect_serving(dt)
        return RuntimeMetrics(
            t=now,
            wall_s=now - t0,
            window_s=dt,
            clock=rt.completed_clock(),
            transport=rt.transport_kind,
            metrics_enabled=rt.metrics_on,
            run=self._collect_run(loads),
            membership=membership,
            snapshots=snaps,
            shards=shards,
            processes=self._collect_procs(loads, dt),
            replicas=reps,
            gateways=gws,
            trace_enabled=rt.trace_on,
            trace_dropped=(rt._trace.dropped() if rt.trace_on else 0),
        )
