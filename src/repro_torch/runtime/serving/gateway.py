"""The read gateway: per-read staleness SLOs measured against the vector
clock.

Reads return host arrays: a replica read is a copy of the replica's device
buffer (:meth:`~repro_torch.runtime.serving.replica.Replica.serve`), a
master read the shards' per-shard-locked assembly
(:meth:`PSRuntime.master_value`), both in the key's original shape.

Every read declares an SLO:

  * ``slo=k`` (int >= 0) — the returned value may trail the master's
    applied frontier by at most ``k`` clocks;
  * ``slo="fresh"`` (:data:`FRESH`) — the read goes to the master shards
    (per-shard-locked assembly of the authoritative blocks);
  * ``slo=None`` — any replica qualifies; the response is still stamped.

Routing: among the replicas whose vector clock satisfies the bound, the
gateway picks the least-loaded (fewest served reads) and copies the value
out under the replica lock.  It then **re-measures** against the live
master vector clock sampled *after* the copy — an upper bound on the true
staleness at serve time, since the master frontier only advances — and only
returns if the conservative measure still meets the SLO; otherwise it tries
again.  When no replica qualifies it parks on the replica set's doorbell
(a condition the ingest threads ring whenever a vector clock advances — a
real kernel sleep, not sub-ms polling) and, at the deadline, **escalates to
the master**, so the SLO is met by construction and the stamp on every
:class:`ReadResult` lets tests assert it was *honored*, not just requested.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np

from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime.metrics import slo_key
from repro_torch.runtime.serving.replica import ReplicaSet

FRESH = "fresh"                  # sentinel SLO: serve the master state
Slo = Union[int, str, None]

log = logging.getLogger("repro_torch.runtime.serving.gateway")


def _slo_code(slo: Slo) -> int:
    """The integer trace encoding of an SLO (trace.SLO_ANY / SLO_FRESH)."""
    if slo is None:
        return trace_mod.SLO_ANY
    if slo == FRESH:
        return trace_mod.SLO_FRESH
    return int(slo)


class ReadShedError(RuntimeError):
    """A ``fresh`` read refused by SLO-aware admission control: the master
    is hot and the gateway is shedding master-path reads
    (:meth:`ReadGateway.set_shed_fresh`).  Clients retry, degrade to a
    bounded SLO, or surface the overload."""

    def __init__(self, key: str):
        super().__init__(f"fresh read of {key!r} shed: master overloaded")
        self.key = key


@dataclass
class ReadResult:
    """One served read, stamped with how stale it actually was."""
    value: np.ndarray            # in the key's original shape
    key: str
    source: str                  # "replica:<rid>", "cache" or "master"
    staleness: int               # measured clocks behind the master vc
    slo: Slo                     # what the client asked for
    escalated: bool              # no replica qualified before the deadline
    waited_s: float              # wall time from request to response
    # consistency audit stamps (rt.explain_read): on an escalated read, the
    # (slot, process) cell of the best candidate replica's vector clock that
    # trailed the master frontier furthest at escalation time, and by how
    # many clocks.  -1/-1/0 when the read never escalated.
    lag_shard: int = -1
    lag_proc: int = -1
    vc_gap: int = 0


@dataclass
class GatewayStats:
    """The gateway's raw counters, the source of ``rt.metrics().gateways``
    (:mod:`repro_torch.runtime.metrics`), which is the read surface."""
    n_reads: int = 0
    n_replica_reads: int = 0
    n_master_reads: int = 0      # fresh SLO + escalations
    n_escalations: int = 0
    n_shed: int = 0              # fresh reads refused by admission control
    n_cache_hits: int = 0        # reads served from the gateway cache
    max_served_staleness: int = 0
    block_time: float = 0.0      # time actually parked on the doorbell only
    reads_per_replica: Dict[int, int] = field(default_factory=dict)
    reads_by_slo: Dict[str, int] = field(default_factory=dict)


class ReadGateway:
    """SLO-routed serving reads over a :class:`ReplicaSet`.

    Thread-safe: any number of client threads may call :meth:`read`
    concurrently (the serving copy happens under the chosen replica's lock,
    stats under the gateway's own).
    """

    def __init__(self, rt, n_replicas: int = 2, transport: str = "queue",
                 check: bool = True, bootstrap_from_snapshot: bool = False,
                 replica_set: Optional[ReplicaSet] = None,
                 read_cache: bool = False):
        self.rt = rt
        self.replicas = replica_set if replica_set is not None else ReplicaSet(
            rt, n_replicas, transport=transport, check=check,
            bootstrap_from_snapshot=bootstrap_from_snapshot)
        self.stats = GatewayStats()
        self._slock = threading.Lock()
        # SLO-aware admission: while engaged (a master-hot signal), fresh
        # reads are refused with ReadShedError instead of adding
        # master-shard lock traffic
        self.shed_fresh = False
        # gateway read cache (within a vc stamp): serve repeated hot-key
        # reads without touching a replica while the cached stamp still
        # meets the request's SLO.  {key: (flat value copy, vc at copy)} —
        # staleness is re-measured against the LIVE master vc on every hit,
        # so an advanced master frontier invalidates naturally and a cached
        # read can never stamp staler than requested.
        self.read_cache = read_cache
        self._cache: Dict[str, tuple] = {}
        self._gw_id = len(rt._gateways)
        rt._gateways.append(self)            # unified metrics registry

    # ------------------------------------------------------------ admission
    def set_shed_fresh(self, shed: bool) -> None:
        """Engage/release fresh-read shedding (SLO-aware admission)."""
        shed = bool(shed)
        if shed != self.shed_fresh:
            if shed:
                log.warning("gateway %d: fresh-read shedding ENGAGED — "
                            "master hot, fresh reads now refused with "
                            "ReadShedError", self._gw_id)
            else:
                log.info("gateway %d: fresh-read shedding released",
                         self._gw_id)
        self.shed_fresh = shed

    # ---------------------------------------------------------------- reads
    def read(self, key: str, slo: Slo = None,
             timeout: float = 30.0) -> ReadResult:
        """Serve one read under the declared staleness SLO (module doc)."""
        t0 = time.monotonic()
        rt = self.rt
        trc = rt._trace if rt.trace_on else None
        with self._slock:
            k = slo_key(slo)
            self.stats.reads_by_slo[k] = self.stats.reads_by_slo.get(k, 0) + 1
        if slo == FRESH:
            if self.shed_fresh:
                with self._slock:
                    self.stats.n_shed += 1
                raise ReadShedError(key)
            res = self._serve_master(key, slo, t0, escalated=False)
            if trc is not None:
                trc.point(trace_mod.EV_READ, _slo_code(slo), res.staleness,
                          res.source)
            return res
        bound = float("inf") if slo is None else int(slo)
        if bound < 0:
            raise ValueError(f"slo must be >= 0 or {FRESH!r}, got {slo!r}")
        deadline = t0 + timeout
        rset = self.replicas
        fails = 0
        blocked = 0.0
        while True:
            res = self._try_cache(key, bound, slo, t0)
            if res is not None:
                break
            with rset.cond:
                v0 = rset.version
            res = self._try_replicas(key, bound, slo, t0)
            if res is not None:
                break
            fails += 1
            now = time.monotonic()
            if now >= deadline:
                # audit stamp BEFORE the master copy: the lagging cell is
                # measured at the moment escalation was decided
                lag = self._lag_info()
                if trc is not None:
                    trc.point(trace_mod.EV_ESCALATE, self._gw_id, 0, key)
                res = self._serve_master(key, slo, t0, escalated=True)
                res.lag_shard, res.lag_proc, res.vc_gap = lag
                break
            with rset.cond:
                # version guard: a doorbell rung during the FIRST failed
                # attempt retries immediately instead of sleeping through
                # it; after that, retries are paced by the doorbell itself
                # (one per notify), else a hot vc under heavy write traffic
                # turns waiting readers into a GIL-burning retry storm that
                # starves the very ingest threads they are waiting on
                if rset.version == v0 or fails >= 2:
                    t_w = time.monotonic()
                    rset.cond.wait(min(0.25, deadline - now))
                    blocked += time.monotonic() - t_w
                    if trc is not None:
                        trc.span(trace_mod.EV_PARK, int(t_w * 1e9),
                                 self._gw_id, 0, key)
        if blocked:
            with self._slock:
                self.stats.block_time += blocked
        if trc is not None:
            trc.point(trace_mod.EV_READ, _slo_code(slo), res.staleness,
                      res.source)
        return res

    def _lag_info(self) -> tuple:
        """The (slot, process, gap) cell that forced this escalation: over
        the live replicas, take the BEST candidate (smallest worst-case vc
        gap vs the master frontier) and name the cell where even it trailed
        furthest.  (-1, -1, 0) when no live replica exists at all."""
        rset = self.replicas
        mvc = rset.master_vc()
        best = None
        for rep in rset.replicas:
            if rep.poisoned or rep.retired:
                continue
            gap = mvc - rep.vc
            worst = int(gap.max())
            if best is None or worst < best[0]:
                s, p = np.unravel_index(int(gap.argmax()), gap.shape)
                best = (worst, int(s), int(p))
        if best is None:
            return (-1, -1, 0)
        worst, s, p = best
        return (s, p, max(worst, 0))

    def _try_cache(self, key: str, bound: float, slo: Slo,
                   t0: float) -> Optional[ReadResult]:
        """Serve from the gateway cache if its stamp still meets the SLO.

        The cached entry's vc was sampled at (or conservatively before) the
        moment its value was copied; measuring it against the *live* master
        vc can only overstate the true staleness (the frontier is
        monotone), so a hit never stamps staler than it really is — and an
        entry whose measured lag exceeds the bound simply misses (the vc
        advance invalidated it)."""
        if not self.read_cache:
            return None
        with self._slock:
            ent = self._cache.get(key)
        if ent is None:
            return None
        flat, cvc = ent
        lag = self.replicas.staleness(cvc, self.replicas.master_vc())
        if lag > bound:
            return None
        with self._slock:
            self.stats.n_reads += 1
            self.stats.n_cache_hits += 1
            self.stats.max_served_staleness = max(
                self.stats.max_served_staleness, lag)
        return ReadResult(flat.copy().reshape(self.rt._shapes[key]), key,
                          "cache", lag, slo, False, time.monotonic() - t0)

    def _cache_put(self, key: str, flat: np.ndarray, vc) -> None:
        with self._slock:
            self._cache[key] = (flat, vc)

    def _try_replicas(self, key: str, bound: float, slo: Slo,
                      t0: float) -> Optional[ReadResult]:
        rset = self.replicas
        mvc = rset.master_vc()
        # least-loaded first; the racy .reads peek only orders candidates
        for rep in sorted(rset.replicas, key=lambda r: r.reads):
            if rep.poisoned or rep.retired:
                continue                       # ingest failed / drained out
            if rset.staleness(rep.vc, mvc) > bound:
                continue                       # cheap unlocked pre-filter
            value, rvc = rep.serve(key)
            # conservative stamp: master vc sampled AFTER the copy can only
            # be ahead of the frontier at copy time, so measured >= true
            lag = rset.staleness(rvc, rset.master_vc())
            if lag > bound:                    # master advanced mid-copy
                continue
            with self._slock:
                self.stats.n_reads += 1
                self.stats.n_replica_reads += 1
                self.stats.max_served_staleness = max(
                    self.stats.max_served_staleness, lag)
                self.stats.reads_per_replica[rep.rid] = (
                    self.stats.reads_per_replica.get(rep.rid, 0) + 1)
            if self.read_cache:
                # rep.serve already copied out of the replica buffers; the
                # reshape below shares that copy with the caller, so the
                # cache keeps its own
                self._cache_put(key, value.copy(), rvc)
            return ReadResult(value.reshape(self.rt._shapes[key]), key,
                              f"replica:{rep.rid}", lag, slo, False,
                              time.monotonic() - t0)
        return None

    def _serve_master(self, key: str, slo: Slo, t0: float,
                      escalated: bool) -> ReadResult:
        # cache stamp sampled BEFORE the copy: everything the stamp claims
        # is certainly in the copied value (the frontier is monotone), so
        # hits measured against it stay conservative
        mvc = self.replicas.master_vc() if self.read_cache else None
        value = self.rt.master_value(key)      # per-shard-locked assembly
        with self._slock:
            self.stats.n_reads += 1
            self.stats.n_master_reads += 1
            if escalated:
                self.stats.n_escalations += 1
        if self.read_cache:
            flat = np.ascontiguousarray(value).reshape(
                self.rt._x0[key].shape).copy()
            self._cache_put(key, flat, mvc)
        return ReadResult(value, key, "master", 0, slo, escalated,
                          time.monotonic() - t0)

    # ------------------------------------------------------------- lifecycle
    def add_replica(self, bootstrap_from_snapshot: bool = False):
        return self.replicas.add_replica(
            bootstrap_from_snapshot=bootstrap_from_snapshot)

    def remove_replica(self, rid=None):
        return self.replicas.remove_replica(rid)

    def close(self, timeout: float = 10.0) -> None:
        self.replicas.close(timeout=timeout)

    def __enter__(self) -> "ReadGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
