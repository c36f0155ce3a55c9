"""Autoscaling control loop over the elastic runtime.

The metrics tier (:mod:`repro_torch.runtime.metrics`) measures where the
paper's bounded inconsistency is spending its slack; this module *acts* on
it.  An :class:`Autoscaler` thread polls a private
:class:`~repro_torch.runtime.metrics.MetricsHub` and drives three
actuators:

  * **shard scaling** via the :class:`~repro_torch.runtime.membership.
    MembershipManager` — when the windowed apply load across active shards
    is imbalanced past ``split_imbalance`` (one hot shard gating every
    client's clock frontier), it activates a dormant slot: the round-robin
    re-partition *splits* the hot shard's rows across more owners (the rows
    migrate on the device).  When the coldest active shard's load falls
    below ``drain_max_rows_s`` it *drains* that slot back into the
    survivors (a near-idle slot still costs a frontier constraint and
    per-clock fan-out — consolidation is the rebalance that pays on a host
    with fewer cores than slots);
  * **replica scaling** via :meth:`ReadGateway.add_replica` /
    ``remove_replica`` — the windowed escalation rate (reads that missed
    their staleness SLO on every replica and fell back to the master) is
    the SLO-violation signal: past ``escalation_hi`` a replica is added,
    and after ``drain_patience`` consecutive calm windows below
    ``escalation_lo`` the least-loaded one is drained;
  * **SLO-aware admission** via :meth:`ReadGateway.set_shed_fresh` — when
    the master is hot (windowed apply-lock wait fraction past
    ``shed_lock_wait_frac``; ``fresh`` reads contend on exactly those
    locks), the gateway sheds ``fresh`` reads with
    :class:`~repro_torch.runtime.serving.gateway.ReadShedError` instead of
    piling onto the master, releasing at half the threshold (hysteresis).

Decisions are separated from actuation: :meth:`Autoscaler.decide` is a
pure function of one :class:`RuntimeMetrics` snapshot (unit-testable on
synthetic metrics, and held equal to the JAX package's on the same
snapshots); the loop thread applies them with a cooldown between
membership ops and records every action (and failure) in ``.actions``.
The paper's bounds and the zero-lost/duplicated-update audit hold *while*
the autoscaler churns membership.  Everything here is host state: the
metrics never touch the device.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime.metrics import MetricsHub, RuntimeMetrics

log = logging.getLogger("repro_torch.runtime.autoscale")


@dataclass
class AutoscalePolicy:
    """Policy knobs of the control loop (module docstring)."""
    interval: float = 0.25        # metrics poll period (s)
    cooldown: float = 1.5         # min s between membership ops
    # --- shard split/drain (load imbalance) ---
    split_imbalance: float = 1.6  # max/mean windowed rows/s across active
    split_min_rows_s: float = 500.0   # hot shard must carry real load
    drain_max_rows_s: float = 50.0    # drain an active shard whose windowed
                                      # load falls below this (a cold slot
                                      # still costs a frontier constraint
                                      # and per-clock fan-out)
    min_shards: int = 1
    max_shards: Optional[int] = None  # None -> every provisioned slot
    # --- replica scaling (SLO-violation / escalation rate) ---
    escalation_hi: float = 0.15   # windowed escalations/read: scale up
    escalation_lo: float = 0.01   # windowed escalations/read: calm
    drain_patience: int = 3       # calm windows before draining a replica
    min_replicas: int = 1
    max_replicas: int = 4
    min_window_reads: int = 5     # ignore rate noise below this many reads
    # --- admission (shed fresh reads while the master is hot) ---
    shed_lock_wait_frac: float = 0.25  # windowed apply-lock wait / wall
    # --- ops ---
    op_timeout: float = 10.0      # membership op budget (autoscaler ops
                                  # race the run's natural quiesce; a late
                                  # op may time out and is just recorded)


@dataclass
class AutoscaleAction:
    wall_s: float                 # seconds since runtime start
    kind: str                     # "add_shard" | "remove_shard" |
    detail: str                   # "add_replica" | "remove_replica" |
    ok: bool                      # "shed_fresh"
    error: Optional[str] = None


@dataclass
class _GwState:
    calm_windows: int = 0


class Autoscaler:
    """Drives shard membership, the replica set, and gateway admission
    from observed load (module docstring).  ``gateway`` is optional — a
    write-only runtime still gets shard split/drain."""

    def __init__(self, rt, gateway=None,
                 policy: Optional[AutoscalePolicy] = None):
        self.rt = rt
        self.gateway = gateway
        self.policy = policy or AutoscalePolicy()
        self.hub = MetricsHub(rt)      # private rate window: callers using
        self.actions: List[AutoscaleAction] = []   # rt.metrics() don't skew it
        self._prev_lock_wait = 0.0
        self._gw_state: Dict[int, _GwState] = {}
        self._last_op = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- decisions
    def decide(self, m: RuntimeMetrics) -> List[Tuple]:
        """Pure policy: one metrics snapshot -> list of decisions
        (``("add_shard",)``, ``("remove_shard", sid)``,
        ``("add_replica", gw_index)``, ``("remove_replica", gw_index)``,
        ``("shed_fresh", gw_index, bool)``)."""
        pol = self.policy
        out: List[Tuple] = []
        active = m.active_shards()
        if active:
            rates = [s.rows_per_s for s in active]
            cap = pol.max_shards if pol.max_shards is not None else len(
                m.shards)
            if (len(active) < cap
                    and m.shard_imbalance() >= pol.split_imbalance
                    and max(rates) >= pol.split_min_rows_s):
                out.append(("add_shard",))
            elif len(active) > pol.min_shards:
                cold = m.coldest_shard()
                if (cold is not None
                        and cold.rows_per_s < pol.drain_max_rows_s):
                    out.append(("remove_shard", cold.sid))
        # master-hot signal: windowed apply-lock wait across every shard as
        # a fraction of the window (fresh reads contend on those locks)
        lock_wait = sum(s.apply_lock_wait_s for s in m.shards)
        wait_frac = max(0.0, lock_wait - self._prev_lock_wait) / m.window_s
        self._prev_lock_wait = lock_wait
        for i, gw in enumerate(m.gateways):
            st = self._gw_state.setdefault(i, _GwState())
            window_reads = m.window_s * gw.reads_per_s
            if window_reads >= self.policy.min_window_reads:
                if (gw.escalation_rate >= pol.escalation_hi
                        and gw.n_live_replicas < pol.max_replicas):
                    st.calm_windows = 0
                    out.append(("add_replica", i))
                elif gw.escalation_rate <= pol.escalation_lo:
                    st.calm_windows += 1
                    if (st.calm_windows >= pol.drain_patience
                            and gw.n_live_replicas > pol.min_replicas):
                        st.calm_windows = 0
                        out.append(("remove_replica", i))
                else:
                    st.calm_windows = 0
            if wait_frac > pol.shed_lock_wait_frac and not gw.shedding_fresh:
                out.append(("shed_fresh", i, True))
            elif (gw.shedding_fresh
                  and wait_frac < pol.shed_lock_wait_frac / 2):
                out.append(("shed_fresh", i, False))
        return out

    # ------------------------------------------------------------- actuation
    def _record(self, kind: str, detail: str, ok: bool,
                error: Optional[str] = None) -> None:
        self.actions.append(AutoscaleAction(
            time.monotonic() - (self.rt._t0 or time.monotonic()),
            kind, detail, ok, error))

    def _apply(self, decisions: List[Tuple]) -> None:
        rt = self.rt
        pol = self.policy
        now = time.monotonic()
        for dec in decisions:
            kind = dec[0]
            try:
                if kind in ("add_shard", "remove_shard"):
                    # membership ops pay a cooldown (each one freezes the
                    # partition briefly) and only make sense on a live run
                    if now - self._last_op < pol.cooldown or not rt.running:
                        continue
                    self._last_op = now
                    if kind == "add_shard":
                        sid = rt.add_shard(timeout=pol.op_timeout)
                        self._record(kind, f"activated slot {sid}", True)
                    else:
                        rt.remove_shard(dec[1], timeout=pol.op_timeout)
                        self._record(kind, f"drained slot {dec[1]}", True)
                elif kind == "add_replica":
                    rep = self.gateway.add_replica()
                    self._record(kind, f"replica {rep.rid}", True)
                elif kind == "remove_replica":
                    rep = self.gateway.remove_replica()
                    if rep is not None:
                        self._record(kind, f"replica {rep.rid}", True)
                elif kind == "shed_fresh":
                    self.gateway.set_shed_fresh(dec[2])
                    self._record(kind, f"shed={dec[2]}", True)
            except BaseException as e:
                # an op racing the run's quiesce (or a raced slot pick) is
                # an expected loss, never an error of the run itself
                log.warning("autoscaler op %s %r failed: %r (expected when "
                            "racing the run's quiesce; recorded, not fatal)",
                            kind, dec, e)
                self._record(kind, repr(dec), False, repr(e))

    def step(self) -> List[Tuple]:
        """One poll cycle: collect, decide, apply.  Returns the decisions
        (callers that drive the loop themselves call this directly)."""
        decisions = self.decide(self.hub.collect())
        self._apply(decisions)
        return decisions

    # ------------------------------------------------------------- lifecycle
    def _loop(self) -> None:
        while not self._stop.is_set() and self.rt.running:
            try:
                self.step()
            except BaseException:
                # a torn metrics read mid-teardown must not kill the loop
                if self._stop.is_set() or not self.rt.running:
                    break
            self._stop.wait(self.policy.interval)

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="ps-autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def __enter__(self) -> "Autoscaler":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- reporting
    def summary(self) -> Dict[str, int]:
        """Action counts by kind (successful only)."""
        out: Dict[str, int] = {}
        for a in self.actions:
            if a.ok:
                out[a.kind] = out.get(a.kind, 0) + 1
        return out
