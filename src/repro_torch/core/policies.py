"""Consistency policies — the paper's §2 models as data.

A :class:`Policy` is pure data; the *Consistency Controller*
(:mod:`repro_torch.core.controller`) interprets it.  This mirrors the paper's
§4.3 split between *Consistency Policy* (data structure) and *Consistency
Controller* (logic), and the same Policy object drives both the faithful
asynchronous simulator (:mod:`repro_torch.core.server`) and the threaded
runtime (:mod:`repro_torch.runtime`).  Policies are host data: nothing here
touches the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

INF = math.inf


@dataclass(frozen=True)
class ConsistencySpec:
    """User-facing consistency selection; mirrors the paper's policies."""

    model: str = "bsp"                # bsp|ssp|cap|essp|vap|cvap|elastic
    staleness: int = 0                # s  (ssp/cap/essp/cvap)
    value_bound: float = 0.0          # v_thr (vap/cvap) / norm B (elastic)
    strong: bool = False              # strong VAP variant


@dataclass(frozen=True)
class Policy:
    """A bounded-asynchronous consistency policy.

    kind         one of bsp | ssp | cap | essp | vap | cvap | elastic
    staleness    s — clock bound (ssp / cap / essp / cvap).  A worker at clock
                 c is guaranteed to see all updates timestamped ≤ c - s - 1.
                 ESSP (arXiv:1410.8043) keeps the SSP gate but the server
                 eagerly pushes applied deltas to every worker at each clock
                 boundary, so *observed* staleness sits well below s.
    value_bound  v_thr — value bound (vap / cvap): a worker's accumulated
                 unsynchronized updates per parameter stay ≤ max(u, v_thr).
                 For kind "elastic" (arXiv:2001.05918) the same field is the
                 elastic bound B on the L2 *norm* of the worker's whole
                 unobserved-update sum: ‖Σ unsynced‖₂ ≤ max(‖u‖₂, B).
    strong       strong-VAP: additionally bounds the total magnitude of
                 *half-synchronized* updates per parameter by max(u, v_thr),
                 giving divergence ≤ 2·max(u, v_thr) independent of P.
    push_at_clock_only
                 SSP semantics: updates leave the worker only during the
                 synchronization phase.  CAP/ESSP/VAP/CVAP/elastic push
                 updates as soon as network bandwidth is available.

    Construction rejects arguments the kind does not interpret (a staleness
    on vap, a value bound on ssp, ...) instead of silently dropping them.
    """

    kind: str
    staleness: int = 0
    value_bound: float = INF
    strong: bool = False
    push_at_clock_only: bool = False

    def __post_init__(self):
        if self.kind not in ("bsp", "ssp", "cap", "essp", "vap", "cvap",
                             "elastic"):
            raise ValueError(f"unknown consistency kind {self.kind!r}")
        if self.staleness < 0:
            raise ValueError("staleness must be >= 0")
        if self.value_bound <= 0:
            raise ValueError("value_bound must be > 0")
        # inactive-bound arguments are errors, not no-ops: every parameter a
        # caller passes must be one the controller actually reads for this
        # kind, otherwise Policy("vap", staleness=3) silently runs unbounded
        # in clock and Policy("ssp", value_bound=0.5) silently runs
        # unbounded in value.
        if self.staleness != 0 and not self.clock_bounded:
            raise ValueError(
                f"kind {self.kind!r} does not interpret a staleness bound "
                f"(got staleness={self.staleness})")
        if self.value_bound != INF and self.kind not in ("vap", "cvap",
                                                         "elastic"):
            raise ValueError(
                f"kind {self.kind!r} does not interpret a value bound "
                f"(got value_bound={self.value_bound})")
        if self.strong and self.kind not in ("vap", "cvap"):
            raise ValueError(
                f"strong delivery gating only applies to vap/cvap "
                f"(got kind {self.kind!r})")
        if self.push_at_clock_only and self.kind in ("essp", "elastic"):
            raise ValueError(
                f"kind {self.kind!r} is constitutively eager; "
                f"push_at_clock_only does not apply")

    # --- which bounds are active -------------------------------------------
    @property
    def clock_bounded(self) -> bool:
        return self.kind in ("bsp", "ssp", "cap", "essp", "cvap")

    @property
    def value_bounded(self) -> bool:
        return self.kind in ("vap", "cvap") and self.value_bound != INF

    @property
    def norm_bounded(self) -> bool:
        """Elastic consistency: one bound on ‖unsynced sum‖₂ per worker."""
        return self.kind == "elastic" and self.value_bound != INF

    @property
    def tracks_sync(self) -> bool:
        """Does the runtime need exact delivered-update accounting (the
        unsynced accumulators + FullyDelivered ack path)?  True for any
        value- or norm-bounded policy."""
        return self.value_bounded or self.norm_bounded

    @property
    def server_push_on_boundary(self) -> bool:
        """ESSP: shards coalesce applied deltas per destination and push one
        frame per peer at every clock boundary (eager server push)."""
        return self.kind == "essp"


def bsp() -> Policy:
    return Policy("bsp", staleness=0, push_at_clock_only=True)


def ssp(staleness: int) -> Policy:
    return Policy("ssp", staleness=staleness, push_at_clock_only=True)


def cap(staleness: int) -> Policy:
    return Policy("cap", staleness=staleness)


def vap(value_bound: float, strong: bool = False) -> Policy:
    return Policy("vap", value_bound=value_bound, strong=strong)


def cvap(staleness: int, value_bound: float, strong: bool = False) -> Policy:
    return Policy("cvap", staleness=staleness, value_bound=value_bound,
                  strong=strong)


def essp(staleness: int) -> Policy:
    """Eager SSP: SSP's clock gate, server pushes at every clock boundary."""
    return Policy("essp", staleness=staleness)


def elastic(norm_bound: float) -> Policy:
    """Elastic consistency: ‖worker's unsynced sum‖₂ ≤ max(‖u‖₂, B)."""
    return Policy("elastic", value_bound=norm_bound)


def from_spec(spec: ConsistencySpec) -> Policy:
    kind = spec.model.lower()
    if kind == "bsp":
        return bsp()
    if kind == "ssp":
        return ssp(spec.staleness)
    if kind == "cap":
        return cap(spec.staleness)
    if kind == "essp":
        return essp(spec.staleness)
    if kind == "vap":
        return vap(spec.value_bound or INF, spec.strong)
    if kind == "cvap":
        return cvap(spec.staleness, spec.value_bound or INF, spec.strong)
    if kind == "elastic":
        return elastic(spec.value_bound or INF)
    raise ValueError(f"unknown consistency model {spec.model!r}")
