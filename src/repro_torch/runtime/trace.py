"""Sampled end-to-end tracing of updates and reads, with Perfetto export
and consistency audit trails.

The metrics tier (:mod:`repro_torch.runtime.metrics`) answers *how much*:
counters and windowed rates per shard, process, replica and gateway.  This
tier answers *why* and *where*: every layer records fixed-size events into
per-thread bounded ring buffers — client outbox flush and clock/value
blocking, wire write/decode, shard dequeue/apply/lock-wait, WAL
append/group-commit, serving publish, replica ingest, gateway
park/escalate/serve — so one update's life from ``Inc()`` to replica
visibility is reconstructible after the fact.

Design rules (the same discipline as :mod:`repro_torch.runtime.metrics`):

* **Per-thread, lock-free, bounded.**  Each recording thread owns one ring
  (``deque(maxlen=capacity)``, drop-oldest, drops counted); the hub's lock
  is taken only at ring *registration*, never on the append path.  Events
  are fixed-shape 6-tuples ``(kind, t0_ns, dur_ns, a, b, c)``.
* **Monotonic only.**  Timestamps are ``time.monotonic_ns()`` —
  ``CLOCK_MONOTONIC`` is system-wide on Linux, so events recorded in forked
  client processes land on the same timeline as the parent's shard events.
* **Near-zero when off.**  Every instrumentation site is gated on a plain
  ``rt.trace_on`` attribute read (one branch), exactly like
  ``rt.metrics_on``; with ``RuntimeConfig(trace=None)`` (the default) no
  ring is ever allocated.
* **No wire-format change.**  Spans are joined on identifiers the wire
  already carries: ``(proc, uid)`` for update parts, the publish channel's
  ``seq`` for publish -> ingest, ``(shard, clock)`` for commits.  Forked
  clients record into a hub of their own and ship its rings to the parent
  in the quiesce payload they already send.
* **The apply is done when its span ends.**  The shard's ``apply`` span
  ends after a synchronize of the current CUDA stream when its masters live
  on the card (the ``ps_apply`` launches are asynchronous); with tracing
  off the apply path never synchronizes.  A replica's ``ingest`` span
  ends the same way.

``dump_chrome_trace`` exports the merged rings as Chrome trace-event JSON
(one track per thread per process, update lifelines as flow events) —
load the file in Perfetto's UI.  The audit helpers (:func:`explain_read`,
:func:`explain_block`, :func:`staleness_timeline`) turn the same event log
and the gateway's vc measurements into "name the straggler" answers; they
are surfaced as methods on ``PSRuntime``.  The membership manager records
an ``epoch`` point (``EV_EPOCH``: the epoch and its active slot count) at
each completed install.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

# ---------------------------------------------------------------------------
# event kinds — (kind, t0_ns, dur_ns, a, b, c); arg meaning per kind below
# ---------------------------------------------------------------------------

EV_BLOCK_CLOCK = 0    # span    a=proc  b=worker    c=straggler proc (-1 ?)
EV_BLOCK_VALUE = 1    # span    a=proc  b=worker    c=clock
EV_FLUSH = 2          # span    a=proc  b=clock     c=n_parts
EV_SEND = 3           # point   a=proc  b=uid       c=key        (flow ->)
EV_CLOCK = 4          # point   a=proc  b=clock
EV_WIRE_WRITE = 5     # span    a=n_msgs            c=channel name
EV_WIRE_DECODE = 6    # span    a=n_msgs            c=reader name
EV_SHARD_BATCH = 7    # span    a=shard b=n_msgs
EV_LOCK_WAIT = 8      # span    a=shard
EV_APPLY = 9          # span    a=shard b=n_parts   c=n_rows
EV_APPLY_PART = 10    # point   a=proc  b=uid       c=shard      (flow <-)
EV_WAL_APPEND = 11    # span    a=shard b=n_parts
EV_WAL_COMMIT = 12    # span    a=shard b=clock
EV_PUBLISH = 13       # span    a=shard b=clock     c=n_replicas
EV_PUBLISH_PART = 14  # point   a=shard b=seq       c=replica    (flow ->)
EV_INGEST = 15        # span    a=replica b=n_msgs
EV_INGEST_PART = 16   # point   a=shard b=seq       c=replica    (flow <-)
EV_REPLICA_VC = 17    # point   a=replica b=shard   c=staleness
EV_READ = 18          # span    a=slo (-1 any, -2 fresh) b=staleness c=source
EV_PARK = 19          # span    a=gateway           c=key
EV_ESCALATE = 20      # point   a=gateway           c=key
EV_EPOCH = 21         # point   a=epoch b=n_active

_NAMES = {
    EV_BLOCK_CLOCK: "block_clock", EV_BLOCK_VALUE: "block_value",
    EV_FLUSH: "outbox_flush", EV_SEND: "send_part", EV_CLOCK: "clock",
    EV_WIRE_WRITE: "wire_write", EV_WIRE_DECODE: "wire_decode",
    EV_SHARD_BATCH: "shard_batch", EV_LOCK_WAIT: "lock_wait",
    EV_APPLY: "apply", EV_APPLY_PART: "apply_part",
    EV_WAL_APPEND: "wal_append", EV_WAL_COMMIT: "wal_commit",
    EV_PUBLISH: "publish", EV_PUBLISH_PART: "publish_part",
    EV_INGEST: "ingest", EV_INGEST_PART: "ingest_part",
    EV_REPLICA_VC: "replica_vc", EV_READ: "read", EV_PARK: "park",
    EV_ESCALATE: "escalate", EV_EPOCH: "epoch",
}
_ARGS = {
    EV_BLOCK_CLOCK: ("proc", "worker", "straggler"),
    EV_BLOCK_VALUE: ("proc", "worker", "clock"),
    EV_FLUSH: ("proc", "clock", "n_parts"),
    EV_SEND: ("proc", "uid", "key"),
    EV_CLOCK: ("proc", "clock", ""),
    EV_WIRE_WRITE: ("n_msgs", "", "channel"),
    EV_WIRE_DECODE: ("n_msgs", "", "reader"),
    EV_SHARD_BATCH: ("shard", "n_msgs", ""),
    EV_LOCK_WAIT: ("shard", "", ""),
    EV_APPLY: ("shard", "n_parts", "n_rows"),
    EV_APPLY_PART: ("proc", "uid", "shard"),
    EV_WAL_APPEND: ("shard", "n_parts", ""),
    EV_WAL_COMMIT: ("shard", "clock", ""),
    EV_PUBLISH: ("shard", "clock", "n_replicas"),
    EV_PUBLISH_PART: ("shard", "seq", "replica"),
    EV_INGEST: ("replica", "n_msgs", ""),
    EV_INGEST_PART: ("shard", "seq", "replica"),
    EV_REPLICA_VC: ("replica", "shard", "staleness"),
    EV_READ: ("slo", "staleness", "source"),
    EV_PARK: ("gateway", "", "key"),
    EV_ESCALATE: ("gateway", "", "key"),
    EV_EPOCH: ("epoch", "n_active", ""),
}
# points render as 1us slices so Perfetto can bind their flow events
_POINT_KINDS = frozenset((EV_SEND, EV_CLOCK, EV_APPLY_PART,
                          EV_PUBLISH_PART, EV_INGEST_PART, EV_REPLICA_VC,
                          EV_ESCALATE, EV_EPOCH))

SLO_ANY = -1          # EV_READ a-field encoding of slo=None
SLO_FRESH = -2        # ... and of slo="fresh"


@dataclass(frozen=True)
class TraceConfig:
    """Normalized tracing knobs (``RuntimeConfig(trace=...)`` accepts
    ``True`` for defaults, a float sample rate, or a ``{"sample":,
    "capacity":}`` dict)."""
    sample: float = 1.0       # update-lifeline sampling rate in (0, 1]
    capacity: int = 1 << 15   # events per thread ring (drop-oldest)


def normalize_trace(spec) -> Optional[TraceConfig]:
    """``RuntimeConfig.trace`` -> ``TraceConfig`` or None (off)."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return TraceConfig()
    if isinstance(spec, TraceConfig):
        cfg = spec
    elif isinstance(spec, (int, float)) and not isinstance(spec, bool):
        cfg = TraceConfig(sample=float(spec))
    elif isinstance(spec, dict):
        unknown = set(spec) - {"sample", "capacity"}
        if unknown:
            raise ValueError(f"unknown trace keys {sorted(unknown)}; "
                             f"choose from ['capacity', 'sample']")
        cfg = TraceConfig(**spec)
    else:
        raise ValueError(f"trace must be None/True, a sample rate in (0, 1], "
                         f"a dict, or a TraceConfig — got {spec!r}")
    if not (0.0 < cfg.sample <= 1.0):
        raise ValueError(f"trace sample rate must be in (0, 1], "
                         f"got {cfg.sample}")
    if cfg.capacity < 256:
        raise ValueError(f"trace ring capacity must be >= 256, "
                         f"got {cfg.capacity}")
    return cfg


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


class _Ring:
    """One thread's bounded event buffer: single-writer append, drop-oldest
    with an explicit drop counter (the reconciliation tests assert zero)."""

    __slots__ = ("name", "cap", "buf", "dropped")

    def __init__(self, name: str, cap: int):
        self.name = name
        self.cap = cap
        self.buf: deque = deque(maxlen=cap)
        self.dropped = 0

    def add(self, ev: tuple) -> None:
        if len(self.buf) == self.cap:
            self.dropped += 1
        self.buf.append(ev)


class TraceHub:
    """Per-runtime (and, forked, per-client-process) event sink.

    Each thread lazily registers one :class:`_Ring` (the only locked step);
    ``span``/``point`` then append tuples with no shared state.  ``export``
    materializes every local ring; ``adopt`` merges rings shipped from a
    forked client over the quiesce pipe."""

    def __init__(self, cfg: TraceConfig, proc_label: str = "server"):
        self.cfg = cfg
        self.proc_label = proc_label
        self._uid_thr = int(cfg.sample * float(1 << 32))
        self._rings: List[_Ring] = []
        self._frozen: List[dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- hot path ----------------------------------------------------------

    def _ring(self) -> _Ring:
        r = getattr(self._tls, "ring", None)
        if r is None:
            r = _Ring(threading.current_thread().name, self.cfg.capacity)
            self._tls.ring = r
            with self._lock:
                self._rings.append(r)
        return r

    def sampled(self, uid: int) -> bool:
        """Deterministic uid hash: the client's send and the shard's apply
        sample the same lifelines with no coordination."""
        return ((uid * 2654435761) & 0xFFFFFFFF) < self._uid_thr

    def span(self, kind: int, t0_ns: int, a=0, b=0, c=0) -> None:
        self._ring().add((kind, t0_ns, time.monotonic_ns() - t0_ns, a, b, c))

    def point(self, kind: int, a=0, b=0, c=0) -> None:
        self._ring().add((kind, time.monotonic_ns(), 0, a, b, c))

    # -- collection --------------------------------------------------------

    def export(self) -> List[dict]:
        """Materialize this process's rings (picklable: a forked client
        ships them with its final state at quiesce)."""
        with self._lock:
            rings = list(self._rings)
        return [{"proc": self.proc_label, "thread": r.name,
                 "dropped": r.dropped, "events": list(r.buf)}
                for r in rings]

    def adopt(self, exported: Iterable[dict]) -> None:
        with self._lock:
            self._frozen.extend(exported)

    def all_rings(self) -> List[dict]:
        with self._lock:
            frozen = list(self._frozen)
        return self.export() + frozen

    def events(self, kinds=None) -> Iterable[tuple]:
        want = None if kinds is None else frozenset(kinds)
        for ring in self.all_rings():
            for ev in ring["events"]:
                if want is None or ev[0] in want:
                    yield ev

    def counts(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for ev in self.events():
            out[ev[0]] = out.get(ev[0], 0) + 1
        return out

    def dropped(self) -> int:
        return sum(r["dropped"] for r in self.all_rings())


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto-loadable)
# ---------------------------------------------------------------------------


def _update_flow_id(proc: int, uid: int) -> int:
    return (int(proc) << 44) | (int(uid) & ((1 << 44) - 1))


def _publish_flow_id(shard: int, replica: int, seq: int) -> int:
    return ((1 << 62) | (int(shard) << 52) | (int(replica) << 44)
            | (int(seq) & ((1 << 44) - 1)))


def dump_chrome_trace(hub: TraceHub, path: str) -> dict:
    """Write the merged event log as Chrome trace-event JSON.

    One pid per process label (parent shards = ``server``, each forked
    client = ``client-pN``), one tid per recording thread.  Update
    lifelines ride flow events: ``send_part`` -> ``apply_part`` joined on
    ``(proc, uid)``, ``publish_part`` -> ``ingest_part`` joined on the
    publish channel's ``(shard, replica, seq)`` — the shard track is the
    shared middle hop, so a lifeline reads client -> shard -> replica.
    Returns ``{"events": n, "dropped": n, "path": path}``."""
    rings = hub.all_rings()
    pids: Dict[str, int] = {}
    out: List[dict] = []
    base_ns = min((ev[1] for r in rings for ev in r["events"]), default=0)

    for tid, ring in enumerate(rings, start=1):
        pid = pids.setdefault(ring["proc"], len(pids) + 1)
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": ring["thread"]}})
        for ev in ring["events"]:
            kind, t0, dur, a, b, c = ev
            ts = (t0 - base_ns) / 1000.0
            names = _ARGS[kind]
            args = {k: v for k, v in zip(names, (a, b, c)) if k != ""}
            rec = {"ph": "X", "name": _NAMES[kind], "cat": "ps",
                   "ts": ts, "dur": max(dur / 1000.0, 1.0),
                   "pid": pid, "tid": tid, "args": args}
            out.append(rec)
            flow = None
            if kind == EV_SEND:
                flow = ("s", _update_flow_id(a, b))
            elif kind == EV_APPLY_PART:
                flow = ("f", _update_flow_id(a, b))
            elif kind == EV_PUBLISH_PART:
                flow = ("s", _publish_flow_id(a, c, b))
            elif kind == EV_INGEST_PART:
                flow = ("f", _publish_flow_id(a, c, b))
            if flow is not None:
                ph, fid = flow
                frec = {"ph": ph, "id": fid, "name": "lifeline",
                        "cat": "lifeline", "ts": ts, "pid": pid, "tid": tid}
                if ph == "f":
                    frec["bp"] = "e"
                out.append(frec)
    for label, pid in pids.items():
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": label}})
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return {"events": sum(len(r["events"]) for r in rings),
            "dropped": hub.dropped(), "path": path}


# ---------------------------------------------------------------------------
# consistency audit trails
# ---------------------------------------------------------------------------


def explain_read(result) -> dict:
    """Why did this read land where it did?  Pure function of the
    :class:`~repro_torch.runtime.serving.gateway.ReadResult` audit stamps:
    names the exact lagging ``(shard, proc)`` pair and the vector-clock gap
    that disqualified the best replica (forcing a park/escalation), or
    reports the replica hit."""
    lagging = None
    if getattr(result, "lag_shard", -1) >= 0:
        lagging = (int(result.lag_shard), int(result.lag_proc))
    gap = int(getattr(result, "vc_gap", 0))
    if result.source == "master" and result.escalated and lagging:
        summary = (f"escalated to master: shard {lagging[0]} had applied "
                   f"only through clock vc[{lagging[1]}] of process "
                   f"{lagging[1]} on the laggiest replica — {gap} clock(s) "
                   f"behind the master frontier, above the requested "
                   f"slo={result.slo!r}")
    elif result.source == "master":
        summary = (f"served by the master (slo={result.slo!r}; "
                   f"no qualifying replica consulted or fresh requested)")
    elif result.source == "cache":
        summary = (f"cache hit re-measured at staleness "
                   f"{result.staleness} <= slo={result.slo!r}")
    else:
        summary = (f"replica served at measured staleness "
                   f"{result.staleness} <= slo={result.slo!r}")
    return {"source": result.source, "escalated": bool(result.escalated),
            "staleness": int(result.staleness), "slo": result.slo,
            "waited_s": float(result.waited_s), "lagging": lagging,
            "vc_gap": gap, "summary": summary}


def explain_block(hub: TraceHub, process: Optional[int] = None,
                  worker: Optional[int] = None) -> dict:
    """Attribute a worker's clock/value stalls to the straggler it waited
    on, from the recorded ``block_clock`` / ``block_value`` spans."""
    by_straggler: Dict[int, float] = {}
    clock_s = value_s = 0.0
    n = 0
    for kind, _t0, dur, a, b, c in hub.events((EV_BLOCK_CLOCK,
                                               EV_BLOCK_VALUE)):
        if process is not None and a != process:
            continue
        if worker is not None and b != worker:
            continue
        n += 1
        if kind == EV_BLOCK_CLOCK:
            clock_s += dur / 1e9
            if c >= 0:
                by_straggler[c] = by_straggler.get(c, 0.0) + dur / 1e9
        else:
            value_s += dur / 1e9
    straggler = (max(by_straggler, key=by_straggler.get)
                 if by_straggler else None)
    who = (f"process {process}" if process is not None else "all processes")
    if straggler is not None:
        summary = (f"{who} spent {clock_s:.3f}s clock-blocked "
                   f"(+{value_s:.3f}s value-blocked) over {n} stall(s); "
                   f"the dominant straggler holding the frontier was "
                   f"process {straggler} "
                   f"({by_straggler[straggler]:.3f}s attributed)")
    else:
        summary = (f"{who} recorded {n} stall(s): {clock_s:.3f}s "
                   f"clock-blocked, {value_s:.3f}s value-blocked")
    return {"n_blocks": n, "clock_blocked_s": clock_s,
            "value_blocked_s": value_s, "straggler": straggler,
            "by_straggler": by_straggler, "summary": summary}


def staleness_timeline(hub: TraceHub, shard: int,
                       bound: Optional[int] = None) -> dict:
    """Measured master-replica staleness over time for one shard, from the
    ``replica_vc`` adoption events, against the policy bound (None for
    value-only policies).  Points are ``(t_s, replica, staleness)`` with
    ``t_s`` relative to the first recorded event."""
    evs = sorted(hub.events((EV_REPLICA_VC,)), key=lambda e: e[1])
    base = evs[0][1] if evs else 0
    points: List[Tuple[float, int, int]] = [
        ((t0 - base) / 1e9, int(a), int(c))
        for _k, t0, _d, a, b, c in evs if b == shard]
    return {"shard": int(shard), "bound": bound,
            "max_staleness": max((p[2] for p in points), default=0),
            "points": points}
