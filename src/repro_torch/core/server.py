"""Deterministic event-driven simulator of the asynchronous parameter server.

This is the *faithful semantics layer*: P worker threads,
grouped into processes, share parameters through an asynchronous PS.  Updates
propagate whenever "bandwidth is available" (CAP/VAP/CVAP) or at clock
boundaries only (BSP/SSP), subject to the Consistency Controller.  The
network is a seeded deterministic latency model, with optional stragglers.

Faithfully modelled paper semantics:
  * read-my-writes   — a worker's reads always include its own updates
                       (process-cache write-through);
  * FIFO             — per (sender-process, receiver-process) deliveries are
                       order-preserving;
  * CAP clock bound  — a worker at clock c blocks until every update stamped
                       ≤ c - s - 1 from every peer is delivered to it;
  * VAP value bound  — element-wise unsynchronized accumulators stay within
                       max(u, v_thr) via blocking (Fig. 1 semantics);
  * strong VAP       — half-synchronized update magnitude per parameter is
                       gated to max(u, v_thr), giving divergence ≤ 2·max(u,
                       v_thr) independent of P;
  * SSP              — updates leave only during the synchronization phase;
  * ESSP             — eager variant of SSP (arXiv:1410.8043): the clock gate
                       is SSP's, but propagation is eager.  In this collapsed
                       single-heap model, eager *server* push coincides with
                       eager *worker* push, so the essp spec semantics equal
                       CAP's; the kinds differ in the runtime wire mechanism
                       (the shard coalesces deliveries per destination and
                       flushes one frame per peer at each clock boundary);
  * elastic          — elastic consistency (arXiv:2001.05918): the L2 norm of
                       a worker's whole unobserved-update sum stays within
                       max(‖u‖₂, B) via blocking;
  * batching/priority— outgoing updates within a clock may be sent
                       largest-magnitude first (paper §4.2).

Clock convention (matches SSP, Ho et al. 2013): a worker whose clock value is
``c`` is computing its c-th period (0-based) and its updates are stamped
``c``; a worker at clock ``c`` is guaranteed to see every update stamped
``≤ c - s - 1``.  With s = 0 this is BSP.

The simulator is single-threaded, driven by a heap of timestamped events, and
fully deterministic given a seed — which is what lets the tests assert the
paper's bounds exactly.  It is host numpy throughout and never touches the
device: it is the executable specification the runtime is held against.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import controller
from repro_torch.core.policies import Policy
from repro_torch.core.vector_clock import VectorClock

Key = str
UpdateMap = Dict[Key, np.ndarray]


# ---------------------------------------------------------------------------
# Network model
# ---------------------------------------------------------------------------


class NetworkModel:
    """Deterministic per-message latency: base + seeded jitter.

    ``bandwidth`` (bytes/sim-second) adds a serialization term so that large
    rows cost more — enough structure for the scalability benchmark.
    """

    def __init__(self, base_delay: float = 0.05, jitter: float = 0.05,
                 bandwidth: float = float("inf"), seed: int = 0):
        self.base_delay = base_delay
        self.jitter = jitter
        self.bandwidth = bandwidth
        self.seed = seed

    def delay(self, sender: int, receiver: int, nbytes: int, seq: int) -> float:
        h = np.uint64(hash((self.seed, sender, receiver, seq)) & 0xFFFFFFFF)
        u = float(h) / float(0xFFFFFFFF)
        ser = nbytes / self.bandwidth if self.bandwidth != float("inf") else 0.0
        return self.base_delay + self.jitter * u + ser


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------


@dataclass
class Update:
    uid: int
    worker: int                  # global thread id
    process: int
    ts: int                      # clock timestamp (0-based period index)
    seq: int                     # per-process FIFO sequence number (-1: unsent)
    key: Key
    delta: np.ndarray
    t_created: float
    delivered_to: set = field(default_factory=set)
    delivery_started: bool = False
    t_fully_delivered: Optional[float] = None

    @property
    def nbytes(self) -> int:
        return int(self.delta.nbytes)


@dataclass
class RunStats:
    sim_time: float = 0.0
    n_updates: int = 0
    n_messages: int = 0
    bytes_sent: int = 0
    # runtime VAP ack traffic: messages vs updates acked inside them — the
    # coalescing ratio of the per-(client, shard, flush) ack batching
    n_ack_msgs: int = 0
    n_acked_updates: int = 0
    block_time_clock: float = 0.0
    block_time_value: float = 0.0
    max_observed_staleness: int = 0
    max_unsynced_mag: float = 0.0
    max_update_mag: float = 0.0
    # elastic-consistency accounting: L2 norms of whole unsynced sums / deltas
    max_unsynced_norm: float = 0.0
    max_update_norm: float = 0.0
    max_divergence: float = 0.0
    max_halfsync_mag: float = 0.0
    divergence_trace: List[Tuple[float, float]] = field(default_factory=list)
    clock_times: List[float] = field(default_factory=list)
    violations: List[str] = field(default_factory=list)

    @property
    def throughput(self) -> float:
        """Clocks completed by all workers per simulated second."""
        if not self.clock_times or self.sim_time == 0:
            return 0.0
        return len(self.clock_times) / self.clock_times[-1]


# worker states
_COMPUTING, _APPLYING, _CLOCK_BLOCKED, _VALUE_BLOCKED, _DONE = range(5)


class AsyncPS:
    """The asynchronous parameter server simulator.

    Parameters
    ----------
    n_workers:        total worker threads (paper: a thread is a worker)
    policy:           consistency policy
    init_params:      key -> initial numpy array (the x0 of §3)
    threads_per_process: co-located workers sharing a process cache
    compute_time:     simulated seconds of computation per clock period —
                      a float, or a callable(worker_id) -> float so strong-
                      scaling workloads can make clocks shard-proportional
    straggler:        worker id -> compute-time multiplier
    """

    def __init__(self, n_workers: int, policy: Policy,
                 init_params: UpdateMap,
                 network: Optional[NetworkModel] = None,
                 threads_per_process: int = 1,
                 compute_time: float = 1.0,
                 straggler: Optional[Dict[int, float]] = None,
                 seed: int = 0,
                 prioritize_by_magnitude: bool = True,
                 check_invariants: bool = True):
        if n_workers % threads_per_process:
            raise ValueError("n_workers must divide into processes evenly")
        self.P = n_workers
        self.tpp = threads_per_process
        self.n_proc = n_workers // threads_per_process
        self.policy = policy
        self.network = network or NetworkModel(seed=seed)
        self.compute_time = compute_time
        self.straggler = straggler or {}
        self.prioritize = prioritize_by_magnitude
        self.check = check_invariants
        self._rngs = [np.random.default_rng(seed * 7919 + w) for w in range(n_workers)]

        self.x0 = {k: np.asarray(v, dtype=np.float64) for k, v in init_params.items()}
        # process caches (views): process -> key -> array
        self.views = [dict((k, v.copy()) for k, v in self.x0.items())
                      for _ in range(self.n_proc)]
        # per-thread element-wise unsynchronized accumulators
        self.unsynced = [dict((k, np.zeros_like(v)) for k, v in self.x0.items())
                         for _ in range(n_workers)]
        # strong-VAP half-synchronized magnitude per key (server-side)
        self.halfsync = {k: np.zeros_like(v) for k, v in self.x0.items()}
        # deliveries waiting on the strong gate, per key (FIFO)
        self.delivery_queue: Dict[Key, List[Update]] = defaultdict(list)

        self.thread_clock = VectorClock(n_workers)
        self.process_clock = VectorClock(self.n_proc)

        # FIFO delivery bookkeeping
        self._last_sched: Dict[Tuple[int, int], float] = defaultdict(float)
        self._delivered_prefix = np.zeros((self.n_proc, self.n_proc), dtype=np.int64)
        self._proc_seq = [0] * self.n_proc
        # per sender process: cumulative seq count sealed at the end of each period
        self._clock_end_seq: List[List[int]] = [[] for _ in range(self.n_proc)]
        # per (sender_proc, recv_proc): last delivered seq, to assert FIFO
        self._last_seq_seen = defaultdict(lambda: -1)

        self.updates: List[Update] = []
        self._uid = itertools.count()
        self._evt = itertools.count()
        self.events: List[Tuple[float, int, str, object]] = []
        self.stats = RunStats()
        self.t = 0.0

        self._state = [_COMPUTING] * n_workers
        self._blocked_since = [0.0] * n_workers
        self._pending: List[List[Tuple[Key, np.ndarray]]] = [[] for _ in range(n_workers)]
        self._pending_idx = [0] * n_workers
        self._outbox: List[List[Update]] = [[] for _ in range(n_workers)]
        self._done_clock = 0
        self.update_fn: Optional[Callable] = None
        self.n_clocks = 0

    # ------------------------------------------------------------------ utils
    def proc_of(self, worker: int) -> int:
        return worker // self.tpp

    def _push_event(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self.events, (t, next(self._evt), kind, payload))

    def _unsynced_norm(self, w: int) -> float:
        """L2 norm of worker w's whole unsynchronized accumulator set."""
        sq = sum(float(np.sum(v * v)) for v in self.unsynced[w].values())
        return math.sqrt(max(sq, 0.0))

    def _elastic_norms(self, w: int, key: Key,
                       delta: np.ndarray) -> Tuple[float, float]:
        """(‖unsynced‖₂ before, ‖unsynced‖₂ after applying delta to key)."""
        sq = sum(float(np.sum(v * v)) for v in self.unsynced[w].values())
        cur = self.unsynced[w][key]
        new = cur + delta
        new_sq = sq - float(np.sum(cur * cur)) + float(np.sum(new * new))
        return math.sqrt(max(sq, 0.0)), math.sqrt(max(new_sq, 0.0))

    def _frontier(self, recv_proc: int) -> np.ndarray:
        """For each other process q: the highest period p such that every
        update from q stamped ≤ p has been delivered to recv_proc."""
        res = []
        for q in range(self.n_proc):
            if q == recv_proc:
                continue
            prefix = self._delivered_prefix[q, recv_proc]
            ends = self._clock_end_seq[q]
            f = 0
            while f < len(ends) and ends[f] <= prefix:
                f += 1
            res.append(f - 1)
        return np.asarray(res, dtype=np.int64)

    # ---------------------------------------------------------------- running
    def run(self, update_fn: Callable, n_clocks: int,
            divergence_every: float = 0.0) -> RunStats:
        """Run every worker for ``n_clocks`` periods.

        update_fn(worker_id, clock, view: ViewHandle, rng) -> {key: delta}
        """
        self.update_fn = update_fn
        self.n_clocks = n_clocks
        for w in range(self.P):
            self._schedule_compute(w)
        next_div = divergence_every if divergence_every > 0 else float("inf")

        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            self.t = max(self.t, t)
            if kind == "compute_done":
                self._on_compute_done(payload)
            elif kind == "deliver":
                self._on_deliver(*payload)
            if self.t >= next_div:
                self._record_divergence()
                next_div = self.t + divergence_every
        if not all(s == _DONE for s in self._state):
            blocked = [w for w in range(self.P) if self._state[w] != _DONE]
            raise RuntimeError(f"simulator deadlock: workers {blocked} not done "
                               f"(states {[self._state[w] for w in blocked]})")
        self.stats.sim_time = self.t
        self._record_divergence()
        if self.check:
            self._final_checks()
        return self.stats

    # ------------------------------------------------------------ worker flow
    def _schedule_compute(self, w: int) -> None:
        self._state[w] = _COMPUTING
        mult = self.straggler.get(w, 1.0)
        base = (self.compute_time(w) if callable(self.compute_time)
                else self.compute_time)
        self._push_event(self.t + base * mult, "compute_done", w)

    def _on_compute_done(self, w: int) -> None:
        clock = self.thread_clock.get(w)
        view = ViewHandle(self, w)
        if self.check and self.n_proc > 1:
            fr = self._frontier(self.proc_of(w))
            st = controller.observed_staleness(clock, fr)
            self.stats.max_observed_staleness = max(self.stats.max_observed_staleness, st)
            if self.policy.clock_bounded and st > self.policy.staleness + 1:
                # +1: the first period has nothing to wait for by definition
                self.stats.violations.append(
                    f"staleness violation: worker {w} clock {clock} observed {st}")
        upd = self.update_fn(w, clock, view, self._rngs[w])
        items = list(upd.items())
        if self.prioritize:
            items.sort(key=lambda kv: -float(np.max(np.abs(kv[1]))))
        self._pending[w] = [(k, np.asarray(d, dtype=np.float64)) for k, d in items]
        self._pending_idx[w] = 0
        self._state[w] = _APPLYING
        self._apply_loop(w)

    def _apply_loop(self, w: int) -> None:
        """Apply pending updates; may park the worker on the value gate."""
        while self._pending_idx[w] < len(self._pending[w]):
            key, delta = self._pending[w][self._pending_idx[w]]
            ok, _ = controller.value_gate(self.policy, self.unsynced[w][key], delta)
            if ok and self.policy.norm_bounded:
                acc_n, new_n = self._elastic_norms(w, key, delta)
                ok = controller.elastic_gate(self.policy, acc_n, new_n)
            if not ok:
                if self._state[w] != _VALUE_BLOCKED:
                    self._state[w] = _VALUE_BLOCKED
                    self._blocked_since[w] = self.t
                return
            if self._state[w] == _VALUE_BLOCKED:
                self.stats.block_time_value += self.t - self._blocked_since[w]
                self._state[w] = _APPLYING
            self._apply_update(w, key, delta)
            self._pending_idx[w] += 1
        self._on_clock(w)

    def _apply_update(self, w: int, key: Key, delta: np.ndarray) -> None:
        pr = self.proc_of(w)
        ts = self.thread_clock.get(w)        # stamped with the current period
        u = Update(uid=next(self._uid), worker=w, process=pr, ts=ts,
                   seq=-1, key=key, delta=delta.copy(), t_created=self.t)
        self.updates.append(u)
        self.stats.n_updates += 1
        m = float(np.max(np.abs(delta))) if delta.size else 0.0
        self.stats.max_update_mag = max(self.stats.max_update_mag, m)
        # read-my-writes: own process cache sees it immediately
        self.views[pr][key] = self.views[pr][key] + delta
        self.unsynced[w][key] = self.unsynced[w][key] + delta
        dn = float(np.linalg.norm(delta)) if delta.size else 0.0
        self.stats.max_update_norm = max(self.stats.max_update_norm, dn)
        if self.check:
            bound = controller.vap_unsynced_bound(self.policy, self.stats.max_update_mag)
            mx = float(np.max(np.abs(self.unsynced[w][key])))
            self.stats.max_unsynced_mag = max(self.stats.max_unsynced_mag, mx)
            if self.policy.value_bounded and mx > bound + 1e-12:
                self.stats.violations.append(
                    f"VAP violation: worker {w} unsynced {mx} > {bound}")
            un = self._unsynced_norm(w)
            self.stats.max_unsynced_norm = max(self.stats.max_unsynced_norm, un)
            if self.policy.norm_bounded:
                nb = controller.elastic_unsynced_bound(
                    self.policy, self.stats.max_update_norm)
                if un > nb + 1e-9:
                    self.stats.violations.append(
                        f"elastic violation: worker {w} "
                        f"unsynced norm {un} > {nb}")
        if self.n_proc == 1:
            u.delivery_started = True
            u.t_fully_delivered = self.t
            self.unsynced[w][key] = self.unsynced[w][key] - u.delta
            return
        if self.policy.push_at_clock_only:
            self._outbox[w].append(u)
        else:
            self._try_start_delivery(u)

    def _try_start_delivery(self, u: Update) -> None:
        """Start propagation, subject to the strong-VAP half-sync gate."""
        if self.delivery_queue[u.key] or not controller.strong_delivery_gate(
                self.policy, self.halfsync[u.key], u.delta):
            self.delivery_queue[u.key].append(u)
            return
        self._start_delivery(u)

    def _start_delivery(self, u: Update) -> None:
        u.delivery_started = True
        u.seq = self._proc_seq[u.process]
        self._proc_seq[u.process] += 1
        self.halfsync[u.key] = self.halfsync[u.key] + np.abs(u.delta)
        if self.check:
            mx = float(np.max(self.halfsync[u.key]))
            self.stats.max_halfsync_mag = max(self.stats.max_halfsync_mag, mx)
        pr = u.process
        for q in range(self.n_proc):
            if q == pr:
                continue
            d = self.network.delay(pr, q, u.nbytes, u.seq)
            t_del = max(self.t + d, self._last_sched[(pr, q)] + 1e-9)  # FIFO
            self._last_sched[(pr, q)] = t_del
            self._push_event(t_del, "deliver", (u.uid, q))
            self.stats.n_messages += 1
            self.stats.bytes_sent += u.nbytes

    def _on_deliver(self, uid: int, q: int) -> None:
        u = self.updates[uid]
        if self.check:
            last = self._last_seq_seen[(u.process, q)]
            if u.seq <= last:
                self.stats.violations.append(
                    f"FIFO violation: proc {u.process}->{q} seq {u.seq} after {last}")
            self._last_seq_seen[(u.process, q)] = u.seq
        u.delivered_to.add(q)
        self.views[q][u.key] = self.views[q][u.key] + u.delta
        self._delivered_prefix[u.process, q] += 1
        if len(u.delivered_to) == self.n_proc - 1:
            u.t_fully_delivered = self.t
            # exact subtraction: the accumulators received exactly u.delta /
            # |u.delta| when the update started, so the inverse is exact —
            # snapping sub-1e-12 residuals to zero here could discard other
            # legitimately in-flight tiny deltas sharing the accumulator
            # (the value/strong gates keep their own > 1e-12 dead zone, so
            # residue from mixed orderings never wedges a worker).  Keeps
            # the spec in lockstep with the runtime's VAP accounting.
            self.unsynced[u.worker][u.key] = \
                self.unsynced[u.worker][u.key] - u.delta
            self.halfsync[u.key] = self.halfsync[u.key] - np.abs(u.delta)
            # half-sync budget freed: release queued deliveries for this key
            dq = self.delivery_queue.get(u.key)
            while dq:
                nxt = dq[0]
                if controller.strong_delivery_gate(self.policy, self.halfsync[nxt.key], nxt.delta):
                    dq.pop(0)
                    self._start_delivery(nxt)
                else:
                    break
            self._wake_value_blocked()
        self._wake_clock_blocked()

    def _wake_value_blocked(self) -> None:
        for w in range(self.P):
            if self._state[w] == _VALUE_BLOCKED:
                self._apply_loop(w)

    def _wake_clock_blocked(self) -> None:
        for w in range(self.P):
            if self._state[w] == _CLOCK_BLOCKED:
                self._check_clock_gate(w)

    # ---------------------------------------------------------------- clocks
    def _on_clock(self, w: int) -> None:
        """Worker finished applying its updates for this period: Clock()."""
        pr = self.proc_of(w)
        # SSP/BSP: this thread's updates leave during its synchronization phase
        for u in self._outbox[w]:
            self._try_start_delivery(u)
        self._outbox[w] = []
        new_clock = self.thread_clock.tick(w)
        # process clock = min of its threads (paper §4.2)
        lo = min(self.thread_clock.get(t)
                 for t in range(pr * self.tpp, (pr + 1) * self.tpp))
        while self.process_clock.get(pr) < lo:
            # the process completed a period: seal its cumulative seq count
            self._clock_end_seq[pr].append(self._proc_seq[pr])
            self.process_clock.set(pr, self.process_clock.get(pr) + 1)
        self._wake_clock_blocked()
        if min(self.thread_clock.get(t) for t in range(self.P)) > self._done_clock:
            self._done_clock += 1
            self.stats.clock_times.append(self.t)
        if new_clock >= self.n_clocks:
            self._state[w] = _DONE
            return
        self._check_clock_gate(w, first=True)

    def _check_clock_gate(self, w: int, first: bool = False) -> None:
        if self.n_proc == 1:
            self._schedule_compute(w)
            return
        fr = self._frontier(self.proc_of(w))
        if controller.clock_gate(self.policy, self.thread_clock.get(w), fr):
            if self._state[w] == _CLOCK_BLOCKED:
                self.stats.block_time_clock += self.t - self._blocked_since[w]
            self._schedule_compute(w)
        else:
            if first or self._state[w] != _CLOCK_BLOCKED:
                self._blocked_since[w] = self.t
            self._state[w] = _CLOCK_BLOCKED

    # ------------------------------------------------------------- reporting
    def _record_divergence(self) -> None:
        if self.n_proc < 2:
            return
        worst = 0.0
        for k in self.x0:
            stack = np.stack([v[k] for v in self.views])
            worst = max(worst, float(np.max(stack.max(0) - stack.min(0))))
        self.stats.max_divergence = max(self.stats.max_divergence, worst)
        self.stats.divergence_trace.append((self.t, worst))

    def _final_checks(self) -> None:
        # eventual consistency: once everything is delivered all views agree
        totals = {k: v.copy() for k, v in self.x0.items()}
        for u in self.updates:
            totals[u.key] = totals[u.key] + u.delta
        for k in self.x0:
            for q in range(self.n_proc):
                if not np.allclose(self.views[q][k], totals[k], atol=1e-6):
                    self.stats.violations.append(
                        f"eventual-consistency violation on {k} (process {q})")

    def master_value(self, key: Key) -> np.ndarray:
        total = self.x0[key].copy()
        for u in self.updates:
            if u.key == key:
                total = total + u.delta
        return total


class ViewHandle:
    """Read API handed to update_fn — a Get() through the cache hierarchy."""

    def __init__(self, ps: AsyncPS, worker: int):
        self._ps = ps
        self._worker = worker
        self.worker = worker
        self.gets = 0

    def get(self, key: Key) -> np.ndarray:
        self.gets += 1
        return self._ps.views[self._ps.proc_of(self._worker)][key].copy()

    def keys(self) -> Sequence[Key]:
        return list(self._ps.x0.keys())
