"""Real asynchronous parameter server, with its master state on the device.

Where :mod:`repro_torch.core.server` *simulates* the paper's
bounded-asynchronous semantics in a deterministic event loop, this module
*implements* them with actual concurrency, in the style of Petuum-PS:

  * N worker threads per client process share a **process cache**
    (read-my-writes: a worker's Incs are visible to its own process
    immediately);
  * **server shards** (one thread each) own hash-partitioned rows of the
    master state — row ``r`` of a key lives on shard ``r % n_shards`` — as
    dense float64 tensors on the runtime's device, landed by the
    ``ps_apply`` kernel;
  * all edges are **FIFO per-channel queues** with sequence numbers the
    receivers assert in check mode;
  * the **Consistency Controller** (:mod:`repro_torch.core.controller`,
    shared with the simulator) gates progress: the clock bound blocks a
    worker whose period would outrun the delivery frontier
    (BSP/SSP/CAP/ESSP/CVAP), the value bound blocks an Inc that would push
    the element-wise unsynchronized accumulator past ``max(u, v_thr)``
    (VAP/CVAP), and the elastic bound blocks an Inc that would push the L2
    norm of the worker's *whole* unsynchronized sum past ``max(‖u‖₂, B)``;
  * within a period, updates are applied and sent **largest-magnitude first**
    (paper §4.2), in the order the ``topk_mag`` kernel computes; BSP/SSP
    hold them in a per-worker outbox until Clock().

Host and device: the controller, vector clocks, messages, process caches and
unsynchronized accumulators are host numpy, as in the reference (apps get
numpy views).  The device holds the shard master blocks and the kernels'
operands.  ``RuntimeConfig(device=...)`` picks it: ``"cuda"`` (default) runs
both kernels on the card, ``"cpu"`` runs their plain PyTorch versions.

Every client process is a thread group inside this Python process and
channels are in-process FIFO queues (``transport="queue"``); the wire
transports with forked clients are ROADMAP Queue 1 item 2.

The simulator stays the executable specification: given the same
``update_fn`` both produce the same set of updates, so the quiesced runtime
state must equal the simulator's final state element-wise (updates are
additive and commutative).  The port's tests assert exactly that against
the JAX package's simulator.

``barrier_reads`` (conformance mode, requires ``threads_per_process == 1``):
peer updates stamped with the reader's current period or later are staged and
applied only at the period boundary, so reads see *exactly* the updates the
consistency model guarantees and nothing fresher.  Under BSP this makes the
runtime bit-deterministic, which is what lets differential tests compare LDA
trajectories against the simulator.
"""
from __future__ import annotations

import itertools
import math
import queue
import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import canonical, state_from_reference
from repro_torch.core import controller
from repro_torch.core.server import RunStats
from repro_torch.kernels import resolve_device
from repro_torch.kernels.topk_mag import ops as topk_ops
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.membership import Partition
from repro_torch.runtime.messages import (SHUTDOWN, AckBatchMsg, Channel,
                                          ClockMarker, ClockMsg, DeliverMsg,
                                          FullyDelivered, UpdateMsg,
                                          group_by_channel, pump_inbox)
from repro_torch.runtime.metrics import (LOAD_BLOCK_CLOCK, LOAD_BLOCK_VALUE,
                                         LOAD_LEN, LOAD_UPDATES)
from repro_torch.runtime.shard import ServerShard
from repro_torch.runtime.transport import (FifoAssert, materialize_msg,
                                           release_msgs)


def _ack_batches(pairs: List[Tuple[Channel, int]], pid: int
                 ) -> List[Tuple[Channel, AckBatchMsg]]:
    """[(shard chan, uid), ...] -> one coalesced :class:`AckBatchMsg` per
    channel (VAP ack batching: a flush's acks share a single message)."""
    return [(chan, AckBatchMsg(np.asarray(uids, dtype=np.int64), pid))
            for chan, uids in group_by_channel(pairs)]


def _unsynced_norm(unsynced: Dict[str, np.ndarray]) -> float:
    """L2 norm of one worker's whole unsynchronized accumulator set."""
    sq = sum(float(np.sum(v * v)) for v in unsynced.values())
    return math.sqrt(max(sq, 0.0))


def _elastic_norms(unsynced: Dict[str, np.ndarray], key: str,
                   d2: np.ndarray) -> Tuple[float, float]:
    """(‖unsynced‖₂ before, ‖unsynced‖₂ after applying d2 to key)."""
    sq = sum(float(np.sum(v * v)) for v in unsynced.values())
    cur = unsynced[key]
    new = cur + d2
    new_sq = sq - float(np.sum(cur * cur)) + float(np.sum(new * new))
    return math.sqrt(max(sq, 0.0)), math.sqrt(max(new_sq, 0.0))


class ClientProcess:
    """A client process: shared cache + comm thread for its worker threads.

    All of it is host numpy state: the cache the apps read and the
    per-worker unsynchronized accumulators.
    """

    def __init__(self, rt, pid: int):
        self.rt = rt
        self.pid = pid
        self.cond = threading.Condition()     # guards every field below
        self.cache: Dict[str, np.ndarray] = {k: v.copy()
                                             for k, v in rt._x0.items()}
        self.workers = list(range(pid * rt.tpp, (pid + 1) * rt.tpp))
        # per-worker element-wise unsynchronized accumulators
        self.unsynced: Dict[int, Dict[str, np.ndarray]] = {
            w: {k: np.zeros_like(v) for k, v in rt._x0.items()}
            for w in self.workers}
        self.thread_clock: Dict[int, int] = {w: 0 for w in self.workers}
        self.sent_clock = 0                   # completed periods announced
        self.part: Partition = rt.partition
        # marks[p, s]: highest period of process p fully forwarded by shard s
        self.marks = np.full((rt.n_proc, rt.n_shards), -1, dtype=np.int64)
        self.staged: List[DeliverMsg] = []    # barrier_reads holding pen
        # load counters (repro_torch.runtime.metrics): bumped under locks the
        # hot paths already hold, snapshotted at clock boundaries and
        # piggybacked on the outgoing ClockMsg
        self.m_updates = 0
        self.m_block_clock = 0.0
        self.m_block_value = 0.0
        self.inbox: queue.Queue = queue.Queue()
        self._fifo = FifoAssert()             # per sender shard
        self._acks: List[Tuple[Channel, int]] = []      # (shard chan, uid)
        self.thread = threading.Thread(
            target=self._loop, name=f"ps-proc-{pid}", daemon=True)

    # ---------------------------------------------------------------- frontier
    def frontier_min(self) -> int:
        """Lowest period every peer process is known-delivered through."""
        peers = [p for p in range(self.rt.n_proc) if p != self.pid]
        if not peers:
            return 1 << 60
        return int(self.marks[peers, :].min())

    def cur_period(self) -> int:
        return min(self.thread_clock.values())

    # ---------------------------------------------------------------- comm
    def _loop(self) -> None:
        pump_inbox(self.inbox, self._handle_batch)

    def _handle_batch(self, batch: list) -> bool:
        rt = self.rt
        shutdown = False
        done = 0
        with self.cond:
            for msg in batch:
                if msg is SHUTDOWN:
                    shutdown = True
                    break
                done += 1
                try:
                    self._handle(msg)
                except BaseException as e:
                    rt._record_error(e)
            self.cond.notify_all()
        release_msgs(batch)
        # acks leave after the lock is dropped, coalesced into ONE AckBatch
        # message per (client, shard, flush)
        acks, self._acks = self._acks, []
        for chan, batch in _ack_batches(acks, self.pid):
            rt._send(chan, batch)
        # in-flight decrements strictly after the acks were enqueued, so the
        # quiesce wait never observes a transient 0 mid-conversation
        for _ in range(done):
            rt._msg_done()
        return shutdown

    def _handle(self, msg) -> None:
        """Process one message.  Caller holds ``self.cond``."""
        rt = self.rt
        if rt.check:
            err = self._fifo.check(msg.shard, msg.seq)
            if err:
                rt._violation(f"FIFO violation: shard {msg.shard}->proc "
                              f"{self.pid} {err}")
        if isinstance(msg, DeliverMsg):
            if rt.barrier_reads and msg.ts >= self.cur_period():
                # retained past this apply cycle
                self.staged.append(materialize_msg(msg))
            else:
                self._apply_delivery(msg)
                # acks only feed the unsynced accounting (VAP value bound /
                # elastic norm bound); clock-only policies skip the cycle
                if rt.policy.tracks_sync:
                    self._acks.append(
                        (rt._chan_ps[self.pid][msg.shard], msg.uid))
        elif isinstance(msg, ClockMarker):
            # max(): the frontier may never regress (channel FIFO already
            # orders markers per (proc, shard); this makes it local)
            self.marks[msg.process, msg.shard] = max(
                self.marks[msg.process, msg.shard], msg.clock)
        elif isinstance(msg, FullyDelivered):
            # exact subtraction, mirroring the simulator's VAP accounting:
            # the accumulator received exactly msg.delta when the update
            # applied, so subtracting it back is exact.  The value/strong
            # gates carry their own > 1e-12 dead zone, so float residue from
            # *other* orderings never wedges a worker.
            acc = self.unsynced[msg.worker][msg.key]
            acc[msg.rows] -= msg.delta
        else:
            raise TypeError(f"proc {self.pid}: unexpected message {msg!r}")

    def _apply_delivery(self, msg: DeliverMsg) -> None:
        self.cache[msg.key][msg.rows] += msg.delta

    def release_staged(self, new_period: int
                       ) -> List[Tuple[Channel, AckBatchMsg]]:
        """Apply staged deliveries now inside the staleness window.

        Caller holds ``self.cond`` (the ticking worker, at a period
        boundary).  Returns coalesced ack batches (one per shard channel)
        to send after the lock is dropped.
        """
        acks, keep = [], []
        for msg in self.staged:
            if msg.ts < new_period:
                self._apply_delivery(msg)
                if self.rt.policy.tracks_sync:
                    acks.append((self.rt._chan_ps[self.pid][msg.shard],
                                 msg.uid))
            else:
                keep.append(msg)
        self.staged = keep
        return _ack_batches(acks, self.pid)


class RuntimeViewHandle:
    """Read API handed to update_fn — mirrors the simulator's ViewHandle."""

    def __init__(self, rt, proc: ClientProcess, worker: int):
        self._rt = rt
        self._proc = proc
        self.worker = worker
        self.gets = 0

    def get(self, key: str) -> np.ndarray:
        self.gets += 1
        with self._proc.cond:
            flat = self._proc.cache[key].copy()
        return flat.reshape(self._rt._shapes[key])

    def keys(self) -> Sequence[str]:
        return list(self._rt._x0.keys())


class _WorkerFlowMixin:
    """The client-side worker flow.  Subclasses provide the state surface:
    ``procs``, ``policy``, ``stats``, ``_slock``, ``_total``, ``_chan_ps``,
    ``_send``/``_send_many``/``_msg_done``, ``_next_uid``, ``_check_alive``,
    ``_violation``, ``_record_error``, ``_note_global_clock``, ``device``
    and the sizing/config attributes.
    """

    # ------------------------------------------------------------ worker flow
    def _worker_loop(self, w: int) -> None:
        proc = self.procs[self.proc_of(w)]
        rng = np.random.default_rng(self.seed * 7919 + w)
        try:
            for clock in range(self.n_clocks):
                self._clock_gate(w, clock, proc)
                view = RuntimeViewHandle(self, proc, w)
                upd = self.update_fn(w, clock, view, rng)
                items = [(k, np.asarray(d, dtype=np.float64))
                         for k, d in upd.items()]
                if self.prioritize and len(items) > 1:
                    # one magnitude pass per flush, then a stable descending
                    # order (identical to the reference's per-item sort,
                    # including ties)
                    mags = np.fromiter(
                        (np.abs(d).max() if d.size else 0.0
                         for _, d in items),
                        dtype=np.float64, count=len(items))
                    items = [items[int(i)]
                             for i in self._magnitude_order(mags)]
                outbox: List[Tuple[str, np.ndarray]] = []
                for key, delta in items:
                    d2 = self._apply_update(w, clock, proc, key, delta)
                    if self.policy.norm_bounded:
                        # elastic gates on the WHOLE accumulator: a delta
                        # parked in a per-period outbox could never be
                        # acknowledged and would wedge the gate on the next
                        # key.  Send per Inc, like the simulator does.
                        self._flush_outbox(w, clock, proc, [(key, d2)])
                    else:
                        outbox.append((key, d2))
                if not self.policy.push_at_clock_only:
                    # async policies push without waiting for Clock(): one
                    # coalesced multi-row batch per shard channel per period
                    self._flush_outbox(w, clock, proc, outbox)
                    outbox = []
                self._on_clock(w, clock, proc, outbox)
        except BaseException as e:
            self._record_error(e)

    def _magnitude_order(self, mags: np.ndarray) -> np.ndarray:
        """Largest-|Δ|-first send order (paper §4.2), stable on ties: the
        ``topk_mag`` kernel on the card, its plain version on the CPU."""
        order = topk_ops.magnitude_order(torch.from_numpy(mags).to(self.device))
        return order.cpu().numpy()

    def _flush_outbox(self, w: int, clock: int, proc: ClientProcess,
                      outbox: List[Tuple[str, np.ndarray]]) -> None:
        """Split each update by the process's partition and send, one batch
        per shard channel, FIFO preserved."""
        if not outbox:
            return
        part = proc.part
        pairs: List[Tuple[Channel, UpdateMsg]] = []
        for key, d2 in outbox:
            for sid in part.active:
                rows = part.rows_of(key, sid)
                if rows.size == 0:
                    continue
                sub = d2[rows]
                nz = np.any(sub != 0.0, axis=1)
                if not nz.all():                 # elide all-zero rows
                    rows, sub = rows[nz], sub[nz]
                    if rows.size == 0:
                        continue
                msg = UpdateMsg(self._next_uid(), w, proc.pid, clock,
                                key, rows, sub, part.epoch)
                pairs.append((self._chan_ps[proc.pid][sid], msg))
        for chan, msgs in group_by_channel(pairs):
            self._send_many(chan, msgs)
        if pairs:
            with self._slock:
                self._parts_sent[proc.pid] += len(pairs)

    def _clock_gate(self, w: int, clock: int, proc: ClientProcess) -> None:
        """Block until the delivery frontier admits this period (clock bound)."""
        if self.n_proc == 1 or not self.policy.clock_bounded:
            return
        need = clock - self.policy.staleness - 1
        if need < 0:
            return
        t0 = time.monotonic()
        blocked = False
        with proc.cond:
            while proc.frontier_min() < need:
                blocked = True
                self._check_alive()
                proc.cond.wait(0.25)
            if self.check:
                st = clock - proc.frontier_min() - 1
                with self._slock:
                    self.stats.max_observed_staleness = max(
                        self.stats.max_observed_staleness, st)
                    if st > self.policy.staleness:
                        self.stats.violations.append(
                            f"staleness violation: worker {w} clock {clock} "
                            f"observed {st}")
        if blocked:
            dt = time.monotonic() - t0
            with self._slock:
                self.stats.block_time_clock += dt
                proc.m_block_clock += dt

    def _apply_update(self, w: int, clock: int, proc: ClientProcess,
                      key: str, delta: np.ndarray) -> np.ndarray:
        """Value-gate and apply to the process cache; returns the canonical
        (R, C) delta for the flush-time shard split."""
        d2 = (delta.reshape(delta.shape[0], -1) if delta.ndim > 1
              else delta.reshape(-1, 1))
        t0 = time.monotonic()
        blocked = False
        with proc.cond:
            while True:
                ok, _ = controller.value_gate(
                    self.policy, proc.unsynced[w][key], d2)
                if ok and self.policy.norm_bounded:
                    # elastic: one bound on the whole accumulator's L2 norm,
                    # re-evaluated as FullyDelivered echoes shrink it
                    acc_n, new_n = _elastic_norms(proc.unsynced[w], key, d2)
                    ok = controller.elastic_gate(self.policy, acc_n, new_n)
                if ok:
                    break
                blocked = True
                self._check_alive()
                proc.cond.wait(0.25)
            proc.cache[key] += d2                       # read-my-writes
            acc = proc.unsynced[w][key]
            acc += d2
            mag = float(np.max(np.abs(d2))) if d2.size else 0.0
            proc.m_updates += 1                         # (under proc.cond)
            with self._slock:
                self.stats.n_updates += 1
                self.stats.max_update_mag = max(self.stats.max_update_mag, mag)
                self._total[key] += d2
                if blocked:
                    dt = time.monotonic() - t0
                    self.stats.block_time_value += dt
                    proc.m_block_value += dt
                if self.check and self.policy.value_bounded:
                    bound = controller.vap_unsynced_bound(
                        self.policy, self.stats.max_update_mag)
                    mx = float(np.max(np.abs(acc)))
                    self.stats.max_unsynced_mag = max(
                        self.stats.max_unsynced_mag, mx)
                    if mx > bound + 1e-9:
                        self.stats.violations.append(
                            f"VAP violation: worker {w} unsynced {mx} > {bound}")
                if self.policy.norm_bounded:
                    dn = float(np.linalg.norm(d2)) if d2.size else 0.0
                    self.stats.max_update_norm = max(
                        self.stats.max_update_norm, dn)
                    if self.check:
                        un = _unsynced_norm(proc.unsynced[w])
                        self.stats.max_unsynced_norm = max(
                            self.stats.max_unsynced_norm, un)
                        nb = controller.elastic_unsynced_bound(
                            self.policy, self.stats.max_update_norm)
                        if un > nb + 1e-9:
                            self.stats.violations.append(
                                f"elastic violation: worker {w} unsynced "
                                f"norm {un} > {nb}")
        return d2

    def _on_clock(self, w: int, clock: int, proc: ClientProcess,
                  outbox: List[Tuple[str, np.ndarray]]) -> None:
        """Clock(): flush the SSP outbox, tick, maybe advance the process."""
        # held updates must hit the channels *before* the tick (matching the
        # sim): a sibling worker's tick may advance the process clock, and
        # its ClockMsg for this period must be FIFO-after these updates —
        # the shard's marker echo relies on exactly that channel order
        self._flush_outbox(w, clock, proc, outbox)
        advanced: List[int] = []
        staged_acks: List[Tuple[Channel, AckBatchMsg]] = []
        with proc.cond:
            proc.thread_clock[w] += 1
            new_min = proc.cur_period()     # process clock = min of threads
            while proc.sent_clock < new_min:
                advanced.append(proc.sent_clock)
                proc.sent_clock += 1
            if advanced and self.barrier_reads:
                staged_acks = proc.release_staged(new_min)
            proc.cond.notify_all()
        if advanced:
            # metrics piggyback: snapshot this process's load counters at
            # the boundary and ride them on the ClockMsg it already sends.
            # Racy counter reads only wobble a rate estimate.
            load = None
            if self.metrics_on:
                load = np.zeros(LOAD_LEN, dtype=np.float64)
                load[LOAD_UPDATES] = proc.m_updates
                load[LOAD_BLOCK_CLOCK] = proc.m_block_clock
                load[LOAD_BLOCK_VALUE] = proc.m_block_value
            part = proc.part
            pairs = [(self._chan_ps[proc.pid][sid],
                      ClockMsg(proc.pid, c, part.epoch, load))
                     for c in advanced for sid in part.active]
            for chan, msgs in group_by_channel(pairs):
                self._send_many(chan, msgs)
        for chan, msg in staged_acks:
            self._send(chan, msg)
        if advanced:
            self._note_global_clock()


class PSRuntime(_WorkerFlowMixin):
    """The concurrent asynchronous parameter server.

    Counterpart of :class:`repro_torch.core.server.AsyncPS` — same
    ``update_fn(worker, clock, view, rng)`` contract, same per-worker rng
    seeding, same :class:`RunStats` — but wall-clock concurrent instead of
    simulated.  ``NetworkModel`` / ``compute_time`` / ``straggler`` have no
    analogue here: latency and skew are real.

    Built from a :class:`~repro_torch.runtime.config.RuntimeConfig`; the
    shards' master blocks live on ``config.device``.
    """

    def __init__(self, config: RuntimeConfig):
        if not isinstance(config, RuntimeConfig):
            raise TypeError("PSRuntime(config) takes a "
                            "repro_torch.runtime.RuntimeConfig")
        cfg = config
        self.config = cfg
        self.device = resolve_device(cfg.device)
        self.P = cfg.n_workers
        self.tpp = cfg.threads_per_process
        self.n_proc = cfg.n_workers // cfg.threads_per_process
        self.n_shards = cfg.n_shards
        self.policy = cfg.policy
        self.seed = cfg.seed
        self.prioritize = cfg.prioritize_by_magnitude
        self.check = cfg.check_invariants
        self.barrier_reads = cfg.barrier_reads
        self.metrics_on = bool(cfg.metrics)

        # canonical (R, C) float64 state: on the device for the shards, on
        # the host for the process caches; original shapes for reads
        x0_dev = state_from_reference(cfg.init_params, self.device)
        self._shapes: Dict[str, Tuple[int, ...]] = {
            k: np.shape(v) for k, v in cfg.init_params.items()}
        self._x0: Dict[str, np.ndarray] = {
            k: canonical(v).copy() for k, v in cfg.init_params.items()}
        self._row_counts = {k: v.shape[0] for k, v in self._x0.items()}
        self.partition = Partition(0, tuple(range(cfg.n_shards)),
                                   self._row_counts)

        self.stats = RunStats()
        self._slock = threading.Lock()
        self._total = {k: np.zeros_like(v) for k, v in self._x0.items()}
        # zero-lost/zero-duplicated audit: update parts sent, per process
        # (matched against the shards' applied_parts at the final checks)
        self._parts_sent = np.zeros(self.n_proc, dtype=np.int64)
        self._uid = itertools.count()
        self._done_clock = 0
        self._t0 = 0.0
        self._deadline = float("inf")
        self._errors: List[BaseException] = []
        self._qcond = threading.Condition()   # guards _inflight
        self._inflight = 0

        self.shards = [ServerShard(self, s, x0_dev)
                       for s in range(self.n_shards)]
        del x0_dev                            # the shards hold their blocks
        self.procs = [ClientProcess(self, p) for p in range(self.n_proc)]
        # FIFO channels: client process -> shard, and back
        self._chan_ps = [[Channel(f"p{p}->s{s}", self.shards[s].inbox)
                          for s in range(self.n_shards)]
                         for p in range(self.n_proc)]
        self._chan_sp = [[Channel(f"s{s}->p{p}", self.procs[p].inbox)
                          for p in range(self.n_proc)]
                         for s in range(self.n_shards)]

        self.update_fn: Callable = None
        self.n_clocks = 0
        self._workers: List[threading.Thread] = []
        self._started = False
        self._finished = False

    # ------------------------------------------------------------- plumbing
    def proc_of(self, worker: int) -> int:
        return worker // self.tpp

    def _next_uid(self) -> int:
        return next(self._uid)

    def _send(self, chan, msg) -> None:
        with self._qcond:
            self._inflight += 1
        chan.send(msg)

    def _send_many(self, chan, msgs: list) -> None:
        if not msgs:
            return
        with self._qcond:
            self._inflight += len(msgs)
        chan.send_many(msgs)

    def _msg_done(self) -> None:
        with self._qcond:
            self._inflight -= 1
            if self._inflight == 0:
                self._qcond.notify_all()

    def _violation(self, text: str) -> None:
        with self._slock:
            self.stats.violations.append(text)

    def _record_error(self, e: BaseException) -> None:
        with self._slock:
            self._errors.append(e)

    def _check_alive(self) -> None:
        if time.monotonic() > self._deadline:
            raise RuntimeError(
                "runtime deadlock: wall-clock deadline exceeded "
                f"(inflight={self._inflight})")
        if self._errors:
            raise RuntimeError("runtime aborted: peer thread failed")

    # ---------------------------------------------------------------- running
    def start(self, update_fn: Callable, n_clocks: int,
              timeout: float = 120.0) -> None:
        """Launch shard/comm/worker threads; pair with :meth:`wait`."""
        if self._started:
            raise RuntimeError("runtime already started")
        self._started = True
        self.update_fn = update_fn
        self.n_clocks = n_clocks
        self._deadline = time.monotonic() + timeout
        self._t0 = time.monotonic()
        for s in self.shards:
            s.thread.start()
        for p in self.procs:
            p.thread.start()
        self._workers = [threading.Thread(target=self._worker_loop, args=(w,),
                                          name=f"ps-worker-{w}", daemon=True)
                         for w in range(self.P)]
        for t in self._workers:
            t.start()

    def wait(self) -> RunStats:
        """Join workers, quiesce all in-flight messages, run final checks."""
        if not self._started or self._finished:
            raise RuntimeError("runtime not running")
        for t in self._workers:
            while t.is_alive():
                t.join(timeout=0.5)
                if time.monotonic() > self._deadline:
                    self._record_error(RuntimeError(
                        f"worker {t.name} still alive at deadline"))
                    break
        if not self._errors:
            with self._qcond:
                while self._inflight > 0:
                    if time.monotonic() > self._deadline:
                        self._record_error(RuntimeError(
                            f"quiesce timed out ({self._inflight} in flight)"))
                        break
                    self._qcond.wait(0.25)
        self._finished = True
        for p in self.procs:
            p.inbox.put(SHUTDOWN)
        for s in self.shards:
            s.inbox.put(SHUTDOWN)
        for th in [p.thread for p in self.procs] + [s.thread for s in self.shards]:
            th.join(timeout=5.0)
        self.stats.sim_time = time.monotonic() - self._t0
        if self._errors:
            raise RuntimeError(
                f"runtime failed: {self._errors[0]!r}") from self._errors[0]
        if self.check:
            self._final_checks()
        return self.stats

    def run(self, update_fn: Callable, n_clocks: int,
            timeout: float = 120.0) -> RunStats:
        """Run every worker for ``n_clocks`` periods (start + wait)."""
        self.start(update_fn, n_clocks, timeout=timeout)
        return self.wait()

    def _note_global_clock(self) -> None:
        done = min(p.sent_clock for p in self.procs)
        with self._slock:
            while self._done_clock < done:
                self._done_clock += 1
                self.stats.clock_times.append(time.monotonic() - self._t0)

    @property
    def running(self) -> bool:
        """True while workers are still producing updates."""
        if self._finished or not self._started:
            return False
        return any(t.is_alive() for t in self._workers)

    # ------------------------------------------------------------- reads
    def read(self, key: str, process: int = 0) -> np.ndarray:
        """Serving read: a Get() against a live process cache."""
        proc = self.procs[process]
        with proc.cond:
            flat = proc.cache[key].copy()
        return flat.reshape(self._shapes[key])

    def master_value(self, key: str) -> np.ndarray:
        """Assemble the authoritative value from the shard tables, as a host
        array in the key's original shape.

        Exact once the runtime is quiesced (after :meth:`wait`); mid-run it
        is a live, per-shard-locked read of the master blocks.
        """
        out = np.zeros_like(self._x0[key])
        for shard in self.shards:
            shard.read_rows(key, out)
        return out.reshape(self._shapes[key])

    def expected_value(self, key: str) -> np.ndarray:
        """``x0 + Σ updates`` for ``key`` as the clients tallied them (host,
        original shape): what the master must equal once quiesced."""
        with self._slock:
            total = self._x0[key] + self._total[key]
        return total.reshape(self._shapes[key])

    def view(self, process: int) -> Dict[str, np.ndarray]:
        """A process cache as {key: array in the original shape}."""
        proc = self.procs[process]
        with proc.cond:
            return {k: v.copy().reshape(self._shapes[k])
                    for k, v in proc.cache.items()}

    # ------------------------------------------------------------- checks
    def _final_checks(self) -> None:
        """Eventual consistency: caches and master equal x0 + sum(updates)."""
        expected = {k: self.expected_value(k).reshape(self._x0[k].shape)
                    for k in self._x0}
        for p, proc in enumerate(self.procs):
            for k in self._x0:
                if not np.allclose(proc.cache[k], expected[k], atol=1e-6):
                    self._violation(
                        f"eventual-consistency violation on {k} (process {p})")
        for k in self._x0:
            master = self.master_value(k).reshape(self._x0[k].shape)
            if not np.allclose(master, expected[k], atol=1e-6):
                self._violation(
                    f"eventual-consistency violation on {k} (shard tables)")
        # zero-lost/zero-duplicated audit: every update part a client sent
        # was applied by exactly one shard
        applied = np.zeros(self.n_proc, dtype=np.int64)
        for s in self.shards:
            applied += s.applied_parts
        if not np.array_equal(applied, self._parts_sent):
            self._violation(
                f"update audit: parts sent {self._parts_sent.tolist()} != "
                f"applied {applied.tolist()} (lost or duplicated updates)")
