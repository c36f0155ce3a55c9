"""The chaos / fault-injection suite (``tests/test_chaos.py``) on the port.

The workloads, the seeded random schedules and the membership fault
scripts are the JAX package's own pure-numpy helpers (``tests/chaos.py``:
``det_fn``, ``zipf_fn``, ``expected_final``, ``random_schedule``,
``random_membership_script``); this file ports the runtime side of the
harness onto ``repro_torch`` (:func:`chaos_run`, :func:`assert_counters`,
:func:`assert_wal_recovery` with ``recover_to_vc(device="cpu")``,
:class:`ReplicaWedger`, :class:`SloReader`) and mirrors every test of the
reference file with its ``slow`` marks, parameters and seeds:

* **simulator leg** — the port's ``AsyncPS`` on the same seeded schedule as
  the JAX package's: the paper's bounds hold exactly on what it observed,
  and its final state and stats equal the reference's;
* **runtime leg** — a free 4-worker interleaving with seeded membership
  faults (add / remove / kill+rejoin), the autoscaler as the churn driver,
  a gateway under SLO'd reads and a replica wedger: final state == x0 +
  sum(updates) bitwise, no recorded violation, zero lost or duplicated
  updates by counter audit, every SLO stamp within its request.

No assertion depends on scheduling.  Where the reference asserts that a
scripted fault fired (or that the autoscaler churned at least once) before
the run ended, the mirror holds every worker at its last clock until the
membership log shows it (:class:`_OpGate`, a counter in shared memory that
forked clients read too): the fault can no longer lose a race against the
run's end.  The deltas, and so the expected state, are unchanged.  Every
wait has its own deadline.  The runs use ``device="cpu"``: every shard
apply, held-epoch replay and replica ingest goes through ``ps_apply``'s
wrapper into its plain version.
"""
import multiprocessing
import threading
import time
from dataclasses import asdict
from typing import List, Optional

import numpy as np
import pytest

import chaos
from chaos import (assert_paper_bounds, det_fn, expected_final,
                   random_membership_script, random_schedule,
                   run_sim_schedule, x0, zipf_fn)
from repro.core import policies as ref_policies
from repro.runtime import AutoscalePolicy as RefAutoscalePolicy
from repro_torch.core import policies
from repro_torch.core.policies import Policy
from repro_torch.core.server import AsyncPS, NetworkModel
from repro_torch.runtime import (Autoscaler, AutoscalePolicy, MembershipPlan,
                                 PSRuntime, ReadGateway, ReadShedError,
                                 RuntimeConfig, recover_to_vc)

pytestmark = [pytest.mark.chaos,
              pytest.mark.filterwarnings("ignore:os.fork:RuntimeWarning")]

# chaos runs record a lightly sampled trace, as the reference's do
CHAOS_TRACE = {"sample": 0.05}
# how long a worker at its last clock waits for the membership ops the
# test asserts on (far beyond an op's cost; the runs' own timeouts are
# longer still)
GATE_S = 60.0


def port_policy(ref_pol) -> Policy:
    """The port's Policy with the reference policy's fields."""
    return Policy(**asdict(ref_pol))


def chaos_autoscale_policy() -> AutoscalePolicy:
    """The reference harness's aggressive knobs, on the port's class."""
    from chaos import chaos_autoscale_policy as ref_knobs
    knobs = ref_knobs()
    assert isinstance(knobs, RefAutoscalePolicy)
    return AutoscalePolicy(**asdict(knobs))


class _OpGate:
    """Hold every worker at its last clock until ``want`` membership ops
    completed (or ``GATE_S`` passed).  The counter lives in shared memory
    made before ``start()``, so forked clients read the parent's count; a
    membership listener bumps it after each install."""

    def __init__(self, rt, want: int, n_clocks: int):
        self.count = multiprocessing.get_context("fork").Value("i", 0)
        self.want = want
        self.n_clocks = n_clocks
        rt.membership.add_listener(self._on_epoch)

    def _on_epoch(self, *args) -> None:
        with self.count.get_lock():
            self.count.value += 1

    def wrap(self, fn):
        count, want, last = self.count, self.want, self.n_clocks - 1

        def gated(w, clock, view, rng):
            if clock == last and want:
                deadline = time.monotonic() + GATE_S
                while count.value < want and time.monotonic() < deadline:
                    time.sleep(0.005)
            return fn(w, clock, view, rng)
        return gated


class ReplicaWedger:
    """Seeded replica fault injector: wedges a random replica's publish
    edges, holds, releases, repeats; stands down once the completed-clock
    frontier passes ``quiet_after`` (the reference harness's)."""

    def __init__(self, rset, seed: int, rt=None, quiet_after: int = 0,
                 period: float = 0.05):
        self.rset = rset
        self.rt = rt
        self.quiet_after = quiet_after
        self.rng = np.random.default_rng(seed ^ 0xFA11)
        self.period = period
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="chaos-wedger")

    def _quiet(self) -> bool:
        return (self.rt is not None and self.quiet_after
                and self.rt.completed_clock() >= self.quiet_after)

    def _run(self) -> None:
        while not self._stop.is_set() and not self._quiet():
            rid = int(self.rng.integers(0, len(self.rset.replicas)))
            self.rset.wedge(rid, True)
            time.sleep(self.period * float(self.rng.uniform(0.5, 2.0)))
            self.rset.wedge(rid, False)
            time.sleep(self.period * float(self.rng.uniform(0.2, 1.0)))
        for rep in self.rset.replicas:
            self.rset.wedge(rep.rid, False)

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=10.0)
        for rep in self.rset.replicas:
            self.rset.wedge(rep.rid, False)


class SloReader:
    """Background gateway reader cycling SLOs; records any stamp that
    exceeds its request (there must be none, ever — including during the
    migration window)."""

    def __init__(self, gw: ReadGateway, keys=("a", "b")):
        self.gw = gw
        self.keys = keys
        self.bad: List[tuple] = []
        self.errors: List[BaseException] = []
        self.n_reads = 0
        self.n_shed = 0
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="chaos-slo-reader")

    def _run(self) -> None:
        slos = [0, 1, 3, None, "fresh"]
        i = 0
        while not self._stop.is_set():
            slo = slos[i % len(slos)]
            key = self.keys[i % len(self.keys)]
            i += 1
            try:
                res = self.gw.read(key, slo=slo, timeout=10.0)
            except ReadShedError:            # admission control: expected
                self.n_shed += 1
                continue
            except BaseException as e:       # a dead reader would make the
                self.errors.append(e)        # SLO assertions pass vacuously
                return
            self.n_reads += 1
            if isinstance(slo, int) and res.staleness > slo:
                self.bad.append((slo, res.staleness, res.source))

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=10.0)


def _replicas_caught_up(rset, budget: float = 30.0) -> set:
    """Wait (bounded) until every live, non-stale replica's vc reaches the
    quiesced master frontier (vc stamps ride FIFO-behind their deltas, so
    a caught-up vc means its values landed); returns the replicas still
    lagging at the deadline."""
    mvc = rset.master_vc()

    def lagging() -> set:
        stale = rset.stale_replicas
        return {rep.rid for rep in rset.replicas
                if not rep.poisoned and rep.rid not in stale
                and rset.staleness(rep.vc, mvc) > 0}

    deadline = time.monotonic() + budget
    while lagging() and time.monotonic() < deadline:
        time.sleep(0.02)
    return lagging()


def chaos_run(seed: int, pol, n_clocks: int, transport: str = "queue",
              max_shards: int = 4, n_events: int = 4, serving: bool = False,
              wedge: bool = False, serving_transport: str = "queue",
              autoscale: bool = False, fn=None, wal_dir: Optional[str] = None,
              timeout: float = 110.0):
    """One chaos leg on the port (the reference harness's ``chaos_run``):
    a free 4-worker run with the seeded membership faults of
    ``random_membership_script`` (or, with ``autoscale``, the autoscaler
    as the churn driver), optionally a gateway under SLO'd reads and a
    replica wedger.  Returns ``(rt, stats, plan, reader)``; the started
    autoscaler is ``rt.autoscaler``."""
    ref_plan = None if autoscale else random_membership_script(
        seed, n_clocks, n_shards=2, max_shards=max_shards, n_events=n_events)
    plan = (None if ref_plan is None else MembershipPlan.parse(
        [(e.clock, e.op, e.sid) for e in ref_plan.events]))
    rt = PSRuntime(RuntimeConfig(4, pol, x0(), n_shards=2,
                                 threads_per_process=2, seed=seed,
                                 max_shards=max_shards, transport=transport,
                                 membership_plan=plan, wal_dir=wal_dir,
                                 trace=CHAOS_TRACE, device="cpu"))
    # the post-mortem hook in conftest.py dumps this runtime's trace and
    # metrics to test-artifacts/<test>/ when a chaos test fails
    chaos.LAST_RT = rt
    gate = _OpGate(rt, 1 if autoscale else len(plan.events), n_clocks)
    reader = wedger = gw = asc = None
    rt.start(gate.wrap(det_fn(seed) if fn is None else fn), n_clocks,
             timeout=timeout)
    try:
        if serving:
            gw = ReadGateway(rt, n_replicas=2, transport=serving_transport)
            reader = SloReader(gw)
            reader.start()
            if wedge:
                wedger = ReplicaWedger(gw.replicas, seed, rt=rt,
                                       quiet_after=int(n_clocks * 0.7))
                wedger.start()
        if autoscale:
            asc = Autoscaler(rt, gw, chaos_autoscale_policy()).start()
            rt.autoscaler = asc
        stats = rt.wait()
    finally:
        if asc is not None:
            asc.stop()
        if wedger is not None:
            wedger.stop()
        if reader is not None:
            reader.stop()
    if gw is not None:
        rset = gw.replicas
        reader.replica_errors = list(rset.errors)
        # a replica still lagging at the deadline did not finish un-stale
        # and is excluded like a stale one (the callers' `assert
        # reader.final_replicas` guards against everyone ending so)
        skip = rset.stale_replicas | _replicas_caught_up(rset)
        reader.final_replicas = [
            {k: rep.serve(k)[0] for k in x0()}
            for rep in rset.replicas
            if not rep.poisoned and rep.rid not in skip]
        gw.close()
    return rt, stats, plan, reader


def assert_counters(rt) -> None:
    """Explicit zero-lost / zero-duplicated audit: every update part each
    client process sent was applied by exactly one shard slot."""
    applied = np.zeros(rt.n_proc, dtype=np.int64)
    for s in rt.shards:
        applied += s.applied_parts
    assert applied.tolist() == rt._parts_sent.tolist(), (
        f"lost/duplicated updates: sent {rt._parts_sent.tolist()} "
        f"applied {applied.tolist()}")


def assert_wal_recovery(rt, seed: int, n_clocks: int, wal_dir: str,
                        fn=None) -> None:
    """Rebuild the state from the log alone (``recover_to_vc`` replaying on
    the CPU): every part each process sent folded in exactly once, and the
    recovered state bitwise the membership-free expectation."""
    rec = recover_to_vc(x0(), wal_dir, device="cpu")
    assert rec["applied_parts"].tolist() == rt._parts_sent.tolist(), (
        f"wal recovery lost/duplicated updates: sent "
        f"{rt._parts_sent.tolist()} recovered "
        f"{rec['applied_parts'].tolist()} (deduped {rec['n_deduped']})")
    for k, v in expected_final(seed, 4, n_clocks, fn=fn).items():
        np.testing.assert_array_equal(
            rec["params"][k], v,
            err_msg=f"wal-recovered state diverges from the membership-free "
                    f"expectation for {k!r}")


# ---------------------------------------------------------------------------
# simulator leg: seeded random schedules obey the Lemma bounds exactly
# ---------------------------------------------------------------------------


def _port_sim_schedule(sched: dict, n_clocks: int):
    """The reference's ``run_sim_schedule`` on the port's simulator."""
    net = sched["network"]
    ps = AsyncPS(sched["n_workers"], port_policy(sched["policy"]), x0(),
                 network=NetworkModel(base_delay=net.base_delay,
                                      jitter=net.jitter, seed=net.seed),
                 threads_per_process=sched["tpp"],
                 compute_time=sched["compute_time"],
                 straggler=sched["straggler"], seed=sched["seed"])
    return ps, ps.run(det_fn(sched["seed"]), n_clocks)


def _sim_leg(seed: int, n_clocks: int):
    sched = random_schedule(seed)
    ps, stats = _port_sim_schedule(sched, n_clocks)
    assert_paper_bounds(sched["policy"], stats)
    assert stats.n_updates == sched["n_workers"] * n_clocks * 2
    ref_ps, ref_stats = run_sim_schedule(sched, n_clocks)
    for name in ("n_updates", "n_messages", "max_observed_staleness",
                 "max_unsynced_mag", "max_update_mag", "max_unsynced_norm",
                 "max_halfsync_mag", "sim_time"):
        assert getattr(stats, name) == getattr(ref_stats, name), name
    for k, ref in ref_ps.views[0].items():
        np.testing.assert_array_equal(ps.views[0][k], ref)
    return sched["policy"], stats


@pytest.mark.parametrize("seed", range(4))
def test_sim_random_schedule_bounds_smoke(seed):
    _sim_leg(seed, 30)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_sim_random_schedule_bounds_full(seed):
    """200-clock runs: long enough that staleness, value-gate blocking and
    strong-VAP queueing actually engage."""
    pol, stats = _sim_leg(seed, 200)
    if pol.clock_bounded:
        assert stats.max_observed_staleness >= 0
    if pol.value_bounded:
        assert stats.max_unsynced_mag > 0.0


# ---------------------------------------------------------------------------
# runtime leg: membership faults under free interleaving
# ---------------------------------------------------------------------------

_POLICIES = [
    ("ssp3", policies.ssp(3)),
    ("essp3", policies.essp(3)),
    ("vap", policies.vap(4.5)),
    ("cvap", policies.cvap(3, 4.5)),
    ("elastic", policies.elastic(12.0)),
]
_IDS = [p[0] for p in _POLICIES]


def test_policies_match_the_reference_suite():
    ref = [ref_policies.ssp(3), ref_policies.essp(3), ref_policies.vap(4.5),
           ref_policies.cvap(3, 4.5), ref_policies.elastic(12.0)]
    assert [port_policy(r) for r in ref] == [p for _, p in _POLICIES]


def _assert_chaos_outcome(rt, stats, plan, seed, n_clocks):
    assert stats.violations == [], stats.violations[:5]
    fired = [r for _, r in plan.results if r == "ok"]
    assert len(fired) == len(plan.events), plan.results   # every fault fired
    assert_counters(rt)
    assert stats.n_updates == 4 * n_clocks * 2
    if rt.policy.clock_bounded:
        assert stats.max_observed_staleness <= rt.policy.staleness
    for k, ref in expected_final(seed, 4, n_clocks).items():
        np.testing.assert_array_equal(
            rt.master_value(k).reshape(ref.shape), ref,
            err_msg=f"chaos seed={seed} master[{k}]")


@pytest.mark.parametrize("polname,pol", _POLICIES, ids=_IDS)
def test_runtime_membership_chaos_smoke(polname, pol, tmp_path):
    """Membership chaos with the durability tier on: besides the live-state
    assertions, the WAL alone reconstructs the exact final state with zero
    lost/duplicated updates."""
    seed = {"ssp3": 21, "essp3": 24, "vap": 22, "cvap": 23,
            "elastic": 25}[polname]
    n_clocks = 30
    wal_dir = str(tmp_path / "wal")
    rt, stats, plan, _ = chaos_run(seed, pol, n_clocks, n_events=3,
                                   wal_dir=wal_dir)
    _assert_chaos_outcome(rt, stats, plan, seed, n_clocks)
    assert_wal_recovery(rt, seed, n_clocks, wal_dir)


def test_a_failed_port_chaos_test_ships_its_post_mortem(tmp_path,
                                                        monkeypatch):
    """``conftest.py``'s hook writes the trace and metrics of
    ``chaos.LAST_RT`` to ``test-artifacts/<test>/`` when a chaos test
    fails.  The port's ``chaos_run`` registers its runtime there, so a red
    run of this file ships its own post-mortem: here the hook is driven as
    pytest drives it, for a failed report, after the membership smoke's
    ssp3 run."""
    import json
    from types import SimpleNamespace

    import conftest

    rt, stats, plan, _ = chaos_run(21, policies.ssp(3), 30, n_events=3)
    assert chaos.LAST_RT is rt and rt.trace_on
    monkeypatch.setattr(conftest, "ARTIFACTS", str(tmp_path))
    rep = SimpleNamespace(when="call", failed=True, sections=[])
    item = SimpleNamespace(keywords={"chaos": True},
                           nodeid="tests/test_torch_chaos.py::t[ssp3-tcp]")
    gen = conftest.pytest_runtest_makereport(item, None)
    next(gen)
    with pytest.raises(StopIteration):
        gen.send(SimpleNamespace(get_result=lambda: rep))
    out = tmp_path / "t_ssp3-tcp_"
    assert not (out / "artifact-error.txt").exists()
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["membership"]["n_ops"] == len(plan.events)
    assert json.loads((out / "trace.json").read_text())
    assert rep.sections and "chaos artifacts" in rep.sections[0][0]


def test_wal_off_cross_epoch_duplicate_dropped(monkeypatch):
    """A transport-level duplicate of an update frame landing after a
    membership epoch began is dropped on a WAL-off run (the drop filter
    arms at the first EpochBeginMsg): zero recorded violations, an exact
    per-process counter audit, a bitwise final state, and the drop
    counted by the shards' UidDedup."""
    from repro_torch.runtime.messages import UpdateMsg

    injected = {"n": 0}
    lock = threading.Lock()
    orig = PSRuntime._send_many

    def dup_send_many(self, chan, msgs):
        orig(self, chan, msgs)
        with lock:
            if injected["n"]:
                return
            pick = next((m for m in msgs if isinstance(m, UpdateMsg)
                         and m.epoch >= 1), None)
            if pick is None:
                return
            injected["n"] = 1
            dup = UpdateMsg(pick.uid, pick.worker, pick.process, pick.ts,
                            pick.key, pick.rows.copy(), pick.delta.copy(),
                            pick.epoch)
        orig(self, chan, [dup])

    monkeypatch.setattr(PSRuntime, "_send_many", dup_send_many)
    seed = 27
    n_clocks = 30
    rt, stats, plan, _ = chaos_run(seed, policies.ssp(3), n_clocks,
                                   n_events=3)     # wal_dir=None: wal-off
    assert injected["n"] == 1, "no post-epoch update frame was ever sent"
    _assert_chaos_outcome(rt, stats, plan, seed, n_clocks)
    assert sum(s._dedup.n_dropped for s in rt.shards) == 1


@pytest.mark.slow
@pytest.mark.parametrize("polname,pol", _POLICIES, ids=_IDS)
@pytest.mark.parametrize("seed", [31, 32])
def test_runtime_membership_chaos_full(polname, pol, seed):
    """The full matrix: 200 free clocks, 5 seeded membership faults
    (including kill+rejoin slot re-activations), bounds asserted across
    every migration window."""
    n_clocks = 200
    rt, stats, plan, _ = chaos_run(seed, pol, n_clocks, n_events=5)
    _assert_chaos_outcome(rt, stats, plan, seed, n_clocks)
    if pol.clock_bounded:
        # asynchrony actually happened: the checks were not vacuous
        assert stats.max_observed_staleness > 0


@pytest.mark.slow
def test_runtime_membership_chaos_multiprocess():
    """Forked OS clients (shm rings) under membership faults: the epoch
    barrier crosses the real wire."""
    seed = 41
    n_clocks = 40
    rt, stats, plan, _ = chaos_run(seed, policies.ssp(3), n_clocks,
                                   transport="shm", n_events=3,
                                   timeout=150.0)
    assert stats.violations == [], stats.violations[:5]
    assert [r for _, r in plan.results] == ["ok"] * len(plan.events)
    for k, ref in expected_final(seed, 4, n_clocks).items():
        np.testing.assert_array_equal(rt.master_value(k).reshape(ref.shape),
                                      ref)


@pytest.mark.slow
@pytest.mark.parametrize("transport", ["shm", "tcp"])
@pytest.mark.parametrize("polname,pol", _POLICIES, ids=_IDS)
def test_runtime_membership_chaos_wal_wire_full(polname, pol, transport,
                                                tmp_path):
    """Durability matrix over the real wires × every policy with
    kill+rejoin faults: the per-shard WAL, written by the parent-side
    shard threads while forked clients drive load over the wire,
    reconstructs the exact final state with zero lost or duplicated
    updates."""
    seed = {"ssp3": 91, "essp3": 94, "vap": 92, "cvap": 93,
            "elastic": 95}[polname]
    n_clocks = 40
    wal_dir = str(tmp_path / "wal")
    rt, stats, plan, _ = chaos_run(seed, pol, n_clocks, transport=transport,
                                   n_events=3, wal_dir=wal_dir,
                                   timeout=150.0)
    assert stats.violations == [], stats.violations[:5]
    assert [r for _, r in plan.results] == ["ok"] * len(plan.events)
    assert_counters(rt)
    assert_wal_recovery(rt, seed, n_clocks, wal_dir)


# ---------------------------------------------------------------------------
# autoscaler leg: the control loop IS the membership churn driver
# ---------------------------------------------------------------------------


def _assert_autoscale_outcome(rt, stats, seed, n_clocks, fn):
    assert stats.violations == [], stats.violations[:5]
    assert_counters(rt)
    if rt.policy.clock_bounded:
        assert stats.max_observed_staleness <= rt.policy.staleness
    for k, ref in expected_final(seed, 4, n_clocks, fn=fn).items():
        np.testing.assert_array_equal(
            rt.master_value(k).reshape(ref.shape), ref,
            err_msg=f"autoscale chaos seed={seed} master[{k}]")
    # the churn was real: at least one membership op actually landed
    summary = rt.autoscaler.summary()
    assert summary.get("add_shard", 0) + summary.get("remove_shard", 0) >= 1, (
        summary, rt.autoscaler.actions)


@pytest.mark.parametrize("polname,pol", _POLICIES, ids=_IDS)
def test_runtime_autoscaler_chaos_smoke(polname, pol):
    """Zipf-skewed bursty load concentrates rows on one slot; the
    autoscaler splits/drains shards live while the bounds and the
    zero-lost/duplicated counter audit keep holding."""
    seed = {"ssp3": 71, "essp3": 75, "vap": 72, "cvap": 73,
            "elastic": 76}[polname]
    n_clocks = 80
    fn = zipf_fn(seed)
    rt, stats, plan, _ = chaos_run(seed, pol, n_clocks, autoscale=True,
                                   fn=fn)
    assert plan is None                       # the autoscaler drives churn
    _assert_autoscale_outcome(rt, stats, seed, n_clocks, fn)


@pytest.mark.serving
def test_serving_autoscaler_chaos_smoke():
    """Autoscaler + gateway: replica scaling and fresh-read shedding under
    SLO'd reads — every served stamp within its request, shed reads
    counted and tolerated, the bounds and the audit holding through the
    churn."""
    seed = 74
    n_clocks = 80
    fn = zipf_fn(seed)
    rt, stats, plan, reader = chaos_run(seed, policies.ssp(3), n_clocks,
                                        autoscale=True, serving=True, fn=fn)
    _assert_autoscale_outcome(rt, stats, seed, n_clocks, fn)
    assert reader.bad == [], reader.bad[:5]
    assert reader.errors == [], reader.errors[:3]
    assert reader.n_reads > 0


@pytest.mark.slow
@pytest.mark.parametrize("transport", ["shm", "tcp"])
@pytest.mark.parametrize("polname,pol", _POLICIES, ids=_IDS)
def test_runtime_autoscaler_chaos_wire_full(polname, pol, transport):
    """Forked OS clients on real wires with the autoscaler churning
    membership: the epoch barrier, the piggybacked metrics loads and the
    audit all cross the wire."""
    seed = {"ssp3": 81, "essp3": 84, "vap": 82, "cvap": 83,
            "elastic": 85}[polname]
    n_clocks = 40
    fn = zipf_fn(seed)
    rt, stats, plan, _ = chaos_run(seed, pol, n_clocks, transport=transport,
                                   autoscale=True, fn=fn, timeout=150.0)
    _assert_autoscale_outcome(rt, stats, seed, n_clocks, fn)


# ---------------------------------------------------------------------------
# serving leg: SLO stamps + wedged replicas through membership chaos
# ---------------------------------------------------------------------------


@pytest.mark.serving
def test_serving_chaos_smoke():
    seed = 51
    n_clocks = 40
    rt, stats, plan, reader = chaos_run(seed, policies.ssp(3), n_clocks,
                                        n_events=2, serving=True)
    assert stats.violations == [], stats.violations[:5]
    assert reader.bad == [], reader.bad[:5]
    assert reader.errors == [], reader.errors[:3]
    assert reader.n_reads > 0
    assert reader.replica_errors == []
    assert len(reader.final_replicas) == 2
    for vals in reader.final_replicas:
        for k, ref in expected_final(seed, 4, n_clocks).items():
            np.testing.assert_array_equal(vals[k].reshape(ref.shape), ref)


@pytest.mark.slow
@pytest.mark.serving
def test_serving_chaos_with_wedged_replicas_full():
    """Membership faults + a seeded replica wedger: stale replicas drop out
    of the rotation by their vector clock (stamps stay honest), and every
    recovered replica converges to the master exactly via the in-stream
    drop-and-resync re-bootstrap."""
    seed = 61
    n_clocks = 150
    rt, stats, plan, reader = chaos_run(seed, policies.ssp(3), n_clocks,
                                        n_events=4, serving=True, wedge=True,
                                        serving_transport="shm",
                                        timeout=150.0)
    assert stats.violations == [], stats.violations[:5]
    assert reader.bad == [], reader.bad[:5]
    assert reader.errors == [], reader.errors[:3]
    assert reader.n_reads > 0
    assert reader.replica_errors == []
    assert reader.final_replicas, "every replica ended stale or poisoned"
    for vals in reader.final_replicas:
        for k, ref in expected_final(seed, 4, n_clocks).items():
            np.testing.assert_array_equal(vals[k].reshape(ref.shape), ref)
