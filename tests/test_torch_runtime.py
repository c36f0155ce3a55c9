"""The port's simulator and runtime against the JAX package's simulator.

Deterministic schedules (integer deltas that depend only on (worker,
clock)) make the update set interleaving-independent, so the port's
quiesced runtime — master shard tables and every process cache — must equal
the reference simulator's final views bitwise for every policy; the port's
simulator must equal the reference simulator in views and in every RunStats
counter.  The runtime runs here with ``device="cpu"``, i.e. through the
kernels' plain versions; the ``cuda``-marked cases run the same checks with
the master blocks on the card, every apply through the ``ps_apply`` kernel
and every send order through ``topk_mag``, and skip on a host without a
CUDA device.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro.core import AsyncPS as RefAsyncPS
from repro.core import NetworkModel as RefNetworkModel
from repro.core import policies as ref_policies
from repro.configs.base import ConsistencySpec as RefSpec
from repro.runtime import PSRuntime as RefPSRuntime
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro_torch.convert import state_from_reference, state_to_numpy
from repro_torch.core import AsyncPS, ConsistencySpec, NetworkModel
from repro_torch.core import policies
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.kernels.topk_mag import ops as topk_ops
from repro_torch.runtime import PSRuntime, RuntimeConfig, UidDedup
from repro_torch.runtime.messages import UpdateMsg
from repro_torch.runtime.metrics import (LOAD_BLOCK_CLOCK, LOAD_LEN,
                                         LOAD_UPDATES)


def _x0():
    return {"a": np.arange(32, dtype=float).reshape(8, 4) / 2.0,
            "b": np.ones(5)}


def _sched_fn(seed):
    """Integer deltas, a pure function of (worker, clock)."""
    def fn(w, clock, view, rng):
        r = np.random.default_rng((seed, w, clock))
        return {"a": r.integers(-3, 4, size=(8, 4)).astype(float),
                "b": r.integers(-3, 4, size=5).astype(float)}
    return fn


# (name, port policy, reference policy): the 7 kinds of the reference's
# conformance suite
_POLICIES = [
    ("bsp", policies.bsp(), ref_policies.bsp()),
    ("ssp2", policies.ssp(2), ref_policies.ssp(2)),
    ("cap1", policies.cap(1), ref_policies.cap(1)),
    ("essp2", policies.essp(2), ref_policies.essp(2)),
    ("vap", policies.vap(4.5), ref_policies.vap(4.5)),
    ("cvap_strong", policies.cvap(2, 4.5, strong=True),
     ref_policies.cvap(2, 4.5, strong=True)),
    ("elastic", policies.elastic(12.0), ref_policies.elastic(12.0)),
]
_IDS = [p[0] for p in _POLICIES]


def _ref_sim(pol, seed, n_clocks=12):
    sim = RefAsyncPS(4, pol, _x0(), threads_per_process=2, seed=seed,
                     network=RefNetworkModel(seed=seed))
    st = sim.run(_sched_fn(seed), n_clocks)
    assert st.violations == [], st.violations
    return sim, st


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


def _launched_on_card(rt, run):
    """Run ``run()`` with both kernels' launch counters at 0; check the
    master blocks sit on the card and both kernels were launched."""
    apply_ops.launches = topk_ops.launches = 0
    out = run()
    assert all(t.is_cuda and t.dtype == torch.float64
               for s in rt.shards for t in s.dense.values())
    assert apply_ops.launches > 0 and topk_ops.launches > 0
    return out


def _runtime_equals_reference_simulator(name, pol, ref_pol, seed, device):
    sim, st_sim = _ref_sim(ref_pol, seed)
    rt = PSRuntime(RuntimeConfig(4, pol, _x0(), n_shards=2,
                                 threads_per_process=2, seed=seed,
                                 device=device))
    if device == "cpu":
        st = rt.run(_sched_fn(seed), 12, timeout=90)
    else:
        st = _launched_on_card(
            rt, lambda: rt.run(_sched_fn(seed), 12, timeout=90))
    assert st.violations == [], st.violations
    assert st.n_updates == st_sim.n_updates
    for k, ref in sim.views[0].items():
        np.testing.assert_array_equal(rt.master_value(k), ref,
                                      err_msg=f"{name} seed={seed} master[{k}]")
        np.testing.assert_array_equal(rt.expected_value(k), ref)
        for p in range(rt.n_proc):
            np.testing.assert_array_equal(
                rt.view(p)[k], ref, err_msg=f"{name} seed={seed} proc{p}[{k}]")


@pytest.mark.parametrize("name,pol,ref_pol", _POLICIES, ids=_IDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_runtime_final_state_equals_reference_simulator(name, pol, ref_pol,
                                                        seed):
    _runtime_equals_reference_simulator(name, pol, ref_pol, seed, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name,pol,ref_pol", _POLICIES, ids=_IDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_runtime_on_the_card_equals_reference_simulator(name, pol, ref_pol,
                                                        seed, cuda):
    _runtime_equals_reference_simulator(name, pol, ref_pol, seed, cuda)


@pytest.mark.parametrize("name,pol,ref_pol", _POLICIES, ids=_IDS)
def test_simulator_equals_reference_simulator(name, pol, ref_pol):
    """Same events, same arithmetic: views and every RunStats field."""
    seed = 1
    ref = RefAsyncPS(4, ref_pol, _x0(), threads_per_process=2, seed=seed,
                     network=RefNetworkModel(seed=seed))
    st_ref = ref.run(_sched_fn(seed), 12, divergence_every=0.5)
    sim = AsyncPS(4, pol, _x0(), threads_per_process=2, seed=seed,
                  network=NetworkModel(seed=seed))
    st = sim.run(_sched_fn(seed), 12, divergence_every=0.5)
    assert st.violations == []
    assert dataclasses.asdict(st) == dataclasses.asdict(st_ref)
    for p in range(sim.n_proc):
        for k in sim.x0:
            np.testing.assert_array_equal(sim.views[p][k], ref.views[p][k])
    for k in sim.x0:
        np.testing.assert_array_equal(sim.master_value(k),
                                      ref.master_value(k))


@pytest.mark.parametrize("spec", [
    RefSpec("bsp"), RefSpec("ssp", staleness=3), RefSpec("cap", staleness=1),
    RefSpec("essp", staleness=2), RefSpec("vap", value_bound=0.5),
    RefSpec("cvap", staleness=2, value_bound=0.5, strong=True),
    RefSpec("elastic", value_bound=3.0)], ids=lambda s: s.model)
def test_policy_from_spec_matches_reference(spec):
    mine = policies.from_spec(ConsistencySpec(**dataclasses.asdict(spec)))
    ref = ref_policies.from_spec(spec)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for prop in ("clock_bounded", "value_bounded", "norm_bounded",
                 "tracks_sync", "server_push_on_boundary"):
        assert getattr(mine, prop) == getattr(ref, prop)


@pytest.mark.parametrize("kw", [
    dict(kind="vap", staleness=3), dict(kind="ssp", value_bound=0.5),
    dict(kind="bsp", strong=True), dict(kind="essp", push_at_clock_only=True),
    dict(kind="nope")], ids=lambda kw: kw["kind"])
def test_policy_rejects_what_reference_rejects(kw):
    with pytest.raises(ValueError):
        ref_policies.Policy(**kw)
    with pytest.raises(ValueError):
        policies.Policy(**kw)


# ---------------------------------------------------------------------------
# carrying state across the two packages
# ---------------------------------------------------------------------------


def test_convert_round_trip_copies():
    p = {"w": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
         "v": np.arange(5.0)}
    state = state_from_reference(p, "cpu")
    assert state["w"].shape == (2, 12) and state["v"].shape == (5, 1)
    assert all(t.dtype == torch.float64 for t in state.values())
    back = state_to_numpy(state, {k: v.shape for k, v in p.items()})
    for k in p:
        np.testing.assert_array_equal(back[k], p[k])
        assert back[k].dtype == np.float64
    state["v"][0, 0] = 99.0                 # no memory shared either way
    back["v"][1] = -1.0
    assert p["v"][0] == 0.0 and p["v"][1] == 1.0
    assert state_to_numpy(state)["v"].shape == (5, 1)


def _state_carries_across(device):
    pol, ref_pol = policies.ssp(1), ref_policies.ssp(1)
    first = RefPSRuntime(RefRuntimeConfig(4, ref_pol, _x0(), n_shards=2,
                                          threads_per_process=2, seed=0))
    first.run(_sched_fn(0), 6, timeout=90)
    carried = {k: first.master_value(k) for k in _x0()}

    ref = RefPSRuntime(RefRuntimeConfig(4, ref_pol, carried, n_shards=2,
                                        threads_per_process=2, seed=5))
    assert ref.run(_sched_fn(5), 6, timeout=90).violations == []
    mine = PSRuntime(RuntimeConfig(4, pol, carried, n_shards=3,
                                   threads_per_process=2, seed=5,
                                   device=device))
    if device == "cpu":
        st = mine.run(_sched_fn(5), 6, timeout=90)
    else:
        st = _launched_on_card(
            mine, lambda: mine.run(_sched_fn(5), 6, timeout=90))
    assert st.violations == []
    sim = RefAsyncPS(4, ref_pol, carried, threads_per_process=2, seed=5,
                     network=RefNetworkModel(seed=5))
    sim.run(_sched_fn(5), 6)
    final = state_to_numpy(state_from_reference(
        {k: mine.master_value(k) for k in carried}, "cpu"),
        {k: v.shape for k, v in carried.items()})
    for k in carried:
        np.testing.assert_array_equal(final[k], ref.master_value(k))
        np.testing.assert_array_equal(final[k], sim.views[0][k])


def test_state_carries_across_and_continues_bitwise():
    """A reference run's master state seeds both packages; both continue
    with the same schedule and must agree bitwise with each other and with
    the reference simulator continued from the same state."""
    _state_carries_across("cpu")


@pytest.mark.cuda
def test_state_carries_across_onto_the_card(cuda):
    """The same carry-across, the port's master blocks on the card."""
    _state_carries_across(cuda)


# ---------------------------------------------------------------------------
# the runtime's own checks under free interleaving
# ---------------------------------------------------------------------------


_STRESS = [("ssp3", policies.ssp(3)), ("essp3", policies.essp(3)),
           ("vap", policies.vap(1.5)), ("cvap", policies.cvap(3, 1.5)),
           ("elastic", policies.elastic(5.0))]


@pytest.mark.parametrize("name,pol", _STRESS, ids=[p[0] for p in _STRESS])
def test_stress_invariants_hold_mid_run(name, pol):
    """4 threads, free interleaving: the runtime checks the clock bound at
    every period start and the value/norm bound after every Inc."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        def fn(w, clock, view, rng):
            return {"a": rng.normal(0.0, 0.6, size=(8, 4)),
                    "b": rng.normal(0.0, 0.6, size=5)}

        x0 = {"a": np.zeros((8, 4)), "b": np.zeros(5)}
        rt = PSRuntime(RuntimeConfig(4, pol, x0, n_shards=2,
                                     threads_per_process=2, seed=11,
                                     device="cpu"))
        st = rt.run(fn, 80, timeout=110)
    finally:
        sys.setswitchinterval(old)
    assert st.violations == [], st.violations[:5]
    assert st.n_updates == 4 * 80 * 2
    if pol.clock_bounded:
        assert st.max_observed_staleness <= pol.staleness
    if pol.value_bounded:
        assert 0.0 < st.max_unsynced_mag <= max(st.max_update_mag,
                                                pol.value_bound) + 1e-9
    if pol.norm_bounded:
        assert 0.0 < st.max_unsynced_norm <= max(st.max_update_norm,
                                                 pol.value_bound) + 1e-9


def test_vap_sub_epsilon_deltas_drain_exactly():
    """Every delta a multiple of 2^-44: the quiesced state equals the
    reference simulator bitwise and every accumulator drains to 0.0."""
    tiny = 2.0 ** -44
    seed = 3

    def fn(w, clock, view, rng):
        r = np.random.default_rng((seed, w, clock))
        return {"a": r.integers(-3, 4, size=(8, 4)) * tiny,
                "b": r.integers(-3, 4, size=5) * tiny}

    x0 = {"a": np.zeros((8, 4)), "b": np.zeros(5)}
    sim = RefAsyncPS(4, ref_policies.vap(4.5 * tiny), x0,
                     threads_per_process=2, seed=seed,
                     network=RefNetworkModel(seed=seed))
    sim.run(fn, 10)
    rt = PSRuntime(RuntimeConfig(4, policies.vap(4.5 * tiny), x0, n_shards=2,
                                 threads_per_process=2, seed=seed,
                                 device="cpu"))
    assert rt.run(fn, 10, timeout=90).violations == []
    for k, ref in sim.views[0].items():
        np.testing.assert_array_equal(rt.master_value(k), ref)
    for p in rt.procs:
        for acc in p.unsynced.values():
            assert not any(a.any() for a in acc.values())


def test_live_reads_under_concurrent_updates():
    def fn(w, clock, view, rng):
        return {"a": np.ones((8, 4))}

    rt = PSRuntime(RuntimeConfig(2, policies.ssp(3), {"a": np.zeros((8, 4))},
                                 n_shards=2, seed=0, device="cpu"))
    rt.start(fn, 50, timeout=60)
    seen = []
    while rt.running and len(seen) < 1000:
        seen.append(float(rt.read("a").sum()))   # a Get() on a live cache
    assert rt.wait().violations == []
    assert seen == sorted(seen)                  # monotone progress
    assert float(rt.master_value("a").sum()) == 2 * 50 * 32


def test_shard_state_round_trip():
    """state() copies the device block to the host; load_state() copies a
    payload back, and rejects one cut for another partition."""
    x0 = _x0()
    rt = PSRuntime(RuntimeConfig(2, policies.bsp(), x0, n_shards=2,
                                 device="cpu"))
    rt.run(_sched_fn(4), 3, timeout=60)
    states = [s.state() for s in rt.shards]
    fresh = PSRuntime(RuntimeConfig(2, policies.bsp(), x0, n_shards=2,
                                    device="cpu"))
    for s, st in zip(fresh.shards, states):
        s.load_state(st)
    for k in x0:
        np.testing.assert_array_equal(fresh.master_value(k),
                                      rt.master_value(k))
    states[0]["a"]["values"][:] = -1.0          # host copies, not views
    assert (rt.master_value("a") != -1.0).all()
    with pytest.raises(ValueError):
        fresh.shards[0].load_state(states[1])


@pytest.mark.parametrize("metrics", [True, False])
def test_clock_msgs_carry_load_counters(metrics):
    """Each shard keeps every process's newest boundary snapshot, taken from
    the ClockMsg piggyback; with metrics off nothing rides along."""
    rt = PSRuntime(RuntimeConfig(4, policies.ssp(1), _x0(), n_shards=2,
                                 threads_per_process=2, device="cpu",
                                 metrics=metrics))
    rt.run(_sched_fn(3), 5, timeout=60)
    for s in rt.shards:
        if not metrics:
            assert s.proc_load == {}
            continue
        assert sorted(s.proc_load) == list(range(rt.n_proc))
        for p, (clock, load) in s.proc_load.items():
            assert clock == 4                   # the last boundary
            assert load.shape == (LOAD_LEN,)
            assert load[LOAD_UPDATES] == 2 * 5 * 2   # threads x clocks x keys
            assert load[LOAD_BLOCK_CLOCK] >= 0.0


def test_shard_refuses_rows_outside_its_block():
    """The shard checks an apply's local rows on the host, before any copy
    to the device, and refuses a row its block does not hold."""
    rt = PSRuntime(RuntimeConfig(2, policies.bsp(), _x0(), n_shards=2,
                                 device="cpu"))
    shard = rt.shards[0]
    before = shard.dense["a"].clone()
    assert before.shape == (4, 4)           # rows 0, 2, 4, 6 of "a"
    bad = UpdateMsg(uid=0, worker=0, process=0, ts=0, key="a",
                    rows=np.array([0, 8]), delta=np.ones((2, 4)))
    with pytest.raises(IndexError, match="outside"):
        shard._flush_updates([bad])
    assert torch.equal(shard.dense["a"], before)


def test_uid_dedup_records_and_prunes():
    d = UidDedup(2)
    assert d.fresh(7, 0, 0) and not d.fresh(7, 0, 0)
    assert d.fresh(7, 1, 0)                 # uids are per process
    d.advance(0, 0)
    assert not d.fresh(8, 0, 0)             # at or below the frontier
    assert d.fresh(8, 0, 1) and d.n_dropped == 2


@pytest.mark.parametrize("kw", [
    dict(transport="shm"), dict(snapshot_every=2, snapshot_dir="x"),
    dict(max_shards=4), dict(wal_dir="w"), dict(trace=True),
    dict(zero_copy=True)], ids=lambda kw: next(iter(kw)))
def test_config_tiers_not_ported_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RuntimeConfig(2, policies.bsp(), _x0(), device="cpu", **kw)


def test_config_validates_like_reference():
    with pytest.raises(ValueError):
        RuntimeConfig(3, policies.bsp(), _x0(), threads_per_process=2)
    with pytest.raises(ValueError):
        RuntimeConfig(2, policies.bsp(), _x0(), transport="carrier-pigeon")
    with pytest.raises(ValueError):
        RuntimeConfig(4, policies.bsp(), _x0(), threads_per_process=2,
                      barrier_reads=True)
