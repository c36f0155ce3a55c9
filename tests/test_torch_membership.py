"""The port's elastic shard membership against the JAX package's, on the CPU.

Every test of ``tests/test_membership.py`` is mirrored on the port
(``device="cpu"``: the handoff, the reassembly and the install run the
same code as on the card, on host tensors, and every apply, held-epoch
replay and replica ingest goes through ``ps_apply``'s wrapper into its
plain version): shards added and removed mid-run for SSP, VAP and strong
CVAP with the final state bitwise the JAX package's ``AsyncPS``; a plan of
ops on the queue, shm and tcp transports; a shrink to one shard and a
retired slot re-activated; op and ``max_shards`` validation; gateway reads
under SLOs through an add and a remove; a snapshot taken mid-run after an
op.  Then the cross-package tests:

  * the device-side reassembly (:func:`assemble_on_device` plus
    ``index_select``) bitwise the JAX package's ``assemble_master`` plus
    ``rows_of``, for random partitions of 1-4 active slots;
  * a port ``Partition`` equal to the reference's row for row;
  * a forked client that touches CUDA fails the run (shm and tcp);
  * the held-replay path, driven message by message through a port shard
    and a reference shard: every next-epoch part held, replayed once with
    the new ``A``, its duplicate dropped by ``UidDedup``, the blocks
    bitwise the reference's.

No assertion depends on scheduling: where the reference asserts that a
scripted op fired before the run ended, the workers wait at their last
clock for the membership log (``test_torch_chaos._OpGate``), and every
wait has a deadline.
"""
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from chaos import assert_counters, det_fn, expected_final, x0
from repro.core import AsyncPS as RefAsyncPS
from repro.core import NetworkModel as RefNetworkModel
from repro.core import policies as ref_policies
from repro.runtime import PSRuntime as RefPSRuntime
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import messages as RM
from repro.runtime import snapshot as ref_snapshot
from repro.runtime.membership import Partition as RefPartition
from repro_torch.core import policies
from repro_torch.runtime import (MembershipPlan, PSRuntime, ReadGateway,
                                 RuntimeConfig, snapshot_params,
                                 validate_vcs)
from repro_torch.runtime import messages as M
from repro_torch.runtime.membership import Partition, assemble_on_device
from test_torch_chaos import _OpGate

pytestmark = [pytest.mark.membership,
              pytest.mark.filterwarnings("ignore:os.fork:RuntimeWarning")]

_POLICIES = [
    ("ssp2", policies.ssp(2), ref_policies.ssp(2)),
    ("vap", policies.vap(4.5), ref_policies.vap(4.5)),
    ("cvap_strong", policies.cvap(2, 4.5, strong=True),
     ref_policies.cvap(2, 4.5, strong=True)),
]


def _rt(n_workers, pol, x=None, **kw):
    return PSRuntime(RuntimeConfig(n_workers, pol, x0() if x is None else x,
                                   device="cpu", **kw))


def _wait_clock(rt, clock, budget=30.0):
    deadline = time.monotonic() + budget
    while rt.completed_clock() < clock:
        assert time.monotonic() < deadline, "runtime stalled before trigger"
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# the core contract: add + remove mid-run == the reference simulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("polname,pol,ref_pol", _POLICIES,
                         ids=[p[0] for p in _POLICIES])
def test_add_and_remove_mid_run_equals_simulator(polname, pol, ref_pol):
    """Free 4-worker interleaving; a shard joins at clock >= 5 and the
    original shard 0 retires at clock >= 12.  Final master and every
    process cache equal the JAX package's (membership-free) simulator
    bitwise; mid-run clock/value bound checks and the update-counter audit
    record zero violations across the migration windows."""
    seed = 3
    fn = det_fn(seed)
    sim = RefAsyncPS(4, ref_pol, x0(), threads_per_process=2, seed=seed,
                     network=RefNetworkModel(seed=seed))
    st_sim = sim.run(fn, 24)

    rt = _rt(4, pol, n_shards=2, threads_per_process=2, seed=seed,
             max_shards=4)
    rt.start(fn, 24, timeout=90)
    _wait_clock(rt, 5)
    sid = rt.add_shard()
    assert sid == 2 and rt.partition.active == (0, 1, 2)
    _wait_clock(rt, 12)
    rt.remove_shard(0)
    assert rt.partition.active == (1, 2)
    st_rt = rt.wait()

    assert st_sim.violations == [], st_sim.violations
    assert st_rt.violations == [], st_rt.violations[:5]
    assert st_sim.n_updates == st_rt.n_updates
    assert_counters(rt)
    if pol.clock_bounded:
        assert st_rt.max_observed_staleness <= pol.staleness
    for k, ref in sim.views[0].items():
        np.testing.assert_array_equal(
            rt.master_value(k).reshape(ref.shape), ref,
            err_msg=f"{polname} master[{k}]")
        for p in range(rt.n_proc):
            np.testing.assert_array_equal(
                rt.view(p)[k].reshape(ref.shape), ref,
                err_msg=f"{polname} proc{p}[{k}]")
    # the slots' blocks follow the final partition: slot 0 holds none
    for s in rt.shards:
        for key, block in s.dense.items():
            assert tuple(block.shape) == (
                rt.partition.rows_of(key, s.sid).size, x0()[key].reshape(
                    x0()[key].shape[0], -1).shape[1])


# ---------------------------------------------------------------------------
# all transports: the epoch barrier works over real wires
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["queue", "shm", "tcp"])
def test_membership_all_transports(transport):
    """Scripted add + remove mid-run under every transport (forked OS
    clients for shm/tcp): the epoch announce/ack barrier rides the same
    FIFO channels as updates, rows migrate on the device in the parent,
    and the quiesced state is bitwise x0 + sum(updates) with a clean
    counter audit."""
    seed = 0
    n_clocks = 22
    plan = MembershipPlan.parse([(4, "add", 2), (10, "remove", 0)])
    rt = _rt(4, policies.ssp(2), n_shards=2, threads_per_process=2,
             seed=seed, max_shards=3, transport=transport,
             membership_plan=plan)
    gate = _OpGate(rt, len(plan.events), n_clocks)
    st = rt.run(gate.wrap(det_fn(seed)), n_clocks, timeout=110)
    assert st.violations == [], st.violations[:5]
    assert [r for _, r in plan.results] == ["ok", "ok"], plan.results
    assert rt.partition.active == (1, 2)
    assert rt.membership.log == [(1, (0, 1, 2)), (2, (1, 2))]
    assert st.n_updates == 4 * n_clocks * 2
    exp = expected_final(seed, 4, n_clocks)
    for k, ref in exp.items():
        np.testing.assert_array_equal(
            rt.master_value(k).reshape(ref.shape), ref,
            err_msg=f"{transport} master[{k}]")
    if transport == "queue":
        assert_counters(rt)
    else:
        # proc mode: the per-client sent counters were shipped back over
        # the pipes and checked in _final_checks (violations above); the
        # parent-side applied counters must cover every update part
        applied = int(sum(s.applied_parts.sum() for s in rt.shards))
        assert applied == int(rt._parts_sent.sum()) > 0


# ---------------------------------------------------------------------------
# shrink to one, grow back, re-activate a retired slot
# ---------------------------------------------------------------------------


def test_shrink_to_one_shard_and_reactivate():
    """Remove down to a single shard (everything migrates onto it), then
    re-activate a previously retired slot — the stale-marker epoch filter
    and the seeded frontier markers must keep the clock bound live across
    the re-activation."""
    seed = 5
    rt = _rt(2, policies.ssp(1), n_shards=3, threads_per_process=1,
             seed=seed, max_shards=3)
    rt.start(det_fn(seed), 30, timeout=90)
    _wait_clock(rt, 4)
    rt.remove_shard(0)
    rt.remove_shard(2)
    assert rt.partition.active == (1,)
    _wait_clock(rt, 12)
    rt.add_shard(0)                       # re-activate the retired slot 0
    assert rt.partition.active == (0, 1)
    st = rt.wait()
    assert st.violations == [], st.violations[:5]
    assert_counters(rt)
    exp = expected_final(seed, 2, 30)
    for k, ref in exp.items():
        np.testing.assert_array_equal(rt.master_value(k).reshape(ref.shape),
                                      ref)
    assert rt.membership.log == [(1, (1, 2)), (2, (1,)), (3, (0, 1))]
    m = rt.metrics()
    assert (m.membership.epoch, m.membership.n_ops) == (3, 3)
    assert [s.epoch for s in m.shards] == [3, 3, 2]


def test_membership_op_validation():
    rt = _rt(2, policies.ssp(1), n_shards=2, seed=0, max_shards=3)
    with pytest.raises(RuntimeError, match="running"):
        rt.add_shard()                    # not started yet
    rt.start(det_fn(0), 12, timeout=60)
    try:
        _wait_clock(rt, 2)
        with pytest.raises(ValueError, match="already active"):
            rt.add_shard(0)
        with pytest.raises(ValueError, match="not active"):
            rt.remove_shard(2)
        rt.add_shard()                    # 3 active: slots exhausted
        with pytest.raises(ValueError, match="max_shards"):
            rt.add_shard()
        rt.remove_shard(1)
        rt.remove_shard(2)
        with pytest.raises(ValueError, match="last active"):
            rt.remove_shard(0)
    finally:
        st = rt.wait()
    assert st.violations == [], st.violations[:5]


def test_max_shards_validation():
    with pytest.raises(ValueError, match="max_shards"):
        RuntimeConfig(2, policies.bsp(), x0(), n_shards=3, max_shards=2,
                      device="cpu")
    with pytest.raises(ValueError, match="max_shards"):
        RefRuntimeConfig(2, ref_policies.bsp(), x0(), n_shards=3,
                         max_shards=2)


# ---------------------------------------------------------------------------
# serving tier across membership: SLO stamps honored, re-bootstrap exact
# ---------------------------------------------------------------------------


def _caught_up(rset, budget=30.0):
    deadline = time.monotonic() + budget
    while any(rset.staleness(r.vc, rset.master_vc()) for r in rset.replicas):
        assert time.monotonic() < deadline, "replicas did not catch up"
        time.sleep(0.01)


@pytest.mark.serving
def test_serving_slo_honored_across_membership_change():
    """Gateway reads under SLOs run *through* an add and a remove: every
    response's measured staleness obeys the request (the master frontier
    includes the new owner from install, so mid-migration reads park or
    escalate rather than stamp optimistically), and once the replicas
    caught up with the quiesced master every replica equals it bitwise —
    the in-stream re-bootstrap made the migrated rows exact."""
    seed = 9
    rt = _rt(4, policies.ssp(3), n_shards=2, threads_per_process=2,
             seed=seed, max_shards=3)
    rt.start(det_fn(seed), 60, timeout=110)
    gw = ReadGateway(rt, n_replicas=2, transport="queue")
    bad = []
    stop = threading.Event()

    def reader():
        slos = itertools.cycle([0, 2, 5, None])
        keys = itertools.cycle(["a", "b"])
        while not stop.is_set():
            slo = next(slos)
            res = gw.read(next(keys), slo=slo, timeout=10.0)
            if slo is not None and res.staleness > slo:
                bad.append((slo, res.staleness, res.source))

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        _wait_clock(rt, 8)
        rt.add_shard()
        _wait_clock(rt, 25)
        rt.remove_shard(1)
        st = rt.wait()
    finally:
        stop.set()
        th.join(timeout=10.0)
    assert st.violations == [], st.violations[:5]
    assert bad == [], bad[:5]
    assert gw.stats.n_reads > 0
    assert gw.replicas.errors == []
    _caught_up(gw.replicas)
    for rep in gw.replicas.replicas:
        assert not rep.poisoned
        for k, ref in expected_final(seed, 4, 60).items():
            v, _ = rep.serve(k)
            np.testing.assert_array_equal(v.reshape(ref.shape), ref,
                                          err_msg=f"replica{rep.rid}[{k}]")
    gw.close()


# ---------------------------------------------------------------------------
# snapshots interleaved with membership
# ---------------------------------------------------------------------------


def test_snapshot_during_membership_reflects_current_partition():
    """A snapshot taken after a membership change captures the *active*
    shards of the new epoch, restores into any shard count, and its vc
    stamps stay internally consistent (validate_vcs passes on load)."""
    seed = 11
    rt = _rt(2, policies.ssp(2), n_shards=2, threads_per_process=1,
             seed=seed, max_shards=3)
    rt.start(det_fn(seed), 20, timeout=90)
    _wait_clock(rt, 4)
    rt.add_shard()
    snap_mid = rt.snapshot()              # mid-run, 3 active shards
    validate_vcs(snap_mid)
    assert snap_mid["n_shards"] == 3 and len(snap_mid["shards"]) == 3
    st = rt.wait()
    assert st.violations == [], st.violations[:5]
    snap = rt.snapshot()
    params = snapshot_params(snap)
    for k, ref in expected_final(seed, 2, 20).items():
        np.testing.assert_array_equal(params[k].reshape(ref.shape), ref)
    # restorable into a different shard count (re-partition path), in
    # either package
    rt2 = _rt(2, policies.bsp(), n_shards=4, restore_from=snap)
    ref_rt2 = RefPSRuntime(RefRuntimeConfig(2, ref_policies.bsp(), x0(),
                                            n_shards=4, restore_from=snap))
    for k, ref in expected_final(seed, 2, 20).items():
        np.testing.assert_array_equal(rt2.master_value(k).reshape(ref.shape),
                                      ref)
        np.testing.assert_array_equal(
            ref_rt2.master_value(k).reshape(ref.shape), ref)


# ---------------------------------------------------------------------------
# cross-package: reassembly, partitions, forked clients, held replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_device_reassembly_equals_reference_assemble_master(seed):
    """Random partitions of 1-4 active slots over random keys: the
    manager's device reassembly and each new slot's ``index_select`` are
    bitwise the reference's ``assemble_master`` and ``rows_of`` rows, and
    a handoff missing a slot raises as an incomplete snapshot does."""
    rng = np.random.default_rng(seed)
    n_slots = 5
    shapes = {"a": (int(rng.integers(1, 40)), int(rng.integers(1, 6))),
              "b": (int(rng.integers(1, 40)), 1)}
    master = {k: rng.normal(size=s) for k, s in shapes.items()}
    counts = {k: s[0] for k, s in shapes.items()}
    old = tuple(sorted(rng.choice(n_slots, size=int(rng.integers(1, 5)),
                                  replace=False).tolist()))
    new = tuple(sorted(rng.choice(n_slots, size=int(rng.integers(1, 5)),
                                  replace=False).tolist()))
    old_p, ref_old = Partition(0, old, counts), RefPartition(0, old, counts)
    new_p, ref_new = Partition(1, new, counts), RefPartition(1, new, counts)
    handoffs, ref_states = [], []
    for sid in old:
        handoffs.append({k: (old_p.rows_of(k, sid).copy(), torch.tensor(
            master[k][old_p.rows_of(k, sid)])) for k in master})
        ref_states.append({k: {"rows": ref_old.rows_of(k, sid),
                               "values": master[k][ref_old.rows_of(k, sid)]}
                           for k in master})
    full = assemble_on_device(handoffs, shapes, torch.device("cpu"))
    ref_full = ref_snapshot.assemble_master(
        {"shapes": shapes, "shards": ref_states})
    for k in master:
        assert full[k].numpy().tobytes() == ref_full[k].tobytes()
        for sid in new:
            got = full[k].index_select(0, torch.from_numpy(
                new_p.rows_of(k, sid)))
            want = ref_full[k][ref_new.rows_of(k, sid)]
            assert got.numpy().tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="incomplete"):
        assemble_on_device(handoffs[1:] if len(old) > 1 else [
            {k: (v[0][:0], v[1][:0]) for k, v in handoffs[0].items()}],
            shapes, torch.device("cpu"))


@pytest.mark.parametrize("active", [(0,), (1, 3), (0, 1, 2), (4, 0, 2, 3)])
def test_partition_equals_reference_row_for_row(active):
    counts = {"a": 37, "b": 5, "c": 1}
    p, r = Partition(2, active, counts), RefPartition(2, active, counts)
    assert (p.epoch, p.active, p.A) == (r.epoch, r.active, r.A)
    for sid in range(6):
        assert p.owns(sid) == r.owns(sid)
        for k in counts:
            np.testing.assert_array_equal(p.rows_of(k, sid),
                                          r.rows_of(k, sid))


@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_forked_client_touching_cuda_fails_the_run(transport):
    """A forked client that touches CUDA fails the run with the guard's
    error (the children stay on the host; the shards and the device stay
    in the parent)."""
    def fn(w, clock, view, rng):
        if w == 1 and clock == 1:
            torch.zeros(1, device="cuda")
        return {"a": np.ones((8, 4))}

    rt = _rt(2, policies.vap(1e9), {"a": np.zeros((8, 4))}, n_shards=2,
             max_shards=3, transport=transport)
    with pytest.raises(RuntimeError, match="forked client 1 touched CUDA"):
        rt.run(fn, 4, timeout=30)


def _held_replay(pkg):
    """Drive one add (slots 0, 1 -> 0, 1, 2) message by message through a
    runtime's shards, without starting it: every shard sees its Begin,
    next-epoch updates of both processes (one of them twice), the acks of
    both processes and its install.  Returns the shards."""
    if pkg == "port":
        rt = _rt(2, policies.ssp(2), n_shards=2, max_shards=3, seed=0)
        mods, part_cls = M, Partition
    else:
        rt = RefPSRuntime(RefRuntimeConfig(2, ref_policies.ssp(2), x0(),
                                           n_shards=2, max_shards=3, seed=0))
        mods, part_cls = RM, RefPartition
    part = part_cls(1, (0, 1, 2), rt._row_counts)
    rng = np.random.default_rng(7)
    flat = {k: v.reshape(v.shape[0], -1) for k, v in x0().items()}
    ups = {sid: [] for sid in range(3)}
    uid = itertools.count(100)
    for p in range(2):
        for key, v in flat.items():
            for sid in range(3):
                rows = part.rows_of(key, sid)
                ups[sid].append(mods.UpdateMsg(
                    next(uid), p, p, 0, key, rows,
                    rng.integers(-3, 4, size=(rows.size, v.shape[1])
                                 ).astype(float), 1))
    for sid, s in enumerate(rt.shards):
        dup = ups[sid][0]
        s._handle_batch([mods.EpochBeginMsg(1, part), *ups[sid],
                         mods.UpdateMsg(dup.uid, dup.worker, dup.process,
                                        dup.ts, dup.key, dup.rows.copy(),
                                        dup.delta.copy(), 1)]
                        + [mods.EpochAckMsg(p, 1) for p in range(2)])
    assert all(len(s._held) == 2 * len(flat) + 1 for s in rt.shards)
    handoffs = {}
    while not rt.membership.inbox.empty():
        kind, sid, payload = rt.membership.inbox.get_nowait()
        assert kind == "handoff"
        handoffs[sid] = payload
    assert sorted(handoffs) == [0, 1]
    if pkg == "port":
        shapes = {k: v.shape for k, v in flat.items()}
        full = {k: v.numpy() for k, v in assemble_on_device(
            [handoffs[0][0], handoffs[1][0]], shapes,
            torch.device("cpu")).items()}
    else:
        full = ref_snapshot.assemble_master(
            {"shapes": {k: v.shape for k, v in flat.items()},
             "shards": [handoffs[0][0], handoffs[1][0]]})
    seed_vc = np.full(2, -1, dtype=np.int64)
    for sid, s in enumerate(rt.shards):
        blocks = {k: full[k][part.rows_of(k, sid)] for k in flat}
        if pkg == "port":
            blocks = {k: torch.tensor(v) for k, v in blocks.items()}
        s._handle_batch([mods.InstallMsg(1, part, blocks, seed_vc.copy())])
    return rt.shards, flat, ups


def test_held_replay_applies_every_next_epoch_part_once():
    """Next-epoch parts that reach a shard before its install are held,
    then replayed once through the apply with the new partition's ``A``;
    the duplicate among them is dropped by the armed ``UidDedup``.  The
    port's blocks are bitwise the reference's, and every slot holds
    ``x0 + Σ`` of its rows exactly."""
    shards, flat, ups = _held_replay("port")
    ref_shards, _, _ = _held_replay("ref")
    for s, r in zip(shards, ref_shards):
        assert s._held == [] and s.epoch == 1 and s.part.A == 3
        assert s.applied_parts.tolist() == r.applied_parts.tolist() \
            == [len(flat), len(flat)]
        assert s._dedup.n_dropped == r._dedup.n_dropped == 1
        for k in flat:
            assert s.dense[k].numpy().tobytes() == r.dense[k].tobytes()
            want = flat[k][s.part.rows_of(k, s.sid)].copy()
            for m in ups[s.sid]:
                if m.key == k:
                    want += m.delta
            np.testing.assert_array_equal(s.dense[k].numpy(), want)
