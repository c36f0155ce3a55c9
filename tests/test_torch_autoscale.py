"""The port's autoscaler against the JAX package's, on the CPU.

Every test of ``tests/test_autoscale.py`` is mirrored.  ``Autoscaler.
decide`` is a pure function of one ``RuntimeMetrics`` snapshot, so each
policy case (split / no split at capacity or below the minimum load /
drain the coldest / replica up / replica drain after patience / shed
hysteresis) builds the same synthetic metrics in both packages, runs both
packages' ``decide`` on them in step, and asserts the reference test's
outcome on the port's decisions and that they equal the reference's.  The
integration leg runs a live port runtime (``device="cpu"``) under
Zipf-skewed load and asserts the loop actually rebalances while the run's
exactness holds; its workers wait at their last clock until an op landed
(``test_torch_chaos._OpGate``), so the assertion does not depend on how
fast the run ends.
"""
import time

import numpy as np

import repro.runtime as R
import repro_torch.runtime as P
from chaos import expected_final, x0, zipf_fn
from repro_torch.core import policies
from test_torch_chaos import _OpGate, chaos_autoscale_policy

# ---------------------------------------------------------------------------
# synthetic metrics builders, for either package
# ---------------------------------------------------------------------------


def _shard(pkg, sid, active=True, rows_per_s=0.0, lock_wait=0.0):
    return pkg.ShardMetrics(
        sid=sid, active=active, epoch=0, inbox_depth=0, parts_applied=0,
        rows_applied=0, bytes_applied=0, apply_lock_wait_s=lock_wait,
        applied_parts=[], clock_min=0, pub_pending=0, pub_drops=0,
        pub_resyncs=0, publish_lag_s=0.0, updates_per_s=rows_per_s,
        rows_per_s=rows_per_s)


def _gateway(pkg, escalation_rate=0.0, reads_per_s=100.0, n_live=1,
             shedding=False):
    return pkg.GatewayMetrics(
        n_reads=0, n_replica_reads=0, n_master_reads=0, n_escalations=0,
        n_shed=0, n_cache_hits=0, reads_by_slo={}, max_served_staleness=0,
        block_time=0.0, reads_per_replica={}, shedding_fresh=shedding,
        n_live_replicas=n_live, reads_per_s=reads_per_s,
        escalations_per_s=escalation_rate * reads_per_s,
        escalation_rate=escalation_rate)


def _metrics(pkg, shards, gateways=(), window_s=1.0):
    shards = [_shard(pkg, *a, **k) for a, k in shards]
    return pkg.RuntimeMetrics(
        t=0.0, wall_s=10.0, window_s=window_s, clock=5, transport="queue",
        metrics_enabled=True,
        run=pkg.RunMetrics(0, 0, 0, 0, 0, 0.0, 0.0, 0, 0.0, 0.0, 0.0, 0),
        membership=pkg.MembershipMetrics(epoch=0, active=tuple(
            s.sid for s in shards if s.active), n_slots=len(shards),
            n_ops=0),
        snapshots=pkg.SnapshotMetrics(0, 0, -1),
        shards=shards,
        gateways=[_gateway(pkg, **k) for k in gateways])


def S(sid, **kw):
    return ((sid,), kw)


class _Both:
    """A decide()-only Autoscaler in each package (no runtime, no thread,
    just policy state), stepped together on the same synthetic metrics."""

    def __init__(self, **policy):
        self.asc = {}
        for name, pkg in (("ref", R), ("port", P)):
            asc = pkg.Autoscaler.__new__(pkg.Autoscaler)
            asc.policy = pkg.AutoscalePolicy(**policy)
            asc._prev_lock_wait = 0.0
            asc._gw_state = {}
            self.asc[name] = asc

    def decide(self, shards, gateways=(), window_s=1.0):
        got = {name: asc.decide(_metrics(R if name == "ref" else P, shards,
                                         gateways, window_s))
               for name, asc in self.asc.items()}
        assert got["port"] == got["ref"], got
        return got["port"]


# ---------------------------------------------------------------------------
# decide(): the policy matrix on synthetic snapshots, in both packages
# ---------------------------------------------------------------------------


def test_decide_splits_hot_shard():
    asc = _Both(split_imbalance=1.5, split_min_rows_s=100.0)
    assert ("add_shard",) in asc.decide(
        [S(0, rows_per_s=900.0), S(1, rows_per_s=100.0),
         S(2, active=False), S(3, active=False)])


def test_decide_no_split_at_capacity_or_below_min_load():
    asc = _Both(split_imbalance=1.5, split_min_rows_s=100.0, max_shards=2,
                drain_max_rows_s=0.0)
    assert asc.decide([S(0, rows_per_s=900.0),
                       S(1, rows_per_s=100.0)]) == []      # at capacity
    asc2 = _Both(split_imbalance=1.5, split_min_rows_s=1000.0,
                 drain_max_rows_s=0.0)
    assert asc2.decide([S(0, rows_per_s=90.0), S(1, rows_per_s=10.0),
                        S(2, active=False)]) == []        # imbalanced, idle


def test_decide_drains_coldest_when_mean_low():
    m = [S(0, rows_per_s=30.0), S(1, rows_per_s=2.0)]
    assert ("remove_shard", 1) in _Both(drain_max_rows_s=50.0,
                                        min_shards=1).decide(m)
    assert _Both(drain_max_rows_s=50.0,
                 min_shards=2).decide(m) == []            # the floor holds


def test_decide_scales_replicas_on_escalation_rate():
    pol = dict(escalation_hi=0.15, max_replicas=3, min_window_reads=5)
    shards = [S(0, rows_per_s=10.0)]
    assert ("add_replica", 0) in _Both(**pol).decide(
        shards, [dict(escalation_rate=0.4, n_live=1)])
    assert ("add_replica", 0) not in _Both(**pol).decide(
        shards, [dict(escalation_rate=0.4, n_live=3)])
    # a tiny read window is noise, never a scaling signal
    assert _Both(**pol).decide(
        shards, [dict(escalation_rate=1.0, reads_per_s=1.0)]) == []


def test_decide_drains_replica_after_patience_calm_windows():
    pol = dict(escalation_lo=0.01, drain_patience=3, min_replicas=1)
    shards = [S(0, rows_per_s=10.0)]
    calm = [dict(escalation_rate=0.0, n_live=2)]
    asc = _Both(**pol)
    assert asc.decide(shards, calm) == []
    assert asc.decide(shards, calm) == []
    assert ("remove_replica", 0) in asc.decide(shards, calm)   # third window
    # a busy window in between resets the patience counter
    asc2 = _Both(**pol)
    asc2.decide(shards, calm)
    asc2.decide(shards, calm)
    asc2.decide(shards, [dict(escalation_rate=0.05, n_live=2)])
    assert asc2.decide(shards, calm) == []
    # and the floor holds: one live replica is never drained
    asc3 = _Both(**pol)
    floor = [dict(escalation_rate=0.0, n_live=1)]
    asc3.decide(shards, floor)
    asc3.decide(shards, floor)
    assert asc3.decide(shards, floor) == []


def test_decide_shed_fresh_hysteresis():
    asc = _Both(shed_lock_wait_frac=0.25, drain_max_rows_s=0.0)
    assert ("shed_fresh", 0, True) in asc.decide(
        [S(0, rows_per_s=500.0, lock_wait=0.4)], [{}])     # 0.4/1.0 > 0.25
    # wait still growing at 0.2/window: inside the hysteresis band
    # (0.125..0.25) — neither engaged again nor released
    mid = asc.decide([S(0, rows_per_s=500.0, lock_wait=0.6)],
                     [dict(shedding=True)])
    assert [d for d in mid if d[0] == "shed_fresh"] == []
    # fully calm (no new wait): released only below half the threshold
    assert ("shed_fresh", 0, False) in asc.decide(
        [S(0, rows_per_s=500.0, lock_wait=0.6)], [dict(shedding=True)])


# ---------------------------------------------------------------------------
# integration: the loop rebalances a live port runtime
# ---------------------------------------------------------------------------


def test_autoscaler_rebalances_live_runtime():
    seed, n_clocks = 91, 60
    fn = zipf_fn(seed)
    rt = P.PSRuntime(P.RuntimeConfig(4, policies.ssp(3), x0(), n_shards=2,
                                     threads_per_process=2, seed=seed,
                                     max_shards=4, device="cpu"))
    gate = _OpGate(rt, 1, n_clocks)
    rt.start(gate.wrap(fn), n_clocks, timeout=60.0)
    # pump the control loop from the test thread: one poll per 10 ms while
    # the run is live, which outlives the cooldown window
    asc = P.Autoscaler(rt, policy=chaos_autoscale_policy())
    deadline = time.monotonic() + 60.0
    while rt.running and rt.completed_clock() < n_clocks:
        assert time.monotonic() < deadline
        asc.step()
        time.sleep(0.01)
    stats = rt.wait()
    assert stats.violations == [], stats.violations[:5]
    summary = asc.summary()
    assert summary.get("add_shard", 0) + summary.get("remove_shard", 0) >= 1, (
        summary, asc.actions)
    for k, ref in expected_final(seed, 4, n_clocks, fn=fn).items():
        np.testing.assert_array_equal(rt.master_value(k).reshape(ref.shape),
                                      ref)
    # every recorded action carries an outcome; failures only ever come
    # from ops racing the quiesce, never from a raised exception
    assert all(isinstance(a.ok, bool) for a in asc.actions)
    assert rt.metrics().membership.n_ops == len(rt.membership.log) >= 1
