"""The port's unified metrics surface against the JAX package's.

Mirrors ``tests/test_metrics.py``'s exact-reconciliation test (over the
queue, shm and tcp transports), its windowed-rates test, its metrics-off
test and its two gateway tests (the read cache is never staler than
requested; fresh-read shedding): the same seeded schedule runs through
``repro.runtime`` and through ``repro_torch.runtime`` (``device="cpu"``),
and after ``wait()`` every total in ``rt.metrics()`` equals the
authoritative counters exactly, and the same totals in both packages.  The
serving corners (``replicas``, ``gateways``, the shards' ``pub_*``) read
the registered replica sets and gateways; membership reports the static
epoch-0 partition (ROADMAP Queue 1 item 5.4).  The legacy-constructor
tests are not mirrored: the port's ``PSRuntime`` takes only a
``RuntimeConfig``.
"""
import dataclasses
import time

import numpy as np
import pytest

from repro.core import policies as ref_policies
from repro.runtime import FRESH as REF_FRESH
from repro.runtime import PSRuntime as RefPSRuntime
from repro.runtime import ReadGateway as RefReadGateway
from repro.runtime import ReadShedError as RefReadShedError
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import metrics as ref_metrics
from repro_torch.core import policies
from repro_torch.runtime import (FRESH, PSRuntime, ReadGateway,
                                 ReadShedError, RuntimeConfig,
                                 RuntimeMetrics)
from repro_torch.runtime import metrics as metrics_mod

pytestmark = pytest.mark.filterwarnings("ignore:os.fork:RuntimeWarning")

REF = dict(PSRuntime=RefPSRuntime, RuntimeConfig=RefRuntimeConfig,
           policies=ref_policies, ReadGateway=RefReadGateway,
           ReadShedError=RefReadShedError, FRESH=REF_FRESH, kw={})
PORT = dict(PSRuntime=PSRuntime, RuntimeConfig=RuntimeConfig,
            policies=policies, ReadGateway=ReadGateway,
            ReadShedError=ReadShedError, FRESH=FRESH, kw={"device": "cpu"})
PKGS = (("ref", REF), ("port", PORT))


def _x0():
    return {"a": np.zeros((8, 4)), "b": np.ones(6)}


def _fn(seed):
    def fn(w, clock, view, rng):
        r = np.random.default_rng((seed, w, clock))
        return {"a": r.integers(-2, 3, size=(8, 4)).astype(float),
                "b": r.integers(-2, 3, size=6).astype(float)}
    return fn


def _run(P, transport, n_workers=2, n_clocks=8, **kw):
    rt = P["PSRuntime"](P["RuntimeConfig"](
        n_workers, P["policies"].ssp(2), _x0(), n_shards=2,
        transport=transport, **P["kw"], **kw))
    rt.start(_fn(7), n_clocks, timeout=60.0)
    stats = rt.wait()
    return rt, stats


def test_metrics_dataclasses_mirror_the_reference():
    """Every dataclass of the tree has the reference's fields, in order."""
    for name in ("ShardMetrics", "ProcessMetrics", "ReplicaMetrics",
                 "GatewayMetrics", "MembershipMetrics", "SnapshotMetrics",
                 "RunMetrics", "RuntimeMetrics"):
        ours = [f.name for f in dataclasses.fields(getattr(metrics_mod,
                                                           name))]
        theirs = [f.name for f in dataclasses.fields(getattr(ref_metrics,
                                                             name))]
        assert ours == theirs, name
    for slo in (None, "fresh", 0, 3):
        assert metrics_mod.slo_key(slo) == ref_metrics.slo_key(slo)


@pytest.mark.parametrize("transport", ["queue", "shm", "tcp"])
def test_metrics_reconcile_exactly_after_quiesce(transport):
    n_workers, n_clocks = 2, 8
    totals = {}
    for name, P in PKGS:
        rt, stats = _run(P, transport, n_workers, n_clocks)
        m = rt.metrics()
        assert m.transport == rt.transport_kind
        assert m.metrics_enabled
        assert m.run.n_updates == stats.n_updates == n_workers * n_clocks * 2
        assert m.run.n_violations == len(stats.violations) == 0
        assert m.run.bytes_sent == stats.bytes_sent
        assert sorted(p.process for p in m.processes) == list(
            range(rt.n_proc))
        assert all(p.clock == n_clocks - 1 for p in m.processes)
        assert sum(p.n_updates for p in m.processes) == stats.n_updates
        applied = np.zeros(rt.n_proc, dtype=np.int64)
        for s in m.shards:
            applied += np.asarray(s.applied_parts, dtype=np.int64)
        assert applied.tolist() == rt._parts_sent.tolist()
        assert sum(s.parts_applied for s in m.shards) == int(
            rt._parts_sent.sum())
        assert sum(s.rows_applied for s in m.shards) > 0
        assert sum(s.bytes_applied for s in m.shards) > 0
        assert m.membership.active == rt.partition.active
        assert m.membership.n_slots == rt.n_slots
        assert m.clock == n_clocks
        assert m.replicas == [] and m.gateways == []
        assert all(s.clock_min == n_clocks - 1 for s in m.shards)
        totals[name] = (m.run.n_updates, applied.tolist(),
                        sum(s.rows_applied for s in m.shards),
                        sum(s.bytes_applied for s in m.shards),
                        m.membership.epoch, m.membership.n_ops, m.clock,
                        m.snapshots.n_snapshots, m.snapshots.last_clock)
    assert totals["port"] == totals["ref"]


def test_metrics_windowed_rates_and_imbalance():
    for _, P in PKGS:
        rt, stats = _run(P, "queue")
        m1 = rt.metrics()
        assert m1.window_s > 0
        assert sum(s.updates_per_s for s in m1.shards) > 0
        assert m1.shard_imbalance() >= 1.0
        assert m1.hottest_shard().rows_per_s >= m1.coldest_shard().rows_per_s
        m2 = rt.metrics()
        assert sum(s.updates_per_s for s in m2.shards) == 0.0
        assert m2.run.n_updates == m1.run.n_updates == stats.n_updates


def test_metrics_disabled_still_collects_quiesced_truth():
    for _, P in PKGS:
        rt, stats = _run(P, "queue", metrics=False)
        m = rt.metrics()
        assert not m.metrics_enabled
        assert m.processes == []
        assert m.run.n_updates == stats.n_updates
        applied = np.zeros(rt.n_proc, dtype=np.int64)
        for s in m.shards:
            applied += np.asarray(s.applied_parts, dtype=np.int64)
        assert applied.tolist() == rt._parts_sent.tolist()
        assert all(s.apply_lock_wait_s == 0.0 for s in m.shards)


def test_metrics_tree_type_and_snapshot_corner(tmp_path):
    """The port's tree is its own RuntimeMetrics, and its snapshot corner
    reads the periodic snapshots as the reference's does (which clocks
    fire depends on thread timing: snapshots are boundary-triggered)."""
    for name, P in PKGS:
        rt, _ = _run(P, "queue", snapshot_every=3,
                     snapshot_dir=str(tmp_path / name))
        m = rt.metrics()
        assert m.snapshots.n_snapshots == len(rt.snapshots) >= 1
        assert m.snapshots.snapshot_every == 3
        assert m.snapshots.last_clock == rt.snapshots[-1][0]
        assert 6 <= m.snapshots.last_clock <= 8
    assert isinstance(m, RuntimeMetrics)


# ---------------------------------------------------------------------------
# the serving corners: gateways, replicas, publish backpressure
# ---------------------------------------------------------------------------


@pytest.mark.serving
def test_gateway_cache_never_staler_than_requested():
    for _, P in PKGS:
        rt = P["PSRuntime"](P["RuntimeConfig"](
            2, P["policies"].ssp(2), _x0(), n_shards=2, **P["kw"]))
        rt.start(_fn(11), 12, timeout=60.0)
        gw = P["ReadGateway"](rt, n_replicas=1, read_cache=True)
        try:
            seen = []
            while rt.running and rt.completed_clock() < 12:
                for slo in (0, 1, None):
                    res = gw.read("a", slo=slo, timeout=10.0)
                    if isinstance(slo, int):
                        assert res.staleness <= slo, (res.source,
                                                      res.staleness)
                    seen.append(res.source)
            rt.wait()
            # the frontier advanced since every mid-run cache fill, so a
            # final slo=0 read reflects the final master state
            final = gw.read("a", slo=0, timeout=10.0)
            np.testing.assert_array_equal(
                final.value, rt.master_value("a").reshape(final.value.shape))
            assert final.staleness == 0
            # and now the cache can serve it: hit, stamped 0 against the vc
            hit = gw.read("a", slo=0, timeout=10.0)
            assert hit.source == "cache" and hit.staleness == 0
            np.testing.assert_array_equal(hit.value, final.value)
            m = rt.metrics()
            assert m.gateways[0].n_cache_hits == gw.stats.n_cache_hits >= 1
            assert m.gateways[0].reads_by_slo.get("0", 0) >= 2
        finally:
            gw.close()


@pytest.mark.serving
def test_gateway_shed_fresh_admission():
    # the gateway subscribes before the run, so its bounded read finds a
    # caught-up replica (built after wait(), the replica never bootstraps
    # and the read escalates at its 30 s deadline, as in the reference)
    for _, P in PKGS:
        rt = P["PSRuntime"](P["RuntimeConfig"](
            2, P["policies"].ssp(2), _x0(), n_shards=2, **P["kw"]))
        gw = P["ReadGateway"](rt, n_replicas=1, read_cache=False)
        try:
            rt.run(_fn(7), 8, timeout=60.0)
            gw.set_shed_fresh(True)
            with pytest.raises(P["ReadShedError"]):
                gw.read("a", slo=P["FRESH"])
            res = gw.read("a", slo=1)        # bounded reads still admitted
            assert res.staleness <= 1
            gw.set_shed_fresh(False)
            assert gw.read("a", slo=P["FRESH"]).source == "master"
            m = rt.metrics()
            assert m.gateways[0].n_shed == 1
            assert not m.gateways[0].shedding_fresh
            assert m.gateways[0].reads_by_slo["fresh"] == 2
        finally:
            gw.close()


@pytest.mark.serving
def test_serving_metrics_reconcile_with_the_replicas():
    """Subscribed before the run, one replica ingests every publish: at
    quiesce the tree's replica corner reports it caught up, its delta and
    byte counts equal the object's, and both packages count the same
    bytes ingested (every applied row's delta, once per replica)."""
    totals = {}
    for name, P in PKGS:
        rt = P["PSRuntime"](P["RuntimeConfig"](
            2, P["policies"].ssp(2), _x0(), n_shards=2, **P["kw"]))
        gw = P["ReadGateway"](rt, n_replicas=2)
        try:
            rt.run(_fn(7), 8, timeout=60.0)
            rset = gw.replicas
            deadline = time.monotonic() + 15
            while any(rset.staleness(r.vc, rset.master_vc())
                      for r in rset.replicas):
                assert time.monotonic() < deadline, f"{name}: no catch-up"
                time.sleep(5e-3)
            res = gw.read("a", slo=0, timeout=10.0)
            m = rt.metrics()
            assert [r.rid for r in m.replicas] == [0, 1]
            for rm, rep in zip(m.replicas, rset.replicas):
                assert rm.staleness == 0 and not rm.poisoned and not rm.stale
                assert rm.deltas_applied == rep.deltas_applied > 0
                assert rm.bytes_ingested == rep.bytes_ingested
            assert sum(r.reads for r in m.replicas) == 1
            assert m.gateways[0].n_replica_reads == 1
            assert m.gateways[0].n_live_replicas == 2
            assert res.source.startswith("replica:")
            assert all(s.pub_drops == s.pub_resyncs == 0 for s in m.shards)
            assert all(s.pub_pending == 0 for s in m.shards)
            totals[name] = [r.bytes_ingested for r in m.replicas]
        finally:
            gw.close()
    assert totals["port"] == totals["ref"]
    assert totals["port"][0] == totals["port"][1] > 0
