"""The port's serving tier (``repro_torch.runtime.serving``) against the JAX
package's, on the CPU.

Every test of ``tests/test_serving.py`` is mirrored on the port
(``device="cpu"``, so the replicas' ingest runs ``ps_apply``'s plain
version through the same wrapper): the measured staleness of every read
obeys its SLO under free interleavings for SSP, VAP and CVAP, over the
queue, shm and tcp serving transports, over forked clients, through
escalation, across a mid-run join from a snapshot, with a poisoned replica
and a wedged one that drops and resyncs.  Then the cross-package tests:

  * the same seeded sequence of state, delta (duplicate rows, rows behind
    their epoch cut) and vc messages through a reference ``Replica`` and a
    port ``Replica``: values and vc bitwise equal, and the same
    ``stale_row_drops``; each key of an ingest batch is one ``ps_apply``
    call;
  * bsp with ``barrier_reads`` in both packages on the same seed: the
    port's replica buffers at quiesce are bitwise the reference's master;
  * a shard publishing parts decoded as views into a shm ring, the ring
    then wrapped over them before the replica drains the publish: the
    replica still lands exactly what was sent.

Every wait has its own deadline.  The card's cases are in
``tests/test_torch_serving_cuda.py``, which imports nothing of JAX.
"""
import gc
import itertools
import os
import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import policies as ref_policies
from repro.runtime import PSRuntime as RefPSRuntime
from repro.runtime import ReadGateway as RefReadGateway
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import messages as RM
from repro.runtime.serving import Replica as RefReplica
from repro_torch.core import policies
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.runtime import (FRESH, PSRuntime, ReadGateway,
                                 RuntimeConfig, UpdateMsg)
from repro_torch.runtime import messages as M
from repro_torch.runtime import transport as T
from repro_torch.runtime.serving import Replica, ReplicaSet

pytestmark = [pytest.mark.serving,
              pytest.mark.filterwarnings("ignore:os.fork:RuntimeWarning"),
              pytest.mark.filterwarnings("ignore::DeprecationWarning")]


def _x0():
    return {"a": np.zeros((8, 4)), "b": np.zeros(5)}


def _fn(pause=0.0):
    def fn(w, clock, view, rng):
        if pause:
            time.sleep(pause)
        return {"a": rng.normal(0.0, 0.6, size=(8, 4)),
                "b": rng.normal(0.0, 0.6, size=5)}
    return fn


def _rt(n_workers, pol, x0=None, **kw):
    return PSRuntime(RuntimeConfig(n_workers, pol,
                                   _x0() if x0 is None else x0,
                                   device="cpu", **kw))


_POLICIES = [
    ("ssp3", policies.ssp(3)),
    ("vap", policies.vap(1.5)),
    ("cvap", policies.cvap(3, 1.5)),
]


# ---------------------------------------------------------------------------
# the core contract: measured <= requested, under free interleaving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("polname,pol", _POLICIES,
                         ids=[p[0] for p in _POLICIES])
def test_slo_honored_under_free_interleaving(polname, pol):
    """4 free-running workers, 200 clocks; the gateway serves a rotating
    mix of SLOs the whole run and every response's *measured* staleness —
    stamped against the live master vector clock — obeys the request."""
    rt = _rt(4, pol, n_shards=2, threads_per_process=2, seed=7)
    rt.start(_fn(), 200, timeout=110)
    gw = ReadGateway(rt, n_replicas=2, transport="queue")
    slos = itertools.cycle([0, 2, 5, None])
    n = 0
    try:
        while rt.running:
            slo = next(slos)
            res = gw.read("a", slo=slo, timeout=5.0)
            bound = float("inf") if slo is None else slo
            assert res.staleness <= bound, (
                f"SLO violated: measured {res.staleness} > requested {slo} "
                f"(source {res.source})")
            assert res.staleness >= 0
            n += 1
            time.sleep(1e-3)       # pace the reader off the workers' GIL
        st = rt.wait()
        assert st.violations == [], st.violations[:5]
        for key in ("a", "b"):
            res = gw.read(key, slo=0, timeout=15.0)
            np.testing.assert_array_equal(res.value, rt.master_value(key),
                                          err_msg=f"{polname} replica[{key}]")
            assert res.staleness == 0
        assert gw.replicas.violations == []
        assert gw.replicas.errors == []
        assert gw.stats.n_replica_reads > 0          # not all escalated
        assert n > 0
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# serving transports: queue + shm + tcp publish streams, >= 2 replicas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("serving", ["queue", "shm", "tcp"])
def test_gateway_serves_over_transport(serving):
    """Two replicas fed over the given transport both serve reads; stamps
    obey the SLO mid-run and the replicas converge to the master exactly."""
    rt = _rt(4, policies.ssp(3), n_shards=2, threads_per_process=2, seed=3)
    rt.start(_fn(pause=0.002), 60, timeout=90)
    gw = ReadGateway(rt, n_replicas=2, transport=serving)
    try:
        while rt.running:
            res = gw.read("a", slo=3, timeout=5.0)
            assert res.staleness <= 3
            time.sleep(1e-3)
        st = rt.wait()
        assert st.violations == []
        for key in ("a", "b"):
            res = gw.read(key, slo=0, timeout=15.0)
            np.testing.assert_array_equal(res.value, rt.master_value(key),
                                          err_msg=f"{serving} replica[{key}]")
        for _ in range(4):
            gw.read("a", slo=0, timeout=15.0)
        assert set(gw.stats.reads_per_replica) == {0, 1}
        assert gw.replicas.violations == []
        assert gw.replicas.errors == []
        # the buffers live on the runtime's device, and every delta batch
        # landed through the ps_apply wrapper
        for rep in gw.replicas.replicas:
            assert all(v.device == rt.device and v.dtype == torch.float64
                       for v in rep.values.values())
            assert rep.deltas_applied > 0 and rep.ingest_applies > 0
    finally:
        gw.close()


@pytest.mark.parametrize("transport,serving", [("proc", "shm"),
                                               ("tcp", "tcp")])
def test_serving_over_multiprocess_runtime(transport, serving):
    """Forked clients over a wire *and* a replica tier over a wire: the
    write path and the read path share the transport machinery end to
    end."""
    rt = _rt(2, policies.ssp(3), n_shards=2, threads_per_process=1, seed=5,
             transport=transport)
    rt.start(_fn(pause=0.002), 40, timeout=120)
    gw = ReadGateway(rt, n_replicas=2, transport=serving)
    try:
        while rt.running:
            res = gw.read("a", slo=3, timeout=5.0)
            assert res.staleness <= 3
            time.sleep(1e-3)
        st = rt.wait()
        assert st.violations == []
        res = gw.read("a", slo=0, timeout=15.0)
        np.testing.assert_array_equal(res.value, rt.master_value("a"))
        assert gw.replicas.errors == []
    finally:
        gw.close()


def test_replica_set_before_start_on_a_wire_transport_raises():
    """The wire transports fork at start(), and a replica set starts
    threads: the port refuses to build one before the fork (the queue
    transport, which never forks, takes one before start)."""
    rt = _rt(2, policies.ssp(1), n_shards=1, transport="shm")
    n_threads = threading.active_count()
    with pytest.raises(RuntimeError, match="after rt.start"):
        ReadGateway(rt, n_replicas=1, transport="shm")
    assert rt._replica_sets == [] and rt._gateways == []
    assert threading.active_count() == n_threads
    # on queue it is fine before start
    rt = _rt(2, policies.ssp(1), n_shards=1)
    gw = ReadGateway(rt, n_replicas=1)
    try:
        rt.run(_fn(), 3, timeout=60)
        res = gw.read("a", slo=0, timeout=10.0)
        np.testing.assert_array_equal(res.value, rt.master_value("a"))
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# fresh reads + escalation
# ---------------------------------------------------------------------------


def test_fresh_reads_escalate_to_master():
    rt = _rt(2, policies.ssp(2), n_shards=2, seed=1)
    rt.start(_fn(pause=0.002), 30, timeout=60)
    gw = ReadGateway(rt, n_replicas=1, transport="queue")
    try:
        saw_master = 0
        while rt.running:
            res = gw.read("a", slo=FRESH, timeout=5.0)
            assert res.source == "master"
            assert res.staleness == 0
            saw_master += 1
        rt.wait()
        assert saw_master > 0
        assert gw.stats.n_master_reads == saw_master
    finally:
        gw.close()


def test_unattainable_slo_escalates_to_master():
    """A replica pinned behind the master frontier cannot satisfy slo=0:
    the gateway parks on the doorbell, hits the deadline, and escalates —
    the response is the master value, stamped staleness 0."""
    rt = _rt(2, policies.ssp(2), n_shards=2, seed=2)
    gw = ReadGateway(rt, n_replicas=1, transport="queue")
    rt.run(_fn(), 10, timeout=60)
    try:
        rep = gw.replicas.replicas[0]
        res = gw.read("a", slo=0, timeout=10.0)
        assert res.escalated is False
        with rep.lock:
            rep.vc -= 3
        res = gw.read("a", slo=0, timeout=0.6)
        assert res.escalated is True
        assert res.source == "master"
        assert res.staleness == 0
        np.testing.assert_array_equal(res.value, rt.master_value("a"))
        assert gw.stats.n_escalations == 1
        assert gw.stats.block_time > 0.0            # parked on the doorbell
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# mid-run join: snapshot bootstrap + in-stream state
# ---------------------------------------------------------------------------


def test_replica_joins_mid_run_equals_master_at_quiesce(tmp_path):
    """A replica added mid-run — warm-started from the latest periodic
    snapshot, corrected by the shards' in-stream bootstrap states — holds
    exactly the master state once the runtime quiesces."""
    rt = _rt(4, policies.ssp(3), n_shards=2, threads_per_process=2, seed=9,
             snapshot_every=5, snapshot_dir=str(tmp_path))
    rt.start(_fn(pause=0.002), 40, timeout=120)
    gw = ReadGateway(rt, n_replicas=1, transport="queue")
    try:
        deadline = time.monotonic() + 60
        while rt.latest_snapshot() is None and rt.running:
            assert time.monotonic() < deadline
            time.sleep(2e-3)
        assert rt.latest_snapshot() is not None
        joined = gw.add_replica(bootstrap_from_snapshot=True)
        while rt.running:
            res = gw.read("a", slo=4, timeout=5.0)
            assert res.staleness <= 4
            time.sleep(1e-3)
        st = rt.wait()
        assert st.violations == []
        deadline = time.monotonic() + 15
        rset = gw.replicas
        while rset.staleness(joined.vc, rset.master_vc()) > 0:
            assert time.monotonic() < deadline, "joined replica never caught up"
            time.sleep(5e-3)
        for key in ("a", "b"):
            value, _ = joined.serve(key)
            np.testing.assert_array_equal(
                value.reshape(rt._shapes[key]),
                rt.master_value(key), err_msg=f"joined replica[{key}]")
        assert gw.replicas.violations == []
        assert gw.replicas.errors == []
    finally:
        gw.close()


def test_poisoned_replica_leaves_the_rotation():
    """A replica whose ingest raised can no longer guarantee its vector
    clock covers its values: the gateway must never route to it again."""
    rt = _rt(2, policies.ssp(2), n_shards=2, seed=4)
    gw = ReadGateway(rt, n_replicas=2, transport="queue")
    rt.run(_fn(), 6, timeout=60)
    try:
        rep0 = gw.replicas.replicas[0]

        class Bogus:                       # not a publish message type
            shard = 0
            seq = 10 ** 6

        rep0.inbox.put(Bogus())
        deadline = time.monotonic() + 10
        while not rep0.poisoned:
            assert time.monotonic() < deadline, "ingest error not recorded"
            time.sleep(2e-3)
        assert gw.replicas.errors != []
        for _ in range(4):
            res = gw.read("a", slo=0, timeout=10.0)
            assert res.source == "replica:1", res.source
            np.testing.assert_array_equal(res.value, rt.master_value("a"))
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# guard rails
# ---------------------------------------------------------------------------


def test_gateway_rejects_bad_slo_and_transport():
    rt = _rt(2, policies.bsp(), n_shards=2)
    with pytest.raises(ValueError, match="serving transport"):
        ReplicaSet(rt, 1, transport="carrier-pigeon")
    with pytest.raises(ValueError, match="replica"):
        ReplicaSet(rt, 0)
    gw = ReadGateway(rt, n_replicas=1, transport="queue")
    try:
        with pytest.raises(ValueError, match="slo"):
            gw.read("a", slo=-1)
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# replica ingest backpressure: drop-and-resync
# ---------------------------------------------------------------------------


def test_wedged_replica_never_stalls_publish_and_resyncs():
    """A deliberately wedged replica (its ring reader paused) must not
    stall the shard's publish write: the shard drops its frames once the
    tiny ring fills (pub_drops > 0), keeps applying updates, and
    re-bootstraps the replica with a fresh in-stream state cut once the
    ring drains — after which the replica equals the master exactly."""
    def fn(w, clock, view, rng):
        time.sleep(1e-3)
        return {"a": rng.normal(0.0, 0.6, size=(8, 4))}

    rt = _rt(2, policies.ssp(3), {"a": np.zeros((8, 4))}, n_shards=2, seed=0)
    rt.start(fn, 400, timeout=110)
    rset = ReplicaSet(rt, n_replicas=2, transport="shm", ring_capacity=1)
    try:
        time.sleep(0.1)
        rset.wedge(0, True)
        deadline = time.monotonic() + 60
        while rt.running and rset.pub_drops == 0:
            assert time.monotonic() < deadline, "wedged ring never filled"
            time.sleep(0.005)
        assert rset.pub_drops > 0, "publish should have dropped, not blocked"
        assert 0 in rset.stale_replicas
        rset.wedge(0, False)
        while rt.running and rset.pub_resyncs == 0:
            assert time.monotonic() < deadline, "recovery resync never came"
            time.sleep(0.005)
        st = rt.wait()
        assert st.violations == [], st.violations[:5]
        assert rset.pub_resyncs > 0
        assert rset.errors == [] and rset.violations == []
        deadline = time.monotonic() + 10
        while (0 in rset.stale_replicas
               or any(rset.staleness(r.vc, rset.master_vc())
                      for r in rset.replicas)):
            assert time.monotonic() < deadline, "final publishes never drained"
            time.sleep(0.01)
        m = rt.metrics()
        assert sum(s.pub_drops for s in m.shards) == rset.pub_drops
        assert sum(s.pub_resyncs for s in m.shards) == rset.pub_resyncs
        for rep in rset.replicas:
            assert not rep.poisoned
            v, _ = rep.serve("a")
            np.testing.assert_allclose(
                v, rt.master_value("a").reshape(v.shape), atol=1e-9,
                err_msg=f"replica {rep.rid} did not recover exactly")
    finally:
        rset.close()
        if rt.running:
            rt.wait()


# ---------------------------------------------------------------------------
# cross-package: one Replica's ingest, message for message
# ---------------------------------------------------------------------------


def _standin(x0, n_slots, n_proc, device=None):
    """The attributes a Replica reads from its set and runtime."""
    rt = SimpleNamespace(_x0=x0, n_slots=n_slots, n_proc=n_proc,
                         trace_on=False, _trace=None,
                         device=None if device is None
                         else torch.device(device))
    rset = SimpleNamespace(rt=rt, check=True, violations=[], errors=[],
                           notified=0)
    rset._violation = rset.violations.append
    rset._record_error = rset.errors.append
    rset.master_vc = lambda: np.full((n_slots, n_proc), -1, dtype=np.int64)

    def notify():
        rset.notified += 1
    rset._notify = notify
    return rset


def _publish_specs(seed, x0, n_slots=2, n_proc=3, n_msgs=40):
    """A seeded publish sequence: states (with epoch cuts), deltas (rows
    drawn with repeats, epochs below and at the cuts) and vc stamps, each
    stamped with its shard's FIFO seq.  Returns specs and the batches to
    split them into."""
    rng = np.random.default_rng(seed)
    keys = list(x0)
    seqs = [0] * n_slots
    specs = []

    def state(shard, epoch):
        st = {}
        for k, v in x0.items():
            rows = np.arange(shard, v.shape[0], n_slots, dtype=np.int64)
            st[k] = {"rows": rows,
                     "values": rng.normal(size=(rows.size, v.shape[1]))}
        return ("state", shard, st, rng.integers(-1, 6, n_proc), epoch)

    for shard in range(n_slots):
        specs.append(state(shard, 1 + shard))
    for i in range(n_msgs):
        shard = int(rng.integers(n_slots))
        u = rng.random()
        if u < 0.7:
            k = keys[int(rng.integers(len(keys)))]
            R, C = x0[k].shape
            n = int(rng.integers(1, 3 * R))
            specs.append(("delta", shard, k,
                          rng.integers(0, R, n).astype(np.int64),
                          rng.normal(size=(n, C)), int(rng.integers(0, 4))))
        elif u < 0.93:
            specs.append(("vc", shard, rng.integers(-1, 9, n_proc)))
        else:
            specs.append(state(shard, int(rng.integers(1, 4))))
    out = []
    for s in specs:
        out.append((s, seqs[s[1]]))
        seqs[s[1]] += 1
    cuts = sorted(rng.choice(np.arange(1, len(out)), size=6, replace=False))
    return out, [0, *cuts, len(out)]


def _build(P, spec, seq):
    kind, shard = spec[0], spec[1]
    if kind == "state":
        st = {k: {"rows": v["rows"].copy(), "values": v["values"].copy()}
              for k, v in spec[2].items()}
        m = P.ReplicaStateMsg(shard, st, spec[3].copy(), epoch=spec[4])
    elif kind == "delta":
        m = P.ReplicaDeltaMsg(shard, spec[2], spec[3].copy(), spec[4].copy(),
                              epoch=spec[5])
    else:
        m = P.ReplicaVcMsg(shard, spec[2].copy())
    m.seq = seq
    return m


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_replica_ingest_bitwise_against_the_reference(seed, monkeypatch):
    rng = np.random.default_rng(100 + seed)
    x0 = {"a": rng.normal(size=(12, 3)), "b": rng.normal(size=(7, 1))}
    specs, cuts = _publish_specs(seed, x0)
    calls = []
    orig = apply_ops.scatter_add_

    def counting(dense, rows, delta, **kw):
        calls.append(rows.shape[0])
        return orig(dense, rows, delta, **kw)

    monkeypatch.setattr(apply_ops, "scatter_add_", counting)
    ref = RefReplica(_standin(x0, 2, 3), 0)
    port = Replica(_standin(x0, 2, 3, "cpu"), 0)
    for lo, hi in zip(cuts, cuts[1:]):
        for rep, P in ((ref, RM), (port, M)):
            rep._handle_batch([_build(P, s, q) for s, q in specs[lo:hi]])
    for rep in (ref, port):
        assert rep.rset.errors == [] and rep.rset.violations == []
        assert not rep.poisoned
    for k in x0:
        got = port.values[k].numpy()
        assert got.dtype == ref.values[k].dtype == np.float64
        assert got.tobytes() == ref.values[k].tobytes(), k
    assert np.array_equal(port.vc, ref.vc)
    assert port.stale_row_drops == ref.stale_row_drops > 0
    assert port.deltas_applied == ref.deltas_applied
    assert port.bytes_ingested == ref.bytes_ingested
    assert port.rset.notified == ref.rset.notified
    # deltas are gathered per key between state messages within a batch:
    # one ps_apply call each, never one per message
    groups = 0
    for lo, hi in zip(cuts, cuts[1:]):
        pending = set()
        for (s, _q) in specs[lo:hi]:
            if s[0] == "state":
                groups += len(pending)
                pending = set()
            elif s[0] == "delta":
                pending.add(s[2])
        groups += len(pending)
    assert port.ingest_applies == len(calls) == groups
    assert groups < port.deltas_applied


def test_replica_serve_copies_out_of_the_device_buffer():
    x0 = {"a": np.arange(12.0).reshape(4, 3)}
    rep = Replica(_standin(x0, 1, 1, "cpu"), 0)
    value, vc = rep.serve("a")
    value[:] = -1.0
    vc[:] = 99
    assert rep.values["a"].numpy().tobytes() == x0["a"].tobytes()
    assert (rep.vc == -1).all() and rep.reads == 1


# ---------------------------------------------------------------------------
# cross-package: bsp with barrier_reads, replica buffers vs the master
# ---------------------------------------------------------------------------


def _bsp_fn(w, clock, view, rng):
    # integer deltas, as LDA's counts: the parts of one clock reach a shard
    # from three processes in whichever order the threads run, and only
    # exact sums make the final state independent of it.  Each delta
    # depends on what the worker read, so the views must agree too.
    a = view.get("a")
    return {"a": np.round(rng.normal(0.0, 4.0, size=(10, 3)))
            + np.floor(a[::-1] / 8.0),
            "b": np.round(rng.normal(0.0, 4.0, size=6))}


def test_bsp_replica_bitwise_equals_the_reference_master():
    x0 = {"a": np.arange(30, dtype=float).reshape(10, 3), "b": np.zeros(6)}
    out = {}
    for name, PS, Cfg, pol, GW, kw in (
            ("ref", RefPSRuntime, RefRuntimeConfig, ref_policies.bsp(),
             RefReadGateway, {}),
            ("port", PSRuntime, RuntimeConfig, policies.bsp(), ReadGateway,
             {"device": "cpu"})):
        rt = PS(Cfg(3, pol, x0, n_shards=2, threads_per_process=1, seed=11,
                    barrier_reads=True, **kw))
        gw = GW(rt, n_replicas=1, transport="queue")
        try:
            st = rt.run(_bsp_fn, 8, timeout=60)
            assert st.violations == []
            rset = gw.replicas
            rep = rset.replicas[0]
            deadline = time.monotonic() + 15
            while rset.staleness(rep.vc, rset.master_vc()) > 0:
                assert time.monotonic() < deadline, f"{name} never caught up"
                time.sleep(5e-3)
            out[name] = {
                "master": {k: rt.master_value(k) for k in x0},
                "replica": {k: rep.serve(k)[0].reshape(rt._shapes[k])
                            for k in x0}}
        finally:
            gw.close()
    for k in x0:
        want = out["ref"]["master"][k].tobytes()
        assert out["port"]["replica"][k].tobytes() == want, k
        assert out["port"]["master"][k].tobytes() == want, k
        assert out["ref"]["replica"][k].tobytes() == want, k


# ---------------------------------------------------------------------------
# ring views: the publish owns its arrays before the frame pins drop
# ---------------------------------------------------------------------------


def test_publish_from_ring_views_survives_the_ring_wrapping():
    """Update parts decoded as views into a shm ring go through the shard's
    apply with a replica subscribed, the batch's pins are released, and the
    ring's bytes are overwritten by later frames (the ring wraps) before
    the replica drains the publish.  The replica must still land exactly
    what was sent: the shard copies a single part's arrays out of the ring
    before publishing them."""
    x0 = {"a": np.zeros((8, 4)), "b": np.zeros((6, 1))}
    rt = _rt(1, policies.ssp(1), x0, n_shards=1)
    shard = rt.shards[0]
    pub: queue.Queue = queue.Queue()
    chan = M.Channel("s0->r0", pub)
    shard._handle_batch([M.SubscribeMsg(0, chan)])
    boot = pub.get_nowait()
    assert isinstance(boot, M.ReplicaStateMsg)

    cap = 4096
    ring = T.ShmRing.create(cap)
    codec = T.RowCodec(list(x0))
    bell = os.pipe()
    reader = T.RingViewReader(ring, codec, bell[0], threading.Event())
    wire = T.WireChannel("zc", T.ring_parts_writer(ring), max_frame=cap // 4,
                         codec=codec,
                         on_flush=lambda: T.ShmEdge.ring_bell(bell[1]))
    # the filler rides the same ring on a channel of its own, so the
    # shard's FIFO seqs stay contiguous
    filler = T.WireChannel("fill", T.ring_parts_writer(ring),
                           max_frame=cap // 4, codec=codec)
    rng = np.random.default_rng(5)
    want = {k: v.copy() for k, v in x0.items()}
    try:
        uid = 0
        for clock in range(3):
            # one part per key: the single-part apply path, whose arrays
            # are the ring views themselves
            sent = [UpdateMsg(uid, 0, 0, clock, "a",
                              np.arange(clock, 8, dtype=np.int64),
                              rng.integers(-5, 6, size=(8 - clock, 4))
                              .astype(float)),
                    UpdateMsg(uid + 1, 0, 0, clock, "b",
                              np.arange(6, dtype=np.int64),
                              rng.integers(-5, 6, size=(6, 1)).astype(float))]
            uid += 2
            wire.send_many(sent)
            got = []
            deadline = time.monotonic() + 10
            while len(got) < len(sent):
                assert time.monotonic() < deadline
                got.extend(reader._decode_ready())
            assert all(getattr(m, "_frame", None) is not None for m in got)
            for m in sent:
                want[m.key][m.rows] += m.delta
            shard._handle_batch(got)         # applies, publishes, releases
            del got
            for _ in range(12):              # > cap bytes of filler
                filler.send_many([UpdateMsg(10 ** 6, 0, 0, clock, "a",
                                          np.arange(8, dtype=np.int64),
                                          np.full((8, 4), 1e300))])
                drained = []
                while not drained:
                    drained.extend(reader._decode_ready())
                T.release_msgs(drained)
                del drained
        published = []
        while not pub.empty():
            published.append(pub.get_nowait())
        deltas = [m for m in published if isinstance(m, M.ReplicaDeltaMsg)]
        assert len(deltas) == 6
        rep = Replica(_standin(x0, 1, 1, "cpu"), 0)
        rep._handle_batch([boot] + published)
        assert not rep.poisoned, rep.rset.errors
        assert rt.stats.violations == []
        for k in x0:
            np.testing.assert_array_equal(rep.values[k].numpy(), want[k])
            np.testing.assert_array_equal(
                rt.master_value(k).reshape(want[k].shape), want[k])
    finally:
        gc.collect()
        ring.close()
        ring.unlink()
        for fd in bell:
            os.close(fd)
