"""The port's tracing tier against the JAX package's.

Mirrors ``tests/test_trace.py``: config normalization, exact
reconciliation after quiesce over the queue, shm and tcp transports (the
forked clients' rings ride home with their final state), sampling, the
Chrome export's client -> shard lifelines and, with a read gateway, its
shard -> replica ones, ``explain_read`` naming the lagging pair,
``explain_block``, ``staleness_timeline`` rebuilding replica lag and the
monotonic-clocks-only scan (pointed at ``repro_torch/runtime``).  Each test
runs the same seeded schedule through ``repro.runtime`` and through
``repro_torch.runtime`` (``device="cpu"``); the counts that do not depend
on thread timing agree exactly, and the audits give the same answers on
the same stamps and rings.
"""
import json
import os

import numpy as np
import pytest

from repro.core import policies as ref_policies
from repro.runtime import PSRuntime as RefPSRuntime
from repro.runtime import ReadGateway as RefReadGateway
from repro.runtime import ReadResult as RefReadResult
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import trace as ref_trace
from repro_torch.core import policies
from repro_torch.runtime import (PSRuntime, ReadGateway, ReadResult,
                                 RuntimeConfig, TraceConfig, explain_read)
from repro_torch.runtime import trace as trace_mod

pytestmark = pytest.mark.filterwarnings("ignore:os.fork:RuntimeWarning")

REF = dict(PSRuntime=RefPSRuntime, RuntimeConfig=RefRuntimeConfig,
           policies=ref_policies, trace=ref_trace, ReadGateway=RefReadGateway,
           ReadResult=RefReadResult, kw={})
PORT = dict(PSRuntime=PSRuntime, RuntimeConfig=RuntimeConfig,
            policies=policies, trace=trace_mod, ReadGateway=ReadGateway,
            ReadResult=ReadResult, kw={"device": "cpu"})
PKGS = (("ref", REF), ("port", PORT))


def _x0():
    return {"a": np.zeros((8, 4)), "b": np.ones(6)}


def _fn(seed):
    def fn(w, clock, view, rng):
        r = np.random.default_rng((seed, w, clock))
        return {"a": r.integers(-2, 3, size=(8, 4)).astype(float),
                "b": r.integers(-2, 3, size=6).astype(float)}
    return fn


def _run(P, transport, n_workers=2, n_clocks=6, **kw):
    rt = P["PSRuntime"](P["RuntimeConfig"](
        n_workers, P["policies"].ssp(2), _x0(), n_shards=2,
        transport=transport, **P["kw"], **kw))
    rt.start(_fn(7), n_clocks, timeout=60.0)
    stats = rt.wait()
    return rt, stats


# ---------------------------------------------------------------------------
# config normalization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, False, True, 0.25, 1.0,
                                  {"sample": 0.5, "capacity": 1024},
                                  {"capacity": 256}])
def test_trace_config_normalization(spec):
    """Both packages normalize a spec to the same (sample, capacity)."""
    got = trace_mod.normalize_trace(spec)
    want = ref_trace.normalize_trace(spec)
    if want is None:
        assert got is None
    else:
        assert (got.sample, got.capacity) == (want.sample, want.capacity)
    assert trace_mod.normalize_trace(True) == TraceConfig()
    cfg = TraceConfig(sample=0.1)
    assert trace_mod.normalize_trace(cfg) is cfg


@pytest.mark.parametrize("bad", [0.0, 1.5, {"sample": 1.0, "capacity": 16},
                                 {"bogus": 1}, "yes"], ids=str)
def test_trace_config_refusals_match(bad):
    for _, P in PKGS:
        with pytest.raises(ValueError):
            P["trace"].normalize_trace(bad)
    # RuntimeConfig validates eagerly at construction
    with pytest.raises(ValueError):
        RuntimeConfig(2, policies.ssp(1), _x0(), trace=bad, device="cpu")


def test_event_kinds_and_names_match_the_reference():
    """Same numbering, names and argument names: an export of either
    package reads the same in Perfetto."""
    for name in dir(ref_trace):
        if name.startswith("EV_"):
            assert getattr(trace_mod, name) == getattr(ref_trace, name), name
    assert trace_mod._NAMES == ref_trace._NAMES
    assert trace_mod._ARGS == ref_trace._ARGS
    assert trace_mod._POINT_KINDS == ref_trace._POINT_KINDS
    assert (trace_mod.SLO_ANY, trace_mod.SLO_FRESH) == (ref_trace.SLO_ANY,
                                                        ref_trace.SLO_FRESH)
    for sample in (0.1, 0.5, 1.0):
        a = trace_mod.TraceHub(TraceConfig(sample=sample))
        b = ref_trace.TraceHub(ref_trace.TraceConfig(sample=sample))
        uids = range(0, 5000, 7)
        assert [a.sampled(u) for u in uids] == [b.sampled(u) for u in uids]


def test_trace_off_by_default():
    for _, P in PKGS:
        rt, _ = _run(P, "queue")
        assert rt._trace is None and not rt.trace_on
        with pytest.raises(RuntimeError, match="tracing is off"):
            rt.dump_trace(os.devnull)
        # explain_read stays usable without tracing: it is a pure function
        # of the ReadResult stamps
        with P["ReadGateway"](rt, n_replicas=1) as gw:
            res = gw.read("a", slo=None)
            info = rt.explain_read(res)
        assert info["source"].startswith(("replica", "master", "cache"))
        assert info == P["trace"].explain_read(res)


def test_no_trace_ring_is_allocated_when_trace_is_none(monkeypatch):
    """trace=None records nothing and allocates no ring: every
    instrumentation site stops at the ``rt.trace_on`` read."""
    made = []
    orig = trace_mod._Ring.__init__

    def counting(self, name, cap):
        made.append(name)
        orig(self, name, cap)

    monkeypatch.setattr(trace_mod._Ring, "__init__", counting)
    rt, _ = _run(PORT, "queue", trace=None)
    assert made == [] and rt._trace is None
    rt, _ = _run(PORT, "queue", trace=True)
    assert made, "the traced run registered no ring"


# ---------------------------------------------------------------------------
# exact reconciliation with the counter audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["queue", "shm", "tcp"])
def test_trace_reconciles_exactly_after_quiesce(transport):
    sent_by = {}
    for name, P in PKGS:
        tm = P["trace"]
        rt, stats = _run(P, transport, trace=True)
        hub = rt._trace
        assert hub.dropped() == 0
        counts = hub.counts()
        sent = int(rt._parts_sent.sum())
        applied = sum(int(s.applied_parts.sum()) for s in rt.shards)
        assert counts.get(tm.EV_SEND, 0) == sent
        assert counts.get(tm.EV_APPLY_PART, 0) == applied == sent
        for kind in (tm.EV_FLUSH, tm.EV_CLOCK, tm.EV_SHARD_BATCH,
                     tm.EV_APPLY):
            assert counts.get(kind, 0) > 0, tm._NAMES[kind]
        if transport in ("shm", "tcp"):
            assert counts.get(tm.EV_WIRE_WRITE, 0) > 0
            assert counts.get(tm.EV_WIRE_DECODE, 0) > 0
            procs = {r["proc"] for r in hub.all_rings()}
            assert procs == {"server"} | {f"client-p{p}"
                                          for p in range(rt.n_proc)}, procs
        m = rt.metrics()
        assert m.trace_enabled and m.trace_dropped == 0
        # the clock points are one per process and period in both
        assert counts.get(tm.EV_CLOCK, 0) == rt.n_proc * 6
        sent_by[name] = (sent, counts.get(tm.EV_CLOCK, 0))
    assert sent_by["port"] == sent_by["ref"]


def test_trace_sampling_subsets_lifelines():
    for _, P in PKGS:
        tm = P["trace"]
        rt, _ = _run(P, "queue", trace={"sample": 0.25})
        counts = rt._trace.counts()
        sent_all = int(rt._parts_sent.sum())
        sent_traced = counts.get(tm.EV_SEND, 0)
        assert sent_traced < sent_all
        assert counts.get(tm.EV_APPLY_PART, 0) == sent_traced
        assert counts.get(tm.EV_APPLY, 0) > 0
        # exactly the sampled uids: the same deterministic hash both sides
        send = sorted((e[3], e[4]) for e in rt._trace.events((tm.EV_SEND,)))
        land = sorted((e[3], e[4])
                      for e in rt._trace.events((tm.EV_APPLY_PART,)))
        assert send == land
        assert all(rt._trace.sampled(uid) for _, uid in send)


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["queue", "shm"])
def test_dump_trace_is_valid_chrome_json_with_lifelines(tmp_path, transport):
    rt, _ = _run(PORT, transport, trace=True)
    path = tmp_path / "trace.json"
    info = rt.dump_trace(str(path))
    assert info["path"] == str(path) and info["dropped"] == 0
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    assert isinstance(evs, list) and evs
    slices = [e for e in evs if e["ph"] == "X"]
    assert all(e["dur"] >= 1.0 and e["ts"] >= 0.0 for e in slices)
    assert info["events"] == len(slices)
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    starts = {e["id"] for e in evs if e["ph"] == "s"}
    ends = {e["id"] for e in evs if e["ph"] == "f"}
    # every client -> shard lifeline binds: each send lands exactly once
    assert starts and starts == ends
    assert not any(i >> 62 for i in starts)   # no publish lifeline yet
    assert all(e.get("bp") == "e" for e in evs if e["ph"] == "f")
    if transport == "shm":
        # the lifelines cross processes: a flow starts in a client's pid
        # and ends in the server's
        pid_of = {e["args"]["name"]: e["pid"] for e in evs
                  if e["ph"] == "M" and e["name"] == "process_name"}
        s_pids = {e["pid"] for e in evs if e["ph"] == "s"}
        f_pids = {e["pid"] for e in evs if e["ph"] == "f"}
        assert f_pids == {pid_of["server"]}
        assert s_pids == {pid_of[f"client-p{p}"] for p in range(rt.n_proc)}


@pytest.mark.parametrize("serving", ["queue", "shm"])
def test_dump_trace_lifelines_reach_the_replica(tmp_path, serving):
    """With a read gateway subscribed before the run, the export's
    lifelines span client -> shard (send/apply) and shard -> replica
    (publish/ingest), every flow start binding a flow end, in both
    packages; the port's publish and ingest points pair up one to one."""
    for name, P in PKGS:
        tm = P["trace"]
        rt = P["PSRuntime"](P["RuntimeConfig"](
            2, P["policies"].ssp(2), _x0(), n_shards=2, transport="queue",
            trace=True, **P["kw"]))
        with P["ReadGateway"](rt, n_replicas=1, transport=serving) as gw:
            rt.start(_fn(7), 6, timeout=60.0)
            rt.wait()
            gw.read("a", slo=0)
            path = tmp_path / f"{name}-{serving}.json"
            info = rt.dump_trace(str(path))
            counts = rt._trace.counts()
        assert info["path"] == str(path) and info["dropped"] == 0
        doc = json.loads(path.read_text())
        evs = doc["traceEvents"]
        slices = [e for e in evs if e["ph"] == "X"]
        assert all(e["dur"] >= 1.0 and e["ts"] >= 0.0 for e in slices)
        starts = {e["id"] for e in evs if e["ph"] == "s"}
        ends = {e["id"] for e in evs if e["ph"] == "f"}
        bound = starts & ends
        assert {i for i in bound if not (i >> 62)}, "no client->shard lifeline"
        assert {i for i in bound if i >> 62}, "no shard->replica lifeline"
        assert all(e.get("bp") == "e" for e in evs if e["ph"] == "f")
        for kind in (tm.EV_PUBLISH, tm.EV_PUBLISH_PART, tm.EV_INGEST,
                     tm.EV_INGEST_PART, tm.EV_REPLICA_VC, tm.EV_READ):
            assert counts.get(kind, 0) > 0, tm._NAMES[kind]
        if name == "port":
            assert starts == ends
            assert counts[tm.EV_PUBLISH_PART] == counts[tm.EV_INGEST_PART]


def test_chrome_export_matches_the_reference_on_the_same_rings(tmp_path):
    """The same recorded rings export to the same Chrome document."""
    rng = np.random.default_rng(3)
    rings = []
    for proc in ("server", "client-p0"):
        evs = []
        for i in range(40):
            kind = int(rng.integers(0, 13))
            evs.append((kind, int(rng.integers(1e9, 2e9)),
                        int(rng.integers(0, 5e6)), int(rng.integers(0, 4)),
                        int(rng.integers(0, 100)), int(rng.integers(0, 3))))
        rings.append({"proc": proc, "thread": f"t-{proc}", "dropped": 0,
                      "events": evs})
    docs = []
    for _, P in PKGS:
        tm = P["trace"]
        hub = tm.TraceHub(tm.TraceConfig())
        hub.adopt(rings)
        path = tmp_path / f"{len(docs)}.json"
        info = tm.dump_chrome_trace(hub, str(path))
        assert info["events"] == 80
        docs.append(json.loads(path.read_text()))
    assert docs[0] == docs[1]


# ---------------------------------------------------------------------------
# consistency audit trail
# ---------------------------------------------------------------------------


def test_explain_block_attributes_stalls():
    for _, P in PKGS:
        tm = P["trace"]
        rt, stats = _run(P, "queue", trace=True)
        info = rt.explain_block()
        assert info["n_blocks"] == len(list(
            rt._trace.events((tm.EV_BLOCK_CLOCK, tm.EV_BLOCK_VALUE))))
        assert info["clock_blocked_s"] <= stats.block_time_clock + 0.5
        if info["by_straggler"]:
            assert info["straggler"] in range(rt.n_proc)
            assert "straggler" in info["summary"]
        one = rt.explain_block(process=0)
        assert one["n_blocks"] <= info["n_blocks"]


def test_explain_block_matches_the_reference_on_the_same_rings():
    evs = [(trace_mod.EV_BLOCK_CLOCK, 10, 2_000_000, 0, 0, 1),
           (trace_mod.EV_BLOCK_CLOCK, 20, 5_000_000, 1, 1, 0),
           (trace_mod.EV_BLOCK_CLOCK, 30, 7_000_000, 0, 0, 1),
           (trace_mod.EV_BLOCK_VALUE, 40, 1_000_000, 0, 0, 3),
           (trace_mod.EV_FLUSH, 50, 9_000_000, 0, 3, 2)]
    ring = [{"proc": "server", "thread": "t", "dropped": 0, "events": evs}]
    out = []
    for _, P in PKGS:
        tm = P["trace"]
        hub = tm.TraceHub(tm.TraceConfig())
        hub.adopt(ring)
        out.append([tm.explain_block(hub), tm.explain_block(hub, process=0),
                    tm.explain_block(hub, worker=1)])
    assert out[0] == out[1]
    assert out[1][0]["straggler"] == 1


def test_staleness_timeline_waits_for_the_serving_tier():
    """Without a replica there is no vc adoption to measure: the timeline
    of every shard is empty, in both packages."""
    for _, P in PKGS:
        rt, _ = _run(P, "queue", trace=True)
        for sid in range(rt.n_slots):
            tl = rt.staleness_timeline(sid)
            assert tl == {"shard": sid, "bound": 2, "max_staleness": 0,
                          "points": []}


def test_staleness_timeline_reconstructs_replica_lag():
    for _, P in PKGS:
        rt = P["PSRuntime"](P["RuntimeConfig"](
            2, P["policies"].ssp(2), _x0(), n_shards=2, transport="queue",
            trace=True, **P["kw"]))
        with P["ReadGateway"](rt, n_replicas=1) as gw:
            rt.start(_fn(7), 6, timeout=60.0)
            rt.wait()
            gw.read("a", slo=0)
            tl = rt.staleness_timeline(0)
        assert tl["shard"] == 0
        assert tl["bound"] == rt.policy.staleness  # ssp: clock-bounded
        assert tl["points"], "no replica_vc adoptions recorded for shard 0"
        for t_s, rid, lag in tl["points"]:
            assert t_s >= 0.0 and rid >= 0 and lag >= 0
        assert tl["max_staleness"] == max(p[2] for p in tl["points"])
        ts = [p[0] for p in tl["points"]]
        assert ts == sorted(ts)


def test_staleness_timeline_matches_the_reference_on_the_same_rings():
    evs = [(trace_mod.EV_REPLICA_VC, 30, 0, 0, 1, 2),
           (trace_mod.EV_REPLICA_VC, 10, 0, 1, 0, 0),
           (trace_mod.EV_REPLICA_VC, 20, 0, 0, 0, 3),
           (trace_mod.EV_APPLY, 5, 9, 0, 1, 2)]
    ring = [{"proc": "server", "thread": "t", "dropped": 0, "events": evs}]
    out = []
    for _, P in PKGS:
        tm = P["trace"]
        hub = tm.TraceHub(tm.TraceConfig())
        hub.adopt(ring)
        out.append([tm.staleness_timeline(hub, s, bound=b)
                    for s in (0, 1) for b in (None, 3)])
    assert out[0] == out[1]
    assert out[1][0]["points"] == [(0.0, 1, 0), (1e-8, 0, 3)]


# ---------------------------------------------------------------------------
# read audit: explain_read
# ---------------------------------------------------------------------------


def test_explain_read_names_the_lagging_pair():
    """A deliberately wedged replica forces an escalation; explain_read
    names the exact (shard slot, process) vector-clock cell that trailed
    the master frontier furthest."""
    for _, P in PKGS:
        tm = P["trace"]
        rt = P["PSRuntime"](P["RuntimeConfig"](
            2, P["policies"].ssp(2), _x0(), n_shards=2, transport="queue",
            trace=True, **P["kw"]))
        gw = P["ReadGateway"](rt, n_replicas=1, transport="shm")
        rset = gw.replicas
        rset.wedge(0)                      # stop draining before any delta
        rt.start(_fn(3), 6, timeout=60.0)
        rt.wait()
        try:
            res = gw.read("a", slo=0, timeout=0.4)
            assert res.escalated and res.source == "master"
            rep = rset.replicas[0]
            gap = rset.master_vc() - rep.vc
            s, p = np.unravel_index(int(gap.argmax()), gap.shape)
            expect = (int(s), int(p))
            info = rt.explain_read(res)
            assert info["escalated"] and info["lagging"] == expect
            assert info["vc_gap"] == max(int(gap.max()), 0) > 0
            assert f"shard {expect[0]}" in info["summary"]
            assert f"process {expect[1]}" in info["summary"]
            counts = rt._trace.counts()
            assert counts.get(tm.EV_ESCALATE, 0) >= 1
            assert counts.get(tm.EV_READ, 0) >= 1
            assert counts.get(tm.EV_PARK, 0) >= 1
            assert tm.explain_read(res) == info
        finally:
            rset.wedge(0, wedged=False)
            gw.close()


@pytest.mark.parametrize("source,escalated,lag", [
    ("master", True, (1, 0, 4)), ("master", False, (-1, -1, 0)),
    ("cache", False, (-1, -1, 0)), ("replica:1", False, (-1, -1, 0))])
def test_explain_read_matches_the_reference_on_the_same_stamps(
        source, escalated, lag):
    out = []
    for _, P in PKGS:
        res = P["ReadResult"](np.zeros(3), "a", source, 0 if source ==
                              "master" else 2, 3, escalated, 0.25, *lag)
        out.append(P["trace"].explain_read(res))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# timestamp discipline
# ---------------------------------------------------------------------------


def test_runtime_package_uses_monotonic_clocks_only():
    """Events from forked children must land on the parent's timeline:
    no module of the port's runtime may call time.time()."""
    import repro_torch.runtime as pkg
    root = os.path.dirname(pkg.__file__)
    offenders = []
    n_files = 0
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            n_files += 1
            with open(os.path.join(dirpath, name)) as f:
                if "time.time(" in f.read():
                    offenders.append(name)
    assert n_files >= 10
    assert not offenders, f"wall-clock use on runtime paths: {offenders}"
