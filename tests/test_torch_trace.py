"""The port's tracing tier against the JAX package's.

Mirrors ``tests/test_trace.py`` where no gateway or replica is involved:
config normalization, exact reconciliation after quiesce over the queue,
shm and tcp transports (the forked clients' rings ride home with their
final state), sampling, the Chrome export's client -> shard lifelines,
``explain_block`` and the monotonic-clocks-only scan (pointed at
``repro_torch/runtime``).  Each test runs the same seeded schedule through
``repro.runtime`` and through ``repro_torch.runtime`` (``device="cpu"``);
the counts that do not depend on thread timing agree exactly.  The
read-side audits (``explain_read``, ``staleness_timeline``) need the
serving tier and raise in the port, naming ROADMAP Queue 1 item 5.3.
"""
import json
import os

import numpy as np
import pytest

from repro.core import policies as ref_policies
from repro.runtime import PSRuntime as RefPSRuntime
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import trace as ref_trace
from repro_torch.core import policies
from repro_torch.runtime import (PSRuntime, RuntimeConfig, TraceConfig,
                                 explain_read)
from repro_torch.runtime import trace as trace_mod

pytestmark = pytest.mark.filterwarnings("ignore:os.fork:RuntimeWarning")

REF = dict(PSRuntime=RefPSRuntime, RuntimeConfig=RefRuntimeConfig,
           policies=ref_policies, trace=ref_trace, kw={})
PORT = dict(PSRuntime=PSRuntime, RuntimeConfig=RuntimeConfig,
            policies=policies, trace=trace_mod, kw={"device": "cpu"})
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
    # the read audits need the serving tier: the port says which item
    rt, _ = _run(PORT, "queue")
    with pytest.raises(NotImplementedError, match="item 5.3"):
        rt.explain_read(object())
    with pytest.raises(NotImplementedError, match="item 5.3"):
        explain_read(object())


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
    rt, _ = _run(PORT, "queue", trace=True)
    with pytest.raises(NotImplementedError, match="item 5.3"):
        rt.staleness_timeline(0)


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
