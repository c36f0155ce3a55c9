"""The rest of the port's ``core/`` and ``apps/`` against the JAX package's.

``theory``, ``tables`` and ``client`` are host numpy in both packages and
are held bitwise on seeded inputs (``tables`` by one seeded sequence of
operations run on both); the port's mirrors of
``tests/test_tables.py`` and the table/thread-cache tests of
``tests/test_substrate.py`` run here too.  MF and logistic regression are
held bitwise against the reference on the simulator; on the runtime
(``device="cpu"``) a one-worker run is deterministic and bitwise equal to
the reference's simulator, and a four-worker run is checked for zero
violations and convergence, since its interleaving is free.
"""
import numpy as np
import pytest
import torch

from repro.apps import logreg as ref_logreg
from repro.apps import mf as ref_mf
from repro.core import AsyncPS as RefAsyncPS
from repro.core import NetworkModel as RefNetworkModel
from repro.core import client as ref_client
from repro.core import policies as ref_policies
from repro.core import tables as ref_tables
from repro.core import theory as ref_theory
from repro_torch.apps import logreg, mf
from repro_torch.core import tables as port_tables
from repro_torch.core import (AsyncPS, NetworkModel, Row, SparseRow, Table,
                              TableGroup, ThreadCache, policies, run_app,
                              theory)
from repro_torch.runtime import PSRuntime, RuntimeConfig

# (name, port policy, reference policy)
_POLICIES = [
    ("bsp", policies.bsp(), ref_policies.bsp()),
    ("ssp2", policies.ssp(2), ref_policies.ssp(2)),
    ("essp2", policies.essp(2), ref_policies.essp(2)),
    ("vap", policies.vap(0.05), ref_policies.vap(0.05)),
    ("elastic", policies.elastic(0.5), ref_policies.elastic(0.5)),
]
_IDS = lambda v: v if isinstance(v, str) else ""  # noqa: E731


# ---------------------------------------------------------------------------
# theory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("F,L,v,P,T", [(4.0, 4.0, 0.05, 4, 240),
                                       (2.0, 3.0, 0.1, 8, 1000),
                                       (1.0, 0.5, 1e-40, 1, 7)])
def test_theory_formulas_match_reference(F, L, v, P, T):
    for name in ("sigma_star", "lemma1_bound"):
        args = (F, L, v, P) if name == "sigma_star" else (v, P)
        assert getattr(theory, name)(*args) == getattr(ref_theory, name)(*args)
    assert theory.step_size(5, F, L, v, P) == ref_theory.step_size(5, F, L,
                                                                  v, P)
    assert theory.theorem1_regret_bound(T, F, L, v, P) == \
        ref_theory.theorem1_regret_bound(T, F, L, v, P)
    np.testing.assert_array_equal(
        theory.theorem1_regret_curve(T, F, L, v, P),
        ref_theory.theorem1_regret_curve(T, F, L, v, P))
    assert theory.weak_vap_divergence_bound(0.3, v, P) == \
        ref_theory.weak_vap_divergence_bound(0.3, v, P)
    assert theory.strong_vap_divergence_bound(0.3, v) == \
        ref_theory.strong_vap_divergence_bound(0.3, v)
    regret = np.cumsum(np.random.default_rng(T).random(T))
    assert theory.regret_is_sublinear(regret) == \
        ref_theory.regret_is_sublinear(regret)


def test_strong_vap_example_runs_as_the_reference():
    """The example the JAX package's ``test_simulator_invariants_random``
    can draw: P 6, vap(0.625, strong=True), delay 0.75, seed 4.  Both
    packages' simulators run it to the same bits and hold the value and
    strong gates (unsynchronized and half-synchronized mass within
    max(u, v)), and on both its divergence passes the strong-VAP bound
    2 max(u, v) that both packages state.  Whether the bound or the gate
    is at fault waits for the paper's section 2.2 (ROADMAP Queue 3); until
    then the port keeps the reference's bound and this pins the example."""
    P, vthr, delay, seed = 6, 0.625, 0.75, 4

    def fn(w, clock, view, r):
        x = view.get("x")
        return {"x": -0.1 * (x - w) + r.normal(0, 0.1, 2)}

    runs = []
    for ps_cls, net_cls, pols in ((AsyncPS, NetworkModel, policies),
                                  (RefAsyncPS, RefNetworkModel,
                                   ref_policies)):
        ps = ps_cls(P, pols.vap(vthr, strong=True), {"x": np.zeros(2)},
                    network=net_cls(base_delay=delay, jitter=delay / 2,
                                    seed=seed), seed=seed)
        runs.append((ps, ps.run(fn, 8, divergence_every=1.0)))
    (ps, st), (ref_ps, ref_st) = runs
    for name in ("max_divergence", "max_update_mag", "max_unsynced_mag",
                 "max_halfsync_mag", "n_updates", "n_messages", "sim_time"):
        assert getattr(st, name) == getattr(ref_st, name), name
    np.testing.assert_array_equal(ps.views[0]["x"], ref_ps.views[0]["x"])
    assert st.violations == [] and ps.n_proc == P
    u = st.max_update_mag
    assert st.max_unsynced_mag <= max(u, vthr) + 1e-9
    assert st.max_halfsync_mag <= max(u, vthr) + 1e-9
    bound = theory.strong_vap_divergence_bound(u, vthr)
    assert bound == ref_theory.strong_vap_divergence_bound(u, vthr)
    assert st.max_divergence > bound + 1e-9


def test_theorem1_regret_bound_holds_on_the_ports_simulator():
    """The reference's test_theorem1_regret_bound, on the port's simulator:
    SGD under VAP stays under the paper's bound and converges."""
    P, DIM, clocks = 4, 4, 60
    F, L, v_thr = 4.0, 4.0, 0.05
    sigma = theory.sigma_star(F, L, v_thr, P)
    rng = np.random.default_rng(0)
    A = rng.normal(0, 1, (P * (clocks + 1), DIM)) / np.sqrt(DIM)
    xstar = rng.normal(0, 1, DIM)
    y = A @ xstar
    regrets, t_counter = [], [0]

    def fn(w, clock, view, rng):
        x = view.get("x")
        t = t_counter[0] = t_counter[0] + 1
        i = (clock * P + w) % len(y)
        r = A[i] @ x - y[i]
        g = np.clip(A[i] * r, -L / 2, L / 2)
        regrets.append(0.5 * r ** 2 - 0.5 * (A[i] @ xstar - y[i]) ** 2)
        return {"x": -sigma / np.sqrt(t) * g}

    ps = AsyncPS(P, policies.vap(v_thr), {"x": np.zeros(DIM)},
                 network=NetworkModel(base_delay=0.3, jitter=0.2, seed=1),
                 seed=1)
    assert ps.run(fn, clocks).violations == []
    R = np.cumsum(regrets)
    assert np.all(R <= theory.theorem1_regret_curve(len(R), F, L, v_thr, P)
                  + 1e-6)
    assert theory.regret_is_sublinear(R)


# ---------------------------------------------------------------------------
# tables (mirrors of tests/test_tables.py and test_substrate.py)
# ---------------------------------------------------------------------------


def test_sparse_row_inc_elides_zeros():
    r = SparseRow()
    r.inc(2.5, col=3)
    r.inc(-2.5, col=3)
    assert r.get(3) == 0.0 and r.cols == {}
    r.inc({0: 1.0, 1: -2.0, 5: 4.0})
    r.inc({0: -1.0, 1: 2.0, 5: 1.0})
    assert r.cols == {5: 5.0} and r.get() == {5: 5.0}
    r.inc(0.0, col=7)
    assert 7 not in r.cols


@pytest.mark.parametrize("n_servers", [1, 2, 3, 5])
def test_server_partition_covers_every_row_exactly_once(n_servers):
    t = Table("wt", n_cols=4)
    row_ids = [0, 1, 2, 7, 8, 13, 29, 100]
    for rid in row_ids:
        t.inc(rid, np.full(4, float(rid)))
    parts = [t.server_partition(n_servers, s) for s in range(n_servers)]
    assert sorted(rid for p in parts for rid in p) == sorted(row_ids)
    for s, p in enumerate(parts):
        assert all(rid % n_servers == s for rid in p)
        for rid, row in p.items():
            assert row is t.row(rid)


def test_server_partition_matches_runtime_sharding():
    """The port's runtime assigns shard rows by the same rule as
    Table.server_partition."""
    rt = PSRuntime(RuntimeConfig(2, policies.bsp(), {"a": np.zeros((7, 3))},
                                 n_shards=3, device="cpu"))
    t = Table("a", n_cols=3)
    for r in range(7):
        t.inc(r, np.zeros(3))
    for s in range(3):
        assert sorted(rt.partition.rows_of("a", s).tolist()) == sorted(
            t.server_partition(3, s))


def test_table_group_and_snapshots():
    g = TableGroup()
    g.create("wt", n_cols=4, policy="vap")
    with pytest.raises(KeyError, match="already exists"):
        g.create("wt", n_cols=8)
    g.create("tc", n_cols=3, sparse=True)
    assert g.policies == {"wt": "vap"} and g["wt"].n_cols == 4
    assert {t.table_id for t in g} == {"wt", "tc"} and "tc" in g
    assert isinstance(g["tc"].row(0), SparseRow)
    assert isinstance(g["wt"].row(0), Row)
    dense, sparse = Table("d", n_cols=3), g["tc"]
    ref = np.zeros((4, 3))
    for rid, col, v in [(0, 1, 2.0), (2, 0, -1.5), (3, 2, 4.0)]:
        dense.row(rid).inc(v, col=col)
        sparse.inc(rid, v, col=col)
        ref[rid, col] = v
    np.testing.assert_array_equal(dense.dense_snapshot(4), ref)
    np.testing.assert_array_equal(sparse.dense_snapshot(4), ref)
    t = g["wt"]
    t.inc(7, np.ones(4))
    t.inc(7, 2.0, col=1)
    np.testing.assert_array_equal(t.get(7), [1, 3, 1, 1])


def _drive_tables(tables_mod, seed, n_ops=300):
    """A seeded sequence of creates, incs and gets on one ``tables`` module.

    Returns the group and every value a ``get`` returned, in order.  Sparse
    increments are small integers, so columns cancel to zero and are
    elided; dense ones mix whole-row float deltas with single columns.
    """
    rng = np.random.default_rng(seed)
    g = tables_mod.TableGroup()
    specs = {"wt": dict(n_cols=5, policy="vap"),
             "tc": dict(n_cols=6, sparse=True),
             "lo": dict(n_cols=3, dtype=np.float32, policy="ssp")}
    for tid, kw in specs.items():
        g.create(tid, **kw)
    with pytest.raises(KeyError, match="already exists"):
        g.create("tc", n_cols=2)
    reads = []
    for _ in range(n_ops):
        tid = ("wt", "tc", "lo")[rng.integers(3)]
        t, rid = g[tid], int(rng.integers(0, 40))
        op = rng.integers(4)
        if op == 0:
            reads.append(t.get(rid))
        elif op == 1:
            reads.append(t.get(rid, col=int(rng.integers(t.n_cols))))
        elif tid == "tc":
            if op == 2:
                cols = rng.choice(t.n_cols, size=rng.integers(1, 4),
                                  replace=False)
                t.inc(rid, {int(c): float(rng.integers(-2, 3))
                            for c in cols})
            else:
                t.inc(rid, float(rng.integers(-2, 3)),
                      col=int(rng.integers(t.n_cols)))
        elif op == 2:
            t.inc(rid, rng.normal(size=t.n_cols).astype(t.dtype))
        else:
            t.inc(rid, float(rng.normal()), col=int(rng.integers(t.n_cols)))
    return g, reads


def _row_value(row):
    return dict(row.cols) if hasattr(row, "cols") else row.data


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tables_match_reference_on_a_seeded_sequence(seed):
    """The same seeded creates, incs and gets on both packages' tables give
    the same reads, rows (in insertion order), server partitions, dense
    snapshots and policy map, bitwise."""
    mine, my_reads = _drive_tables(port_tables, seed)
    ref, ref_reads = _drive_tables(ref_tables, seed)
    assert len(my_reads) == len(ref_reads)
    for a, b in zip(my_reads, ref_reads):
        if isinstance(b, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype
    assert mine.policies == ref.policies
    assert [t.table_id for t in mine] == [t.table_id for t in ref]
    for t, rt in zip(mine, ref):
        assert (t.n_cols, t.dtype, t.sparse) == (rt.n_cols, rt.dtype,
                                                 rt.sparse)
        rows, ref_rows = list(t.rows()), list(rt.rows())
        assert [rid for rid, _ in rows] == [rid for rid, _ in ref_rows]
        for (_, r), (_, rr) in zip(rows, ref_rows):
            if t.sparse:
                assert list(r.cols.items()) == list(rr.cols.items())
            else:
                np.testing.assert_array_equal(r.data, rr.data)
                assert r.data.dtype == rr.data.dtype
        for n_servers in (1, 2, 3, 5):
            for s in range(n_servers):
                part = t.server_partition(n_servers, s)
                ref_part = rt.server_partition(n_servers, s)
                assert list(part) == list(ref_part)
                for rid in part:
                    np.testing.assert_equal(_row_value(part[rid]),
                                            _row_value(ref_part[rid]))
        for n_rows in (10, 40, 55):
            snap, ref_snap = t.dense_snapshot(n_rows), rt.dense_snapshot(
                n_rows)
            assert snap.dtype == ref_snap.dtype
            np.testing.assert_array_equal(snap, ref_snap)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


def test_thread_cache_read_my_writes():
    class FakeView:
        def get(self, key):
            return np.zeros(3)

    c = ThreadCache(FakeView())
    c.inc("x", np.array([1.0, 0, 0]))
    np.testing.assert_array_equal(c.get("x"), [1, 0, 0])
    c.inc("x", np.array([0, 2.0, 0]))
    np.testing.assert_array_equal(c.get("x"), [1, 2, 0])
    assert (c.hits, c.misses) == (1, 1)
    np.testing.assert_array_equal(c.flush()["x"], [1, 2, 0])
    assert c.flush() == {}


def test_run_app_matches_reference():
    """An imperative Get/Inc/Clock app through ``run_app`` on both
    simulators: the same views and RunStats."""
    def app(w, clock, cache, rng):
        x = cache.get("x")
        cache.inc("x", -0.1 * (x - (w + 1.0)) + rng.normal(0, 0.01, 3))
        cache.inc("y", np.full(2, float(clock)))

    x0 = {"x": np.zeros(3), "y": np.zeros(2)}
    mine = AsyncPS(4, policies.ssp(1), x0,
                   network=NetworkModel(base_delay=0.3, seed=5), seed=5)
    ref = RefAsyncPS(4, ref_policies.ssp(1), x0,
                     network=RefNetworkModel(base_delay=0.3, seed=5), seed=5)
    st = run_app(mine, app, 8)
    ref_st = ref_client.run_app(ref, app, 8)
    assert st.violations == ref_st.violations == []
    assert st.sim_time == ref_st.sim_time
    for k in x0:
        np.testing.assert_array_equal(mine.master_value(k),
                                      ref.master_value(k))


# ---------------------------------------------------------------------------
# MF and logistic regression
# ---------------------------------------------------------------------------


def _mf_args():
    ratings = mf.synthetic_ratings(30, 20, 3, density=0.4, seed=1)
    np.testing.assert_array_equal(
        ratings, ref_mf.synthetic_ratings(30, 20, 3, density=0.4, seed=1))
    return ratings, 30, 20, 3


def _logreg_args():
    X, y = logreg.synthetic_classification(200, 8, seed=2)
    rX, ry = ref_logreg.synthetic_classification(200, 8, seed=2)
    np.testing.assert_array_equal(X, rX)
    np.testing.assert_array_equal(y, ry)
    return X, y


@pytest.mark.parametrize("name,pol,ref_pol", _POLICIES, ids=_IDS)
def test_mf_simulator_matches_reference(name, pol, ref_pol):
    args = _mf_args()
    net = dict(base_delay=0.5, jitter=0.3, seed=3)
    got, st = mf.run_mf(*args, pol, 4, 8, seed=3, backend="sim",
                        network=NetworkModel(**net), collect_stats=True)
    want, ref_st = ref_mf.run_mf(*args, ref_pol, 4, 8, seed=3,
                                 backend="sim",
                                 network=RefNetworkModel(**net),
                                 collect_stats=True)
    np.testing.assert_array_equal(got, want)
    assert st.violations == ref_st.violations == []
    assert st.sim_time == ref_st.sim_time
    assert got[-1] < got[0]


@pytest.mark.parametrize("name,pol,ref_pol", _POLICIES, ids=_IDS)
def test_logreg_simulator_matches_reference(name, pol, ref_pol):
    X, y = _logreg_args()
    net = dict(base_delay=0.5, jitter=0.3, seed=4)
    got, st = logreg.run_logreg(X, y, pol, 4, 8, seed=4, backend="sim",
                                network=NetworkModel(**net),
                                collect_stats=True)
    want, ref_st = ref_logreg.run_logreg(X, y, ref_pol, 4, 8, seed=4,
                                         backend="sim",
                                         network=RefNetworkModel(**net),
                                         collect_stats=True)
    np.testing.assert_array_equal(got, want)
    assert st.violations == ref_st.violations == []
    assert got[-1] < got[0]


def test_mf_and_logreg_runtime_one_worker_match_reference():
    """One worker has one interleaving, so the port's runtime (shard apply
    through the plain ps_apply) is bitwise the reference's simulator."""
    args = _mf_args()
    got = mf.run_mf(*args, policies.bsp(), 1, 6, seed=0, device="cpu")
    want = ref_mf.run_mf(*args, ref_policies.bsp(), 1, 6, seed=0,
                         backend="sim")
    np.testing.assert_array_equal(got, want)
    X, y = _logreg_args()
    got = logreg.run_logreg(X, y, policies.bsp(), 1, 6, device="cpu")
    want = ref_logreg.run_logreg(X, y, ref_policies.bsp(), 1, 6,
                                 backend="sim")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,pol,ref_pol", _POLICIES, ids=_IDS)
def test_mf_and_logreg_runtime_converge(name, pol, ref_pol):
    args = _mf_args()
    losses, st = mf.run_mf(*args, pol, 4, 10, seed=0, device="cpu",
                           threads_per_process=2, collect_stats=True)
    assert st.violations == [] and losses[-1] < losses[0]
    assert losses[0] == ref_mf.run_mf(*args, ref_pol, 4, 1, seed=0,
                                      backend="sim")[0]    # view = x0
    X, y = _logreg_args()
    losses, st = logreg.run_logreg(X, y, pol, 4, 10, device="cpu",
                                   collect_stats=True)
    assert st.violations == [] and losses[-1] < losses[0]


@pytest.mark.parametrize("run", ["mf", "logreg"])
def test_apps_default_to_the_card_and_sim_refuses_it(run):
    if run == "mf":
        args = _mf_args()
        fn = lambda **kw: mf.run_mf(*args, policies.bsp(), 2, 1,  # noqa: E731
                                    **kw)
    else:
        X, y = _logreg_args()
        fn = lambda **kw: logreg.run_logreg(X, y, policies.bsp(),  # noqa: E731
                                            2, 1, **kw)
    with pytest.raises(ValueError, match="runs on the host"):
        fn(backend="sim", device="cuda")
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
