"""The port's runtime on its wire transports against the JAX package.

Forked client processes over shared-memory rings (the raw zero-copy wire
and its pickle-5 frames) and over loopback tcp: with integer deltas that
depend only on (worker, clock), the quiesced master and every process cache
each child ships back must equal the JAX package's ``AsyncPS`` simulator
bitwise, for every policy.  These run with ``device="cpu"``; the
``cuda``-marked cases initialize CUDA in this process first, keep the
master blocks on the card, and show that the forked clients never touch
the device: the run completes, ``ps_apply`` launches in the parent and
``topk_mag`` does not (the children order their flushes in host numpy).

The file stands apart from ``test_torch_runtime.py`` so that the test
runner's per-file distribution spreads the forking tests.
"""
import gc
import os
import threading

import numpy as np
import pytest
import torch

from repro.core import AsyncPS as RefAsyncPS
from repro.core import NetworkModel as RefNetworkModel
from repro.core import policies as ref_policies
from repro_torch.core import policies
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.kernels.topk_mag import ops as topk_ops
from repro_torch.runtime import PSRuntime, RuntimeConfig
from repro_torch.runtime import messages as M
from repro_torch.runtime import runtime as runtime_mod
from repro_torch.runtime import transport as T

# the JAX package warns at every fork that JAX is multithreaded; the forked
# clients never touch JAX (nor torch), so the warning does not apply here
pytestmark = pytest.mark.filterwarnings("ignore:os.fork:RuntimeWarning")


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


# (name, port policy, reference policy): the reference suite's 7 kinds
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    # CUDA is live in this process before the runtime forks its clients
    torch.zeros(1, device="cuda")
    return "cuda"


def _wire_equals_reference_simulator(name, pol, ref_pol, device, **kw):
    seed = 0
    sim = RefAsyncPS(4, ref_pol, _x0(), threads_per_process=2, seed=seed,
                     network=RefNetworkModel(seed=seed))
    st_sim = sim.run(_sched_fn(seed), 12)
    rt = PSRuntime(RuntimeConfig(4, pol, _x0(), n_shards=2,
                                 threads_per_process=2, seed=seed,
                                 device=device, **kw))
    st = rt.run(_sched_fn(seed), 12, timeout=90)
    assert st_sim.violations == [] and st.violations == [], st.violations
    assert st.n_updates == st_sim.n_updates
    for k, ref in sim.views[0].items():
        np.testing.assert_array_equal(rt.master_value(k), ref,
                                      err_msg=f"{name} {kw} master[{k}]")
        np.testing.assert_array_equal(rt.expected_value(k), ref)
        for p in range(rt.n_proc):
            np.testing.assert_array_equal(
                rt.view(p)[k], ref, err_msg=f"{name} {kw} proc{p}[{k}]")
    return rt


@pytest.mark.parametrize("name,pol,ref_pol", _POLICIES, ids=_IDS)
@pytest.mark.parametrize("transport", ["proc", "tcp"])
def test_runtime_final_state_equals_reference_simulator_multiprocess(
        name, pol, ref_pol, transport):
    _wire_equals_reference_simulator(name, pol, ref_pol, "cpu",
                                     transport=transport)


@pytest.mark.parametrize("name,pol,ref_pol", _POLICIES, ids=_IDS)
@pytest.mark.parametrize("zero_copy", [True, False], ids=["zc", "pickle"])
def test_multiprocess_shm_zero_copy_equals_reference_simulator(
        name, pol, ref_pol, zero_copy):
    _wire_equals_reference_simulator(name, pol, ref_pol, "cpu",
                                     transport="shm", zero_copy=zero_copy)


@pytest.mark.cuda
@pytest.mark.parametrize("name,pol,ref_pol", _POLICIES, ids=_IDS)
@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_wire_runtime_on_the_card_equals_reference_simulator(
        name, pol, ref_pol, transport, cuda):
    """Masters in f64 on the card, every apply through ``ps_apply`` in the
    parent; the forked clients never touch CUDA, so ``topk_mag`` is not
    launched and a child that did would fail the run."""
    apply_ops.launches = topk_ops.launches = 0
    rt = _wire_equals_reference_simulator(name, pol, ref_pol, cuda,
                                          transport=transport)
    assert all(t.is_cuda and t.dtype == torch.float64
               for s in rt.shards for t in s.dense.values())
    assert apply_ops.launches > 0
    assert topk_ops.launches == 0


# ---------------------------------------------------------------------------
# sizing, the zero-copy discipline, failures
# ---------------------------------------------------------------------------


def test_proc_runtime_handles_rows_larger_than_default_ring():
    """A key bigger than the 1 MiB default ring: capacity is sized from the
    largest part, so a whole-key Inc round-trips through the shm backend."""
    big = (2048, 128)                           # 2 MiB of float64 rows

    def fn(w, clock, view, rng):
        return {"w": np.ones(big)}

    rt = PSRuntime(RuntimeConfig(2, policies.ssp(1), {"w": np.zeros(big)},
                                 n_shards=2, threads_per_process=1, seed=0,
                                 transport="shm", device="cpu"))
    st = rt.run(fn, 3, timeout=90)
    assert st.violations == []
    assert float(rt.master_value("w").sum()) == 2 * 3 * big[0] * big[1]


def test_use_after_advance_guard_through_shard_apply():
    """View-backed messages through a real ServerShard batch: after
    _handle_batch returns, every frame is released (head advanced) and
    nothing the shard retained aliases ring memory."""
    x0 = {"k": np.zeros((8, 2)), "k2": np.zeros((8, 2))}
    rt = PSRuntime(RuntimeConfig(2, policies.vap(1e6), x0, n_shards=1,
                                 device="cpu"))
    shard = rt.shards[0]
    cap = 1 << 16
    ring = T.ShmRing.create(cap)
    codec = T.RowCodec(["k", "k2"])
    bell = os.pipe()
    reader = T.RingViewReader(ring, codec, bell[0], threading.Event())
    chan = T.WireChannel("zc", T.ring_parts_writer(ring), max_frame=cap // 4,
                         codec=codec,
                         on_flush=lambda: T.ShmEdge.ring_bell(bell[1]))
    try:
        rows = np.arange(4, dtype=np.int64)
        batch = [M.UpdateMsg(i, 0, 0, 0, "k", rows, np.ones((4, 2)))
                 for i in range(4)]
        batch += [M.UpdateMsg(4 + i, 0, 0, 0, "k2", rows, np.ones((4, 2)))
                  for i in range(2)]
        chan.send_many(batch)
        got = []
        while len(got) < len(batch):
            got.extend(reader._decode_ready())
        assert all(getattr(m, "_frame", None) is not None for m in got)
        assert shard._handle_batch(got) is False     # no shutdown sentinel
        assert rt.stats.violations == []
        assert reader.pinned_frames() == 0
        assert ring._head() == ring._tail()
        mem = np.frombuffer(ring.buf, dtype=np.uint8)
        retained = [m for m, _ in shard.pending.values()]
        retained += [m for q in shard.queued.values() for m in q]
        assert retained, "expected the VAP path to retain deliveries"
        for m in retained:
            assert not np.shares_memory(m.rows, mem)
            assert not np.shares_memory(m.delta, mem)
            assert getattr(m, "_frame", None) is None
        # the master took the six parts exactly once
        np.testing.assert_array_equal(rt.master_value("k")[:4], 4.0)
        np.testing.assert_array_equal(rt.master_value("k2")[:4], 2.0)
        got.clear()
        del mem
    finally:
        gc.collect()
        ring.close()
        ring.unlink()
        for fd in bell:
            os.close(fd)


@pytest.mark.parametrize("seed", range(6))
def test_child_send_order_equals_topk_plain_version(seed):
    """The forked client's numpy order is the ``topk_mag`` contract: equal
    to the kernel's plain version on a flush's magnitudes, ties in index
    order and NaN last included."""
    rng = np.random.default_rng(seed)
    cases = [np.array([3.0, 5.0]), np.array([5.0, 5.0]),
             np.array([np.nan, 1.0]), np.array([0.0, -0.0]),
             np.array([np.inf, np.nan, np.inf, 0.0])]
    for n in (2, 3, 17, 64, 1000):
        m = np.abs(rng.normal(size=n)).round(1)          # ties
        m[rng.random(n) < 0.1] = np.nan
        m[rng.random(n) < 0.05] = np.inf
        cases.append(m)
    for mags in cases:
        child = runtime_mod._ClientHost._magnitude_order(None, mags)
        plain = topk_ops.magnitude_order(torch.from_numpy(mags)).numpy()
        np.testing.assert_array_equal(child, plain, err_msg=str(mags))


@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_failed_child_fails_the_run(transport):
    """A worker that raises in a forked client ships its error, and the
    parent's wait() raises it: nothing on the wire path swallows it.  (No
    clock bound here, so the peer is not left waiting for the dead worker's
    clocks until the deadline.)"""
    def fn(w, clock, view, rng):
        if w == 1 and clock == 2:
            raise ValueError("boom in worker 1")
        return {"a": np.ones((8, 4))}

    rt = PSRuntime(RuntimeConfig(2, policies.vap(1e9), {"a": np.zeros((8, 4))},
                                 n_shards=2, transport=transport,
                                 device="cpu"))
    with pytest.raises(RuntimeError, match="boom in worker 1"):
        rt.run(fn, 5, timeout=30)


def test_live_master_reads_multiprocess():
    """Reads against the live master shards while forked clients stream
    updates observe monotone progress; after wait() reads come from the
    shipped caches."""
    def fn(w, clock, view, rng):
        return {"a": np.ones((8, 4))}

    rt = PSRuntime(RuntimeConfig(2, policies.ssp(3), {"a": np.zeros((8, 4))},
                                 n_shards=2, transport="proc", device="cpu"))
    rt.start(fn, 50, timeout=90)
    seen = []
    while rt.running and len(seen) < 2000:
        v = rt.read("a")
        assert v.shape == (8, 4)
        seen.append(float(v.sum()))
    assert rt.wait().violations == []
    assert seen == sorted(seen)
    assert float(rt.master_value("a").sum()) == 2 * 50 * 32
    assert float(rt.read("a", process=1).sum()) == 2 * 50 * 32


@pytest.mark.parametrize("name,pol", [("ssp3", policies.ssp(3)),
                                      ("cvap", policies.cvap(3, 1.5)),
                                      ("elastic", policies.elastic(5.0))],
                         ids=["ssp3", "cvap", "elastic"])
def test_stress_invariants_hold_multiprocess(name, pol):
    """Free multi-process interleaving, 2 forked clients x 2 threads: each
    child checks the clock bound at every period start and the value/norm
    bound after every Inc; the parent merges and finds no violation."""
    def fn(w, clock, view, rng):
        return {"a": rng.normal(0.0, 0.6, size=(8, 4)),
                "b": rng.normal(0.0, 0.6, size=5)}

    x0 = {"a": np.zeros((8, 4)), "b": np.zeros(5)}
    rt = PSRuntime(RuntimeConfig(4, pol, x0, n_shards=2,
                                 threads_per_process=2, seed=11,
                                 transport="proc", device="cpu"))
    st = rt.run(fn, 80, timeout=110)
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
