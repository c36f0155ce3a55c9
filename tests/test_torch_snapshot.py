"""The port's snapshots and restore against the JAX package's.

Every test of ``tests/test_snapshot.py`` is mirrored: the same schedule
(integer deltas, a pure function of (worker, clock), made from a numpy
seed) runs through ``repro.runtime`` and through ``repro_torch.runtime``
with ``device="cpu"``, and the two agree bitwise (tolerance: none).  The
resume-equals-uninterrupted test holds the resumed port runtime to the JAX
package's simulator, the executable spec.

A snapshot is an ``.npz`` with a JSON header and no pickles, so it is
shared: one saved by either package loads in the other, and a bsp run
resumed from it lands bitwise on the other package's uninterrupted run.
"""
import numpy as np
import pytest
import torch

from repro.core import AsyncPS as RefAsyncPS
from repro.core import NetworkModel as RefNetworkModel
from repro.core import policies as ref_policies
from repro.runtime import PSRuntime as RefPSRuntime
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import conservative_vc as ref_conservative_vc
from repro.runtime import load_snapshot as ref_load_snapshot
from repro.runtime import save_snapshot as ref_save_snapshot
from repro.runtime import snapshot_params as ref_snapshot_params
from repro_torch.core import policies
from repro_torch.runtime import (PSRuntime, RuntimeConfig, conservative_vc,
                                 load_snapshot, save_snapshot,
                                 snapshot_params)

REF = dict(PSRuntime=RefPSRuntime, RuntimeConfig=RefRuntimeConfig,
           policies=ref_policies, load=ref_load_snapshot,
           save=ref_save_snapshot, params=ref_snapshot_params,
           conservative_vc=ref_conservative_vc, kw={})
PORT = dict(PSRuntime=PSRuntime, RuntimeConfig=RuntimeConfig,
            policies=policies, load=load_snapshot, save=save_snapshot,
            params=snapshot_params, conservative_vc=conservative_vc,
            kw={"device": "cpu"})
PKGS = (("ref", REF), ("port", PORT))


def _x0():
    return {"a": np.arange(32, dtype=float).reshape(8, 4) / 2.0,
            "b": np.ones(5)}


def _sched_fn(seed, shift=0):
    def fn(w, clock, view, rng):
        r = np.random.default_rng((seed, w, clock + shift))
        return {"a": r.integers(-3, 4, size=(8, 4)).astype(float),
                "b": r.integers(-3, 4, size=5).astype(float)}
    return fn


def _rt(P, n_workers, pol, x0=None, **kw):
    return P["PSRuntime"](P["RuntimeConfig"](
        n_workers, pol, _x0() if x0 is None else x0, **P["kw"], **kw))


def _masters(rt):
    return {k: rt.master_value(k) for k in ("a", "b")}


def _same(a, b):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_snapshot_resume_equals_uninterrupted_run():
    """Run 6 clocks, snapshot, resume a fresh runtime for 6 more: the final
    master of either package == the JAX simulator's 12-clock state."""
    sim = RefAsyncPS(4, ref_policies.ssp(2), _x0(), threads_per_process=2,
                     seed=0, network=RefNetworkModel(seed=0))
    sim.run(_sched_fn(0), 12)
    for _, P in PKGS:
        rt_a = _rt(P, 4, P["policies"].ssp(2), n_shards=2,
                   threads_per_process=2, seed=0)
        rt_a.run(_sched_fn(0), 6, timeout=60)
        snap = rt_a.snapshot()
        rt_b = _rt(P, 4, P["policies"].ssp(2), n_shards=2,
                   threads_per_process=2, seed=0, restore_from=snap)
        st = rt_b.run(_sched_fn(0, shift=6), 6, timeout=60)
        assert st.violations == []
        for k, ref in sim.views[0].items():
            np.testing.assert_array_equal(
                rt_b.master_value(k).reshape(ref.shape), ref,
                err_msg=f"resumed master[{k}]")


def test_snapshot_file_roundtrip(tmp_path):
    out = {}
    for name, P in PKGS:
        rt = _rt(P, 2, P["policies"].bsp(), n_shards=2)
        rt.run(_sched_fn(1), 4, timeout=60)
        snap = rt.snapshot()
        path = tmp_path / f"{name}.npz"
        P["save"](path, snap)
        loaded = P["load"](path)
        assert loaded["n_shards"] == 2
        assert loaded["shapes"] == {"a": (8, 4), "b": (5,)}
        for sid in range(2):
            for key in ("a", "b"):
                np.testing.assert_array_equal(
                    loaded["shards"][sid][key]["values"],
                    snap["shards"][sid][key]["values"])
        params = P["params"](loaded)
        _same(params, _masters(rt))
        out[name] = params
    _same(out["port"], out["ref"])


def test_killed_shard_rejoins_from_snapshot():
    for _, P in PKGS:
        rt = _rt(P, 2, P["policies"].ssp(1), n_shards=2)
        rt.run(_sched_fn(2), 5, timeout=60)
        snap = rt.snapshot()
        rt2 = _rt(P, 2, P["policies"].ssp(1), n_shards=2)
        for key, block in rt2.shards[1].dense.items():   # "killed"
            if isinstance(block, torch.Tensor):
                block.fill_(float("nan"))
            else:
                block[...] = np.nan
        rt2.shards[0].load_state(snap["shards"][0])
        rt2.shards[1].load_state(snap["shards"][1])
        _same(_masters(rt2), _masters(rt))


def test_restore_repartitions_across_different_n_shards():
    for _, P in PKGS:
        rt = _rt(P, 2, P["policies"].bsp(), n_shards=2)
        rt.run(_sched_fn(3), 4, timeout=60)
        snap = rt.snapshot()
        rt3 = _rt(P, 3, P["policies"].bsp(), n_shards=3,
                  threads_per_process=1, restore_from=snap)
        _same(_masters(rt3), _masters(rt))


def test_restore_rejects_mismatched_shapes_and_keys():
    for _, P in PKGS:
        rt = _rt(P, 2, P["policies"].bsp(), n_shards=2)
        rt.run(_sched_fn(4), 2, timeout=60)
        snap = rt.snapshot()
        with pytest.raises(ValueError, match="keys"):
            _rt(P, 2, P["policies"].bsp(), {"a": np.zeros((8, 4))},
                n_shards=2, restore_from=snap)
        with pytest.raises(ValueError, match="shape"):
            _rt(P, 2, P["policies"].bsp(),
                {"a": np.zeros((8, 5)), "b": np.zeros(5)}, n_shards=2,
                restore_from=snap)
        with pytest.raises(ValueError, match="version"):
            _rt(P, 2, P["policies"].bsp(), n_shards=2,
                restore_from={**snap, "version": 99})


def test_periodic_snapshots_on_clock_boundaries(tmp_path):
    for name, P in PKGS:
        sdir = tmp_path / name
        rt = _rt(P, 2, P["policies"].ssp(1), n_shards=2, seed=6,
                 snapshot_every=3, snapshot_dir=str(sdir))
        st = rt.run(_sched_fn(6), 9, timeout=60)
        assert st.violations == []
        clocks = [c for c, _ in rt.snapshots]
        assert clocks, "no periodic snapshot was taken"
        assert clocks == sorted(set(clocks))
        assert clocks[-1] == 9
        latest = rt.latest_snapshot()
        assert latest is not None and latest["n_proc"] == 2
        assert len(latest["clock_vcs"]) == 2
        assert all(int(vc.min()) == 8 for vc in latest["clock_vcs"])
        assert latest["clock"] == 9
        files = sorted(sdir.glob("snap_c*.npz"))
        assert len(files) == len(clocks)
        loaded = P["load"](files[-1])
        for vc_disk, vc_mem in zip(loaded["clock_vcs"], latest["clock_vcs"]):
            np.testing.assert_array_equal(vc_disk, vc_mem)
        assert loaded["clock"] == 9 and loaded["n_proc"] == 2
        rt2 = _rt(P, 2, P["policies"].ssp(1), n_shards=3,
                  restore_from=latest)
        _same(_masters(rt2), _masters(rt))


def test_shard_load_state_rejects_wrong_partition():
    for _, P in PKGS:
        rt = _rt(P, 2, P["policies"].bsp(), n_shards=2)
        snap = rt.snapshot()
        with pytest.raises(ValueError, match="partition"):
            rt.shards[0].load_state(snap["shards"][1])


def test_restore_shrinks_to_one_shard():
    for _, P in PKGS:
        rt = _rt(P, 2, P["policies"].ssp(1), n_shards=3)
        rt.run(_sched_fn(7), 4, timeout=60)
        snap = rt.snapshot()
        rt1 = _rt(P, 2, P["policies"].ssp(1), n_shards=1, restore_from=snap)
        _same(_masters(rt1), _masters(rt))
        st = rt1.run(_sched_fn(7, shift=4), 3, timeout=60)
        assert st.violations == []


def test_restore_grows_with_empty_key_ranges():
    """8 shards for a 5-row key: three own zero rows of "b" — empty blocks
    restore, apply, snapshot and read back cleanly."""
    out = {}
    for name, P in PKGS:
        rt = _rt(P, 2, P["policies"].bsp(), n_shards=2)
        rt.run(_sched_fn(8), 4, timeout=60)
        snap = rt.snapshot()
        rt8 = _rt(P, 2, P["policies"].bsp(), n_shards=8, restore_from=snap)
        assert sum(rt8.partition.rows_of("b", s).size for s in range(8)) == 5
        assert any(rt8.partition.rows_of("b", s).size == 0 for s in range(8))
        _same(_masters(rt8), _masters(rt))
        st = rt8.run(_sched_fn(8, shift=4), 3, timeout=60)
        assert st.violations == []
        snap8 = rt8.snapshot()
        assert snap8["n_shards"] == 8
        _same(P["params"](snap8), _masters(rt8))
        out[name] = _masters(rt8)
    _same(out["port"], out["ref"])


def test_restore_under_different_n_proc():
    for _, P in PKGS:
        rt = _rt(P, 2, P["policies"].ssp(1), n_shards=2,
                 threads_per_process=1)
        rt.run(_sched_fn(9), 5, timeout=60)
        snap = rt.snapshot()
        assert snap["n_proc"] == 2
        rt3 = _rt(P, 3, P["policies"].ssp(1), n_shards=2,
                  threads_per_process=1, restore_from=snap)
        assert rt3.n_proc == 3
        _same(_masters(rt3), _masters(rt))
        vc = P["conservative_vc"](snap, n_shards=2, n_proc=3)
        assert vc.shape == (2, 3) and (vc == -1).all()
        st = rt3.run(_sched_fn(9, shift=5), 3, timeout=60)
        assert st.violations == []


def test_tampered_vc_snapshot_refused():
    for _, P in PKGS:
        rt = _rt(P, 2, P["policies"].ssp(1), n_shards=2)
        rt.run(_sched_fn(10), 4, timeout=60)
        snap = rt.snapshot()

        def restore(s):
            return _rt(P, 2, P["policies"].ssp(1), n_shards=2,
                       restore_from=s)

        wrong_shape = {**snap,
                       "clock_vcs": [vc[:1] for vc in snap["clock_vcs"]]}
        with pytest.raises(ValueError, match="malformed"):
            restore(wrong_shape)
        with pytest.raises(ValueError, match="malformed"):
            restore({**snap, "clock_vcs": [vc.astype(float)
                                           for vc in snap["clock_vcs"]]})
        huge = [vc.copy() for vc in snap["clock_vcs"]]
        huge[0][0] = 1 << 50
        with pytest.raises(ValueError, match="tampered"):
            restore({**snap, "clock_vcs": huge})
        with pytest.raises(ValueError, match="contradicts"):
            restore({**snap, "clock_vcs": [vc + 1
                                           for vc in snap["clock_vcs"]]})
        with pytest.raises(ValueError, match="malformed"):
            P["conservative_vc"](wrong_shape, n_shards=2, n_proc=2)


# ---------------------------------------------------------------------------
# cross-package: a snapshot saved by one package restores into the other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("saved_by,resumed_by", [("ref", "port"),
                                                 ("port", "ref")])
def test_snapshot_crosses_packages_and_resumes_bitwise(tmp_path, seed,
                                                       saved_by, resumed_by):
    """bsp + barrier_reads for 5 clocks in one package, snapshot saved to
    disk, loaded by the other package's loader and resumed there for 5
    more: the master equals, bitwise, the saving package's uninterrupted
    10-clock run (tolerance: none)."""
    pk = dict(PKGS)
    A, B = pk[saved_by], pk[resumed_by]

    def bsp(P, **kw):
        return _rt(P, 2, P["policies"].bsp(), n_shards=2, seed=seed,
                   barrier_reads=True, **kw)

    rt_a = bsp(A)
    rt_a.run(_sched_fn(seed), 5, timeout=60)
    path = tmp_path / "snap.npz"
    A["save"](path, rt_a.snapshot())
    snap = B["load"](path)
    for k, v in B["params"](snap).items():
        np.testing.assert_array_equal(v, rt_a.master_value(k))
    rt_b = _rt(B, 2, B["policies"].bsp(), n_shards=3, seed=seed,
               barrier_reads=True, restore_from=snap)
    st = rt_b.run(_sched_fn(seed, shift=5), 5, timeout=60)
    assert st.violations == []
    whole = bsp(A)
    whole.run(_sched_fn(seed), 10, timeout=60)
    _same(_masters(rt_b), _masters(whole))
