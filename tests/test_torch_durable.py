"""The runtime's observability and durability tiers with the masters on the
card.

Every test here needs a CUDA device (the ``cuda`` marker) and skips
without one; the file imports nothing of JAX, and holds the card against
the port's own plain versions on the CPU:

  * the traced, logged runtime on the card, on the queue transport and
    with forked clients over the shm rings: the trace reconciles with the
    audit counters, the apply spans sit behind stream synchronizes, the WAL
    recovers on the card to the final master, bitwise;
  * ``recover_to_vc(device="cuda")`` bitwise equal to ``device="cpu"`` on
    the same log, every replayed part through the ``ps_apply`` kernel;
  * ``restore_from`` into masters on the card;
  * with tracing and the WAL off, the apply path never synchronizes.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import policies
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.runtime import (PSRuntime, RuntimeConfig, recover_to_vc,
                                 wal_segments)
from repro_torch.runtime import trace as trace_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    # CUDA is live in this process before a runtime forks its clients
    torch.zeros(1, device="cuda")
    return "cuda"


def _x0():
    return {"a": np.arange(96, dtype=float).reshape(24, 4) / 2.0,
            "b": np.ones(7)}


def _fn(seed):
    def fn(w, clock, view, rng):
        r = np.random.default_rng((seed, w, clock))
        return {"a": r.integers(-3, 4, size=(24, 4)).astype(float),
                "b": r.integers(-3, 4, size=7).astype(float)}
    return fn


def _expected(seed, n_workers, n_clocks):
    out = {k: v.astype(float) for k, v in _x0().items()}
    for w in range(n_workers):
        for c in range(n_clocks):
            for k, d in _fn(seed)(w, c, None, None).items():
                out[k] = out[k] + d
    return out


class _SyncCounter:
    """Counts stream synchronizes made while it is installed."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = torch.cuda.Stream.synchronize

        def counting(stream):
            self.n += 1
            return orig(stream)

        monkeypatch.setattr(torch.cuda.Stream, "synchronize", counting)


@pytest.mark.parametrize("transport", ["queue", "shm"])
def test_traced_logged_runtime_on_the_card(cuda, tmp_path, monkeypatch,
                                           transport):
    syncs = _SyncCounter(monkeypatch)
    wal_dir, sdir = str(tmp_path / "wal"), str(tmp_path / "snaps")
    rt = PSRuntime(RuntimeConfig(
        4, policies.ssp(1), _x0(), n_shards=2, seed=3, transport=transport,
        trace=True, wal_dir=wal_dir, wal_fsync="boundary", snapshot_every=2,
        snapshot_dir=sdir, device=cuda))
    apply_ops.launches = 0
    st = rt.run(_fn(3), 6, timeout=120)
    launched = apply_ops.launches
    assert st.violations == []
    assert all(t.is_cuda and t.dtype == torch.float64
               for s in rt.shards for t in s.dense.values())
    assert launched > 0
    exp = _expected(3, 4, 6)
    for k, v in exp.items():
        np.testing.assert_array_equal(rt.master_value(k), v)
    # the trace reconciles exactly with the audit counters, every client's
    # rings adopted
    counts = rt._trace.counts()
    applied = sum(int(s.applied_parts.sum()) for s in rt.shards)
    assert rt._trace.dropped() == 0
    assert counts[trace_mod.EV_SEND] == counts[trace_mod.EV_APPLY_PART] \
        == applied == int(rt._parts_sent.sum())
    # one stream synchronize ends each apply span on the card
    assert syncs.n >= counts[trace_mod.EV_APPLY] > 0
    m = rt.metrics()
    assert sum(s.parts_applied for s in m.shards) == applied
    assert sum(s.wal_parts for s in m.shards) == applied
    on_disk = sum(os.path.getsize(p) for segs in wal_segments(wal_dir).values()
                  for _, p in segs)
    assert sum(s.wal_bytes for s in m.shards) == on_disk
    # recovery on the card, from genesis and from the newest snapshot
    apply_ops.launches = 0
    gen = recover_to_vc(_x0(), wal_dir, device=cuda)
    assert apply_ops.launches > 0
    snap = recover_to_vc(_x0(), wal_dir, snapshot_dir=sdir, device=cuda)
    assert snap["from_snapshot"] is not None
    assert snap["n_replayed"] < gen["n_replayed"] == applied
    for rec in (gen, snap):
        assert rec["applied_parts"].tolist() == rt._parts_sent.tolist()
        for k in exp:
            np.testing.assert_array_equal(rec["params"][k],
                                          rt.master_value(k))


def test_recover_on_the_card_equals_the_cpu_bitwise(cuda, tmp_path):
    """The same log replayed on the card (ps_apply kernel) and on the CPU
    (its plain version): bitwise equal params, applied_parts, clock_vc.
    Non-integer deltas make the order of the adds matter."""
    wal_dir = str(tmp_path / "wal")

    def fn(w, clock, view, rng):
        r = np.random.default_rng((11, w, clock))
        return {"a": r.normal(size=(24, 4)), "b": r.normal(size=7)}

    rt = PSRuntime(RuntimeConfig(4, policies.ssp(2), _x0(), n_shards=2,
                                 threads_per_process=2, seed=11,
                                 wal_dir=wal_dir, device="cpu"))
    rt.run(fn, 8, timeout=120)
    for upto in (None, [3, 3]):
        apply_ops.launches = 0
        card = recover_to_vc(_x0(), wal_dir, upto_vc=upto, device=cuda)
        assert apply_ops.launches > 0
        host = recover_to_vc(_x0(), wal_dir, upto_vc=upto, device="cpu")
        for k in host["params"]:
            assert isinstance(card["params"][k], np.ndarray)
            np.testing.assert_array_equal(card["params"][k],
                                          host["params"][k])
        for f in ("applied_parts", "clock_vc"):
            np.testing.assert_array_equal(card[f], host[f])
        assert card["n_replayed"] == host["n_replayed"]
    # the default device is the card
    default = recover_to_vc(_x0(), wal_dir)
    for k in host["params"]:
        np.testing.assert_array_equal(default["params"][k],
                                      recover_to_vc(_x0(), wal_dir,
                                                    device="cpu")["params"][k])


def test_restore_from_into_masters_on_the_card(cuda):
    rt = PSRuntime(RuntimeConfig(2, policies.bsp(), _x0(), n_shards=2,
                                 device="cpu"))
    rt.run(_fn(5), 4, timeout=60)
    snap = rt.snapshot()
    rt2 = PSRuntime(RuntimeConfig(2, policies.bsp(), _x0(), n_shards=3,
                                  restore_from=snap, device=cuda))
    assert all(t.is_cuda for s in rt2.shards for t in s.dense.values())
    for k in ("a", "b"):
        np.testing.assert_array_equal(rt2.master_value(k), rt.master_value(k))
    # and it resumes on the card: 4 more clocks land on the 8-clock state
    st = rt2.run(lambda w, c, v, r: _fn(5)(w, c + 4, v, r), 4, timeout=60)
    assert st.violations == []
    for k, v in _expected(5, 2, 8).items():
        np.testing.assert_array_equal(rt2.master_value(k), v)


def test_apply_path_gains_no_synchronize_when_tracing_is_off(cuda,
                                                              monkeypatch):
    syncs = _SyncCounter(monkeypatch)
    rt = PSRuntime(RuntimeConfig(4, policies.ssp(1), _x0(), n_shards=2,
                                 seed=1, device=cuda))
    apply_ops.launches = 0
    rt.run(_fn(1), 4, timeout=60)
    assert apply_ops.launches > 0
    assert syncs.n == 0
    assert rt._trace is None and all(s.wal is None for s in rt.shards)
