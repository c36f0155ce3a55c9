"""Elastic shard membership with the masters on the card.

Every test here needs a CUDA device (the ``cuda`` marker) and skips
without one; the file imports nothing of JAX:

  * an add and a remove mid-run on the queue runtime and with forked
    clients over the shm rings, at a mid width: after each install every
    slot's blocks are float64 on the card in the new partition's shape
    (an inactive slot's ``(0, C)``), the handoff clones and the installed
    blocks are CUDA tensors, no master block is copied to the host during
    the ops, and the final master is bitwise ``x0 + Σ updates``;
  * the held next-epoch replay, driven message by message: every replayed
    apply is a ``ps_apply`` launch counted under ``"epoch_replay"`` and
    nowhere else, and the blocks equal the same sequence on the CPU;
  * a replica through two ops is bitwise the master at quiesce.
"""
import itertools
import time

import numpy as np
import pytest
import torch

from repro_torch.core import policies
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.runtime import (MembershipPlan, PSRuntime, ReadGateway,
                                 RuntimeConfig)
from repro_torch.runtime import messages as M
from repro_torch.runtime.membership import Partition, assemble_on_device
from repro_torch.runtime.shard import REPLAY_SITE, ServerShard

pytestmark = [pytest.mark.cuda, pytest.mark.membership,
              pytest.mark.filterwarnings("ignore::DeprecationWarning")]

R, C, B = 4_000, 64, 64          # a mid width: a (4000, 64) and a (64,) key


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    # CUDA is live in this process before a runtime forks its clients
    torch.zeros(1, device="cuda")
    return "cuda"


def _x0():
    return {"a": np.arange(R * C, dtype=float).reshape(R, C) / 4.0,
            "b": np.ones(B)}


def _fn(w, clock, view, rng):
    r = np.random.default_rng((5, w, clock))
    a = np.zeros((R, C))
    rows = r.choice(R, size=200, replace=False)
    a[rows] = r.integers(-3, 4, size=(200, C))
    return {"a": a, "b": r.integers(-3, 4, size=B).astype(float)}


def _expected(n_workers, n_clocks):
    out = _x0()
    for w in range(n_workers):
        for c in range(n_clocks):
            for k, d in _fn(w, c, None, None).items():
                out[k] = out[k] + d
    return out


def _gated(rt, want, n_clocks):
    """Hold the workers at their last clock until ``want`` ops landed (the
    counter is shared memory, so forked clients read it too)."""
    import multiprocessing
    count = multiprocessing.get_context("fork").Value("i", 0)

    def on_epoch(*args):
        with count.get_lock():
            count.value += 1

    rt.membership.add_listener(on_epoch)

    def fn(w, clock, view, rng):
        if clock == n_clocks - 1:
            deadline = time.monotonic() + 60
            while count.value < want and time.monotonic() < deadline:
                time.sleep(0.005)
        return _fn(w, clock, view, rng)
    return fn


@pytest.mark.parametrize("transport", ["queue", "shm"])
def test_add_and_remove_on_the_card(cuda, transport, monkeypatch):
    seen = {"handoff": [], "install": [], "state": 0}
    cut, install, state = (ServerShard.device_cut, ServerShard._install,
                           ServerShard._state_locked)

    def device_cut(self):
        out = cut(self)
        seen["handoff"] += [v.device.type for _, v in out.values()]
        return out

    def _install(self, msg):
        if msg.blocks is not None:
            seen["install"] += [b.device.type for b in msg.blocks.values()]
        return install(self, msg)

    def _state_locked(self):
        seen["state"] += 1
        return state(self)

    monkeypatch.setattr(ServerShard, "device_cut", device_cut)
    monkeypatch.setattr(ServerShard, "_install", _install)
    monkeypatch.setattr(ServerShard, "_state_locked", _state_locked)
    n_clocks = 14
    tpp = 2 if transport == "queue" else 1
    plan = MembershipPlan.parse([(3, "add", 2), (8, "remove", 0)])
    rt = PSRuntime(RuntimeConfig(4, policies.ssp(2), _x0(), n_shards=2,
                                 threads_per_process=tpp, seed=0,
                                 max_shards=3, transport=transport,
                                 membership_plan=plan, device=cuda))
    layouts = []

    def check_layout(epoch, part, added, removed):
        for s in rt.shards:
            with s.lock:
                layouts.append(all(
                    b.is_cuda and b.dtype == torch.float64
                    and tuple(b.shape) == (part.rows_of(k, s.sid).size,
                                           b.shape[1])
                    for k, b in s.dense.items()))

    rt.membership.add_listener(check_layout)
    apply_ops.launches_by_site.clear()
    st = rt.run(_gated(rt, 2, n_clocks), n_clocks, timeout=240)
    assert st.violations == [], st.violations[:5]
    assert [r for _, r in plan.results] == ["ok", "ok"]
    assert rt.partition.active == (1, 2) and layouts == [True] * 6
    assert seen["handoff"] and set(seen["handoff"]) == {"cuda"}
    assert seen["install"] and set(seen["install"]) == {"cuda"}
    assert seen["state"] == 0          # no block went to the host mid-run
    assert [tuple(b.shape) for b in rt.shards[0].dense.values()] == [
        (0, C), (0, 1)]
    for op in rt.membership.ops:
        assert op["master_bytes"] == 8 * (R * C + B)
        assert op["handoff_bytes"] == op["master_bytes"]
        assert op["install_bytes"] == op["master_bytes"]
    applied = sum(int(s.applied_parts.sum()) for s in rt.shards)
    assert applied == int(rt._parts_sent.sum())
    for k, want in _expected(4, n_clocks).items():
        got = rt.master_value(k)
        assert got.tobytes() == want.reshape(got.shape).tobytes(), k


def _replay(device):
    """One add (slots 0, 1 -> 0, 1, 2) driven through an unstarted
    runtime's shards: Begin, next-epoch parts of both processes, the acks,
    then the handoffs reassembled and installed.  Returns the shards."""
    x0 = {"a": np.arange(300 * 17, dtype=float).reshape(300, 17),
          "b": np.zeros(9)}
    rt = PSRuntime(RuntimeConfig(2, policies.ssp(2), x0, n_shards=2,
                                 max_shards=3, device=device))
    part = Partition(1, (0, 1, 2), rt._row_counts)
    rng = np.random.default_rng(3)
    uid = itertools.count()
    for s in rt.shards:
        ups = [M.UpdateMsg(next(uid), p, p, 0, k, part.rows_of(k, s.sid),
                           rng.normal(size=(part.rows_of(k, s.sid).size,
                                            v.shape[1])), 1)
               for p in range(2) for k, v in rt._x0.items()]
        s._handle_batch([M.EpochBeginMsg(1, part), *ups,
                         M.EpochAckMsg(0, 1), M.EpochAckMsg(1, 1)])
    handoffs = dict(rt.membership.inbox.get_nowait()[1:] for _ in range(2))
    shapes = {k: v.shape for k, v in rt._x0.items()}
    full = assemble_on_device([handoffs[0][0], handoffs[1][0]], shapes,
                              rt.device)
    for s in rt.shards:
        blocks = {k: v.index_select(0, torch.from_numpy(
            part.rows_of(k, s.sid)).to(rt.device)) for k, v in full.items()}
        s._handle_batch([M.InstallMsg(1, part, blocks,
                                      np.full(2, -1, dtype=np.int64))])
    return rt.shards


def test_epoch_replay_launches_are_counted_where_ps_apply_launches(cuda):
    apply_ops.launches = 0
    apply_ops.launches_by_site.clear()
    shards = _replay(cuda)
    torch.cuda.synchronize()
    # each slot replays one run: one launch per key
    assert apply_ops.launches_by_site == {REPLAY_SITE: 3 * 2}
    assert apply_ops.launches == 3 * 2
    host = _replay("cpu")
    for s, h in zip(shards, host):
        assert s.applied_parts.tolist() == h.applied_parts.tolist() == [2, 2]
        for k, b in s.dense.items():
            assert b.is_cuda
            assert b.cpu().numpy().tobytes() == h.dense[k].numpy().tobytes()


def test_replica_through_two_ops_is_bitwise_the_master(cuda):
    n_clocks = 14
    rt = PSRuntime(RuntimeConfig(4, policies.ssp(2), _x0(), n_shards=2,
                                 threads_per_process=2, seed=0, max_shards=3,
                                 membership_plan=MembershipPlan.parse(
                                     [(3, "add", 2), (8, "remove", 1)]),
                                 device=cuda))
    rt.start(_gated(rt, 2, n_clocks), n_clocks, timeout=240)
    gw = ReadGateway(rt, n_replicas=1, transport="queue")
    try:
        st = rt.wait()
        assert st.violations == [] and len(rt.membership.log) == 2
        rset = gw.replicas
        deadline = time.monotonic() + 60
        while any(rset.staleness(r.vc, rset.master_vc())
                  for r in rset.replicas):
            assert time.monotonic() < deadline, "replica never caught up"
            time.sleep(5e-3)
        rep = rset.replicas[0]
        for k, want in _expected(4, n_clocks).items():
            assert rep.values[k].is_cuda
            got, _ = rep.serve(k)
            assert got.tobytes() == rt.master_value(k).reshape(
                got.shape).tobytes() == want.reshape(got.shape).tobytes()
        assert rset.errors == [] and rset.violations == []
    finally:
        gw.close()
