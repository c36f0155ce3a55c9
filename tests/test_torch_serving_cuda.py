"""The serving tier with the replicas' buffers on the card.

Every test here needs a CUDA device (the ``cuda`` marker) and skips
without one; the file imports nothing of JAX, and holds the card against
the port's own CPU path:

  * a seeded publish sequence (states with epoch cuts, deltas with repeated
    rows and rows behind their cut, vc stamps) through a replica on the
    card and one on the CPU: bitwise equal, and every key of every ingest
    batch one ``ps_apply`` launch;
  * a gateway over a runtime on the card, on the queue runtime and with
    forked clients over the shm rings, serving over queue, shm and tcp: the
    replicas' buffers are float64 on the card, bitwise the master at
    quiesce, and replica ingest launched ``ps_apply`` beside the shards.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import policies
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.runtime import PSRuntime, ReadGateway, RuntimeConfig
from repro_torch.runtime import messages as M
from repro_torch.runtime.serving import Replica
from repro_torch.runtime.serving.replica import INGEST_SITE

pytestmark = [pytest.mark.cuda, pytest.mark.serving,
              pytest.mark.filterwarnings("ignore::DeprecationWarning")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    # CUDA is live in this process before a runtime forks its clients
    torch.zeros(1, device="cuda")
    return "cuda"


def _standin(x0, n_slots, n_proc, device):
    rt = SimpleNamespace(_x0=x0, n_slots=n_slots, n_proc=n_proc,
                         trace_on=False, _trace=None,
                         device=torch.device(device))
    rset = SimpleNamespace(rt=rt, check=True, violations=[], errors=[])
    rset._violation = rset.violations.append
    rset._record_error = rset.errors.append
    rset._notify = lambda: None
    rset.master_vc = lambda: np.full((n_slots, n_proc), -1, dtype=np.int64)
    return rset


def _batches(seed, x0, n_slots=2, n_proc=3, n_msgs=60):
    """Seeded publish batches, each message stamped with its shard's seq."""
    rng = np.random.default_rng(seed)
    seqs = [0] * n_slots
    msgs = []

    def state(shard, epoch):
        st = {k: {"rows": np.arange(shard, v.shape[0], n_slots),
                  "values": rng.normal(size=(len(range(shard, v.shape[0],
                                                       n_slots)),
                                             v.shape[1]))}
              for k, v in x0.items()}
        return M.ReplicaStateMsg(shard, st, rng.integers(-1, 6, n_proc),
                                 epoch=epoch)

    for shard in range(n_slots):
        msgs.append(state(shard, 1 + shard))
    for _ in range(n_msgs):
        shard = int(rng.integers(n_slots))
        u = rng.random()
        if u < 0.7:
            k = list(x0)[int(rng.integers(len(x0)))]
            R, C = x0[k].shape
            n = int(rng.integers(1, 3 * R))
            msgs.append(M.ReplicaDeltaMsg(
                shard, k, rng.integers(0, R, n).astype(np.int64),
                rng.normal(size=(n, C)), epoch=int(rng.integers(0, 4))))
        elif u < 0.93:
            msgs.append(M.ReplicaVcMsg(shard, rng.integers(-1, 9, n_proc)))
        else:
            msgs.append(state(shard, int(rng.integers(1, 4))))
    for m in msgs:
        m.seq = seqs[m.shard]
        seqs[m.shard] += 1
    cuts = [0, *sorted(rng.choice(np.arange(1, len(msgs)), 6,
                                  replace=False)), len(msgs)]
    return [msgs[lo:hi] for lo, hi in zip(cuts, cuts[1:])]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replica_ingest_on_the_card_matches_the_cpu(cuda, seed):
    rng = np.random.default_rng(50 + seed)
    x0 = {"a": rng.normal(size=(300, 17)), "b": rng.normal(size=(9, 1))}
    batches = _batches(seed, x0)
    card = Replica(_standin(x0, 2, 3, cuda), 0)
    host = Replica(_standin(x0, 2, 3, "cpu"), 0)
    apply_ops.launches = 0
    apply_ops.launches_by_site.clear()
    for batch in batches:
        card._handle_batch(batch)
        host._handle_batch(batch)
    torch.cuda.synchronize()
    for rep in (card, host):
        assert rep.rset.errors == [] and not rep.poisoned
    assert (apply_ops.launches == apply_ops.launches_by_site[INGEST_SITE]
            == card.ingest_applies == host.ingest_applies)
    assert card.ingest_applies < card.deltas_applied
    assert card.stale_row_drops == host.stale_row_drops > 0
    assert np.array_equal(card.vc, host.vc)
    for k in x0:
        buf = card.values[k]
        assert buf.is_cuda and buf.dtype == torch.float64
        assert buf.cpu().numpy().tobytes() == host.values[k].numpy().tobytes()
        got, _ = card.serve(k)
        assert got.tobytes() == host.values[k].numpy().tobytes()


def _x0():
    return {"a": np.arange(96, dtype=float).reshape(24, 4) / 2.0,
            "b": np.ones(7)}


def _fn(w, clock, view, rng):
    time.sleep(0.002)
    r = np.random.default_rng((3, w, clock))
    return {"a": r.integers(-3, 4, size=(24, 4)).astype(float),
            "b": r.integers(-3, 4, size=7).astype(float)}


@pytest.mark.parametrize("transport,serving", [
    ("queue", "queue"), ("queue", "shm"), ("queue", "tcp"), ("shm", "shm"),
    ("tcp", "tcp")])
def test_gateway_on_the_card_replicas_equal_the_master(cuda, transport,
                                                       serving):
    rt = PSRuntime(RuntimeConfig(4, policies.ssp(2), _x0(), n_shards=2,
                                 threads_per_process=2 if transport == "queue"
                                 else 1, seed=1, transport=transport,
                                 device=cuda))
    apply_ops.launches = 0
    apply_ops.launches_by_site.clear()
    rt.start(_fn, 12, timeout=120)
    gw = ReadGateway(rt, n_replicas=2, transport=serving)
    try:
        while rt.running:
            res = gw.read("a", slo=2, timeout=10.0)
            assert res.staleness <= 2
            time.sleep(2e-3)
        st = rt.wait()
        assert st.violations == []
        rset = gw.replicas
        deadline = time.monotonic() + 30
        while any(rset.staleness(r.vc, rset.master_vc())
                  for r in rset.replicas):
            assert time.monotonic() < deadline, "replicas never caught up"
            time.sleep(5e-3)
        for rep in rset.replicas:
            for k in _x0():
                assert rep.values[k].is_cuda
                got, _ = rep.serve(k)
                want = rt.master_value(k).reshape(got.shape)
                assert got.tobytes() == want.tobytes(), (rep.rid, k)
        res = gw.read("a", slo=0, timeout=10.0)
        assert res.source.startswith("replica:")
        ingest = apply_ops.launches_by_site[INGEST_SITE]
        assert ingest == sum(r.ingest_applies for r in rset.replicas)
        assert ingest > 0 and apply_ops.launches > ingest
        assert rset.errors == [] and rset.violations == []
    finally:
        gw.close()
