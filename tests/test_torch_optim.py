"""The port's optimizers, schedules and synthetic LM data against the JAX
package's, on the CPU.

Optimizers: the same numpy trees (float32 params and grads, one leaf 2-D,
one stacked 3-D, one 0-d) go through ``repro.optim`` and
``repro_torch.optim`` for three steps each; updates and state to rtol 2e-4,
atol 2e-5 (float32 summation and ``pow``/``sqrt`` may differ by an ulp),
bfloat16 moments to one bfloat16 ulp (2^-7 relative).  Schedules at steps 0,
1 and 9 to rtol 1e-6 (``cos`` may differ by an ulp).  Data: token ids and
labels bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as R
from repro.data import SyntheticLM as RefLM
from repro.data import batches as ref_batches
from repro_torch import optim as P
from repro_torch.data import SyntheticLM, batches
from repro_torch.models.common import tree_map, tree_paths

RTOL, ATOL = 2e-4, 2e-5


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "scan": [{"a": rng.normal(size=(3, 4, 2)).astype(np.float32)}],
              "s": np.asarray(rng.normal(), np.float32)}
    grads = [tree_map(lambda a: np.asarray(rng.normal(size=a.shape) * 0.1,
                                           np.float32), params)
             for _ in range(3)]
    return params, grads


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(ref_tree, port_tree, **tol):
    ref_leaves = jax.tree.leaves(jax.tree.map(_np, ref_tree))
    # tree_paths walks dicts by sorted key, as jax.tree.leaves does
    port = [t.float().numpy() for t in tree_paths(port_tree).values()]
    assert len(ref_leaves) == len(port)
    for a, b in zip(ref_leaves, port):
        np.testing.assert_allclose(b, a, **tol)


@pytest.mark.parametrize("kind,wd,moment_dtype", [
    ("sgd", 0.0, None), ("momentum", 0.0, None), ("adam", 0.0, None),
    ("adam", 0.1, None), ("adam", 0.0, "bfloat16")])
def test_optimizer_matches_reference(kind, wd, moment_dtype):
    params, grads = _trees(1)
    rdt = jnp.bfloat16 if moment_dtype else None
    pdt = torch.bfloat16 if moment_dtype else None
    rp = jax.tree.map(jnp.asarray, params)
    pp = tree_map(torch.from_numpy, params)
    rs = R.init_opt_state(rp, kind, dtype=rdt)
    ps = P.init_opt_state(pp, kind, dtype=pdt)
    rfn, pfn = R.optimizer_update(kind), P.optimizer_update(kind)
    lr = 1e-2
    for g in grads:
        ru, rs = rfn(jax.tree.map(jnp.asarray, g), rs, jnp.float32(lr),
                     weight_decay=wd, params=rp)
        pu, ps = pfn(tree_map(torch.from_numpy, g), ps,
                     torch.tensor(lr, dtype=torch.float32),
                     weight_decay=wd, params=pp)
        _close(ru, pu, rtol=RTOL, atol=ATOL)
        assert int(rs.count) == int(ps.count)
        assert ps.count.dtype == torch.int32
        mtol = (dict(rtol=2 ** -7, atol=ATOL) if moment_dtype
                else dict(rtol=RTOL, atol=ATOL))
        if kind != "sgd":
            _close(rs.mu, ps.mu, **mtol)
        if kind == "adam":
            _close(rs.nu, ps.nu, **mtol)
            leaf = ps.mu["w"]
            assert leaf.dtype == (pdt or torch.float32)


def test_init_opt_state_layout():
    params, _ = _trees(2)
    pp = tree_map(torch.from_numpy, params)
    for kind in ("sgd", "momentum", "adam"):
        rs = R.init_opt_state(jax.tree.map(jnp.asarray, params), kind)
        ps = P.init_opt_state(pp, kind)
        for rt, pt in ((rs.mu, ps.mu), (rs.nu, ps.nu)):
            shapes = [tuple(t.shape) for t in tree_paths(pt).values()]
            assert shapes == [tuple(a.shape) for a in jax.tree.leaves(rt)]
    with pytest.raises(ValueError):
        P.init_opt_state(pp, "lion")


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("cosine", (3e-4, 100)), ("cosine", (1.0, 7, 0.2)),
    ("sqrt_decay", (0.5,))])
def test_schedules_match_reference(name, args):
    rf, pf = getattr(R, name)(*args), getattr(P, name)(*args)
    for step in (0, 1, 9):
        a = float(rf(jnp.asarray(step, jnp.int32)))
        b = pf(torch.tensor(step, dtype=torch.int32))
        assert b.dtype == torch.float32 and b.dim() == 0
        np.testing.assert_allclose(float(b), a, rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 1, 10])
def test_linear_warmup_matches_reference(warmup):
    rf = R.linear_warmup(3e-4, warmup, R.constant(3e-4))
    pf = P.linear_warmup(3e-4, warmup, P.constant(3e-4))
    for step in (0, 1, 9):
        a = float(rf(jnp.asarray(step, jnp.int32)))
        b = float(pf(torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(b, a, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("vocab", [512, 50_280])
def test_synthetic_lm_ids_are_the_reference_bits(seed, vocab):
    ref, port = RefLM(vocab, seed=seed), SyntheticLM(vocab, seed=seed)
    assert np.array_equal(ref.tok_cluster, port.tok_cluster)
    for stream in (0, 3):
        a = ref.sample_tokens(700, stream)
        b = port.sample_tokens(700, stream)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shard", [0, 1])
def test_batches_match_reference(seed, shard):
    ref_it = ref_batches(RefLM(512, seed=seed), 3, 40, shard=shard,
                         n_shards=2)
    it = batches(SyntheticLM(512, seed=seed), 3, 40, shard=shard, n_shards=2)
    for _ in range(2):
        a, b = next(ref_it), next(it)
        assert set(a) == set(b) == {"ids", "labels"}
        for k in a:
            assert a[k].shape == (3, 40) and np.array_equal(a[k], b[k]), k
        assert np.array_equal(b["ids"][:, 1:], b["labels"][:, :-1])
