"""The port's MoE feed-forward against the JAX package's ``moe_fwd``, on the
CPU.

Both packages take the same weights (drawn by the JAX package from
``moe_defs``, the compute cast applied to each, as the model applies it) and
the same seeded inputs, and return the output and the router's Switch
auxiliary loss.  The cases cover a capacity factor low enough that pairs
are dropped, router probabilities tied exactly (``lax.top_k`` keeps the
lower expert first), shared experts, and decode's batches of T = 1 and 4
tokens, at the reduced OLMoE's widths (d 128, 4 experts of 64, top 2).

Tolerances.  float32: the output to 1e-5 of its largest magnitude, the aux
loss to rtol 1e-6 (XLA and torch sum the probabilities in other orders).
bfloat16: the routing runs in float32 on the same bfloat16 inputs in both,
so the routes and drops are the same; the output to 1e-2 of its largest
magnitude (the experts' products round to bfloat16 at other places: a few
ulps of 2^-8), the aux loss to rtol 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as ref_reduced_config
from repro.models import moe as RMoE
from repro.models.common import ShardCtx as RefCtx
from repro.models.common import instantiate_tree as ref_instantiate
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.models import moe
from repro_torch.models.common import ShardCtx, compute_cast, tree_map

DTYPES = ["float32", "bfloat16"]
Y_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
AUX_RTOL = 1e-6


def _cfgs(dtype, **moe_kw):
    """(reference, port) reduced OLMoE configs with ``moe_kw`` replaced."""
    out = []
    for cfg in (ref_reduced_config("olmoe-1b-7b"),
                reduced_config("olmoe-1b-7b")):
        out.append(dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
            cfg.moe, **moe_kw)))
    return tuple(out)


def _params(rcfg, dtype, seed=0, router=None):
    """The reference's weights as each package's tree, compute cast."""
    tree = jax.tree.map(np.asarray, ref_instantiate(
        RMoE.moe_defs(rcfg, 1), jax.random.key(seed)))
    if router is not None:
        tree["router"] = router.astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt) if a.ndim > 1
                       else jnp.asarray(a), tree)
    port = tree_map(lambda t: compute_cast(t, getattr(torch, dtype)),
                    convert.model_params_from_reference(tree, "cpu"))
    return ref, port


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _run(dtype, shape, router=None, **moe_kw):
    rcfg, cfg = _cfgs(dtype, **moe_kw)
    rp, pp = _params(rcfg, dtype, router=router)
    rx, px = _x(shape, dtype)
    ry, raux = RMoE.moe_fwd(rcfg, RefCtx(), rp, rx)
    with torch.inference_mode():
        y, aux = moe.moe_fwd(cfg, ShardCtx(), pp, px)
    return cfg, pp, px, (ry, raux), (y, aux)


def _close(ref, got, dtype):
    (ry, raux), (y, aux) = ref, got
    assert y.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    r = np.asarray(ry).astype(np.float32)
    g = y.float().numpy()
    assert r.shape == g.shape
    scale = float(np.abs(r).max())
    err = float(np.abs(r - g).max())
    assert err <= Y_TOL[dtype] * scale, (err, scale)
    np.testing.assert_allclose(float(aux), float(raux), rtol=AUX_RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_matches_reference(dtype):
    _, _, _, ref, got = _run(dtype, (2, 16, 128))
    _close(ref, got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_drops_past_capacity_like_the_reference(dtype):
    """cf 0.5: C = ceil(32 * 2 * 0.5 / 4) = 8 slots an expert for 64 pairs,
    so at least half of them are dropped; the dropped pairs add nothing."""
    cfg, pp, px, ref, got = _run(dtype, (2, 16, 128), capacity_factor=0.5)
    assert moe.capacity(cfg.moe, 32) == 8
    probs = moe.router_probs(pp, px.reshape(-1, 128))
    drops = int((~moe.dispatch(cfg.moe, probs)[2]).sum())
    assert drops >= 32, drops
    _close(ref, got, dtype)
    # with no drops (cf 8) the output differs: the drops were real
    _, _, _, _, (y8, _) = _run(dtype, (2, 16, 128), capacity_factor=8.0)
    assert not torch.equal(y8, got[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_tied_router_probabilities_keep_the_lower_expert(dtype):
    """A zero router ties every expert (p = 1/4): lax.top_k keeps experts
    0 and 1 for every token, and so does the port; a router whose columns 1
    and 3 are equal ties those two in every row."""
    zero = np.zeros((128, 4), np.float32)
    cfg, pp, px, ref, got = _run(dtype, (2, 8, 128), router=zero)
    probs = torch.full((16, 4), 0.25)
    _, ids = moe.route(probs, 2)
    assert ids.tolist() == [[0, 1]] * 16
    _close(ref, got, dtype)
    w = np.random.default_rng(5).standard_normal((128, 4)).astype(np.float32)
    w[:, 3] = w[:, 1]
    _, pp, px, ref, got = _run(dtype, (2, 8, 128), router=w * 0.5)
    _close(ref, got, dtype)
    probs = torch.softmax(px.float().reshape(-1, 128)
                          @ pp["router"].float(), -1)
    assert torch.equal(probs[:, 1], probs[:, 3])
    vals, ids = moe.route(probs, 2)
    rvals, rids = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_experts_match_reference(dtype):
    _, pp, _, ref, got = _run(dtype, (2, 16, 128), n_shared_experts=1,
                              d_shared=64)
    assert set(pp["shared"]) == {"w_in", "w_gate", "w_out"}
    _close(ref, got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 4])
def test_decode_batches_match_reference(batch, dtype):
    """Decode routes T = b tokens: C = 1 for one token and 3 for four at
    cf 1.25, so four tokens can overflow an expert; the port keeps the
    reference's drops."""
    cfg, pp, px, ref, got = _run(dtype, (batch, 1, 128))
    assert moe.capacity(cfg.moe, batch) == {1: 1, 4: 3}[batch]
    _close(ref, got, dtype)


def test_capacity_and_defs_match_reference():
    from repro.models.common import ParamDef as RefDef
    rcfg, cfg = _cfgs("float32", n_shared_experts=2, d_shared=96)
    for t in (1, 4, 16, 1000, 16_388):
        want = max(1, int(np.ceil(t * cfg.moe.top_k
                                  * cfg.moe.capacity_factor
                                  / cfg.moe.n_experts)))
        assert moe.capacity(cfg.moe, t) == want
    ref = jax.tree_util.tree_leaves_with_path(
        RMoE.moe_defs(rcfg, 1), is_leaf=lambda x: isinstance(x, RefDef))
    got = moe.moe_defs(cfg, 1)
    flat = {jax.tree_util.keystr(p): (tuple(d.shape), d.init, d.scale)
            for p, d in ref}
    port = {}
    for k, v in got.items():
        for k2, d in (v.items() if isinstance(v, dict) else [(None, v)]):
            key = f"[{k!r}]" + (f"[{k2!r}]" if k2 else "")
            port[key] = (tuple(d.shape), d.init, d.scale)
    assert port == flat


def test_moe_gradients_match_reference():
    """The output's and the aux loss's gradients through routing, dispatch
    and combine, against ``jax.grad``, float32 (rtol 2e-4, atol 2e-5)."""
    rcfg, cfg = _cfgs("float32", capacity_factor=1.0, n_shared_experts=1,
                      d_shared=64)
    rp, pp = _params(rcfg, "float32")
    rx, px = _x((2, 16, 128), "float32")
    proj = np.random.default_rng(9).standard_normal((2, 16, 128)).astype(
        np.float32)

    def ref_loss(p, x):
        y, aux = RMoE.moe_fwd(rcfg, RefCtx(), p, x)
        return jnp.sum(y * proj) + 0.5 * aux

    rg, rgx = jax.grad(ref_loss, argnums=(0, 1))(rp, rx)
    leaves = []
    pp = tree_map(lambda t: leaves.append(t.requires_grad_(True)) or t, pp)
    px.requires_grad_(True)
    y, aux = moe.moe_fwd(cfg, ShardCtx(), pp, px)
    loss = torch.sum(y * torch.from_numpy(proj)) + 0.5 * aux
    loss.backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(rgx), rtol=2e-4,
                               atol=2e-5)
    want = {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(rg)}
    for k, v in pp.items():
        for k2, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            key = f"[{k!r}]" + (f"[{k2!r}]" if k2 else "")
            np.testing.assert_allclose(t.grad.numpy(), want[key], rtol=2e-4,
                                       atol=2e-5, err_msg=key)
