"""The port's multi-head latent attention (DeepSeek-V2's MLA) against the
JAX package's, on the CPU.

At the reduced DeepSeek's sizes (d 128, 4 heads, latent rank 32, q / k 48
wide = 32 + 16 rotary, v 32 wide), both packages take the same weights
(drawn by the JAX package from ``mla_defs``, compute cast) and the same
seeded inputs: the prefill's output and the latent ring it fills
(``latent``, ``k_rope``, ``pos``), then three absorbed decode steps'
outputs and rings, with the full window and with a window of 8 over a ring
of 8 slots (the prefill keeps the last 8 positions, decode overwrites the
oldest).  The port's prefill goes through the flash hook with G = 1 and
v narrower than q / k.

Tolerances.  float32: outputs and rings to 1e-5 of their largest
magnitude; positions exactly.  bfloat16: to 1e-2 of the largest magnitude
(a few bfloat16 ulps: XLA keeps float32 inside a fusion where torch rounds
after every op).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as ref_reduced_config
from repro.models import attention as RA
from repro.models.common import ShardCtx as RefCtx
from repro.models.common import instantiate_tree as ref_instantiate
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.common import ShardCtx, compute_cast, tree_map

S, N_DECODE, B = 16, 3, 2
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _cfgs(dtype):
    return tuple(dataclasses.replace(c, dtype=dtype) for c in (
        ref_reduced_config("deepseek-v2-lite-16b"),
        reduced_config("deepseek-v2-lite-16b")))


def _close(ref, got, dtype, what):
    r = np.asarray(ref)
    if r.dtype == np.int32:
        assert got.dtype == torch.int32, what
        np.testing.assert_array_equal(got.numpy(), r, err_msg=what)
        return
    assert got.dtype == getattr(torch, dtype), (what, got.dtype)
    r = r.astype(np.float32)
    g = got.float().numpy()
    assert r.shape == g.shape, (what, r.shape, g.shape)
    scale = max(float(np.abs(r).max()), 1e-6)
    err = float(np.abs(r - g).max())
    assert err <= TOL[dtype] * scale, (what, err, scale)


def _run(dtype, window, capacity, monkeypatch):
    rcfg, cfg = _cfgs(dtype)
    tree = jax.tree.map(np.asarray, ref_instantiate(
        RA.mla_defs(rcfg, 1), jax.random.key(3)))
    jdt = jnp.dtype(dtype)
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt) if a.ndim > 1
                      else jnp.asarray(a), tree)
    pp = tree_map(lambda t: compute_cast(t, getattr(torch, dtype)),
                  convert.model_params_from_reference(tree, "cpu"))
    x = np.random.default_rng(4).standard_normal(
        (B, S + N_DECODE, cfg.d_model)).astype(np.float32)
    rx = jnp.asarray(x).astype(jdt)
    px = torch.from_numpy(x).to(getattr(torch, dtype))

    calls = []
    orig = attn.attention_core_dispatch

    def hook(q, k, v, *a, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return orig(q, k, v, *a, **kw)

    monkeypatch.setattr(attn, "attention_core_dispatch", hook)
    rctx, ctx = RefCtx(), ShardCtx()
    rcache = RA.empty_cache(RA.cache_defs(rcfg, 1, B, capacity))
    pcache = M.empty_cache_tree(attn.cache_defs(cfg, 1, B, capacity), "cpu")
    ry, rcache = RA.mla_fwd(rcfg, rctx, rp, rx[:, :S], window=window,
                            cache=rcache, pos=None)
    with torch.inference_mode():
        y, pcache = attn.attn_fwd(cfg, ctx, pp, px[:, :S], window=window,
                                  cache=pcache)
    out = {"prefill": ((ry, rcache), (y, tree_map(torch.clone, pcache))),
           "decode": [], "calls": calls}
    for j in range(N_DECODE):
        pos = np.full((B,), S + j, np.int32)
        ry, rcache = RA.mla_fwd(rcfg, rctx, rp, rx[:, S + j:S + j + 1],
                                window=window, cache=rcache,
                                pos=jnp.asarray(pos))
        with torch.inference_mode():
            y, pcache = attn.attn_fwd(cfg, ctx, pp, px[:, S + j:S + j + 1],
                                      window=window, cache=pcache,
                                      pos=torch.from_numpy(pos))
        out["decode"].append(((ry, rcache), (y, tree_map(torch.clone,
                                                         pcache))))
    return cfg, out


CASES = [(None, S + 8), (8, 8)]


@pytest.mark.parametrize("window,capacity", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_ring_match_reference(dtype, window, capacity,
                                              monkeypatch):
    cfg, out = _run(dtype, window, capacity, monkeypatch)
    (ry, rcache), (y, pcache) = out["prefill"]
    _close(ry, y, dtype, "prefill")
    assert sorted(pcache) == sorted(rcache) == ["k_rope", "latent", "pos"]
    for name in rcache:
        _close(rcache[name], pcache[name], dtype, f"prefill {name}")
    # one flash call a prefill: G = 1, q / k 48 wide, v 32 wide
    m = cfg.mla
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert out["calls"] == [((B, S, 4, 1, qd), (B, S, 4, qd),
                             (B, S, 4, m.v_head_dim),
                             {"window": window, "cap": None})]
    if capacity < S:             # the ring holds the last positions only
        assert sorted(pcache["pos"][0].tolist()) == list(
            range(S - capacity, S))


@pytest.mark.parametrize("window,capacity", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_reference(dtype, window, capacity,
                                               monkeypatch):
    _, out = _run(dtype, window, capacity, monkeypatch)
    for j, ((ry, rcache), (y, pcache)) in enumerate(out["decode"]):
        _close(ry, y, dtype, f"decode {j}")
        for name in rcache:
            _close(rcache[name], pcache[name], dtype, f"decode {j} {name}")
    assert len(out["calls"]) == 1          # decode calls no flash kernel


def test_mla_defs_and_cache_defs_match_reference():
    from repro.models.common import ParamDef as RefDef
    rcfg, cfg = _cfgs("bfloat16")
    ref = {jax.tree_util.keystr(p)[2:-2]: (tuple(d.shape), d.init)
           for p, d in jax.tree_util.tree_leaves_with_path(
               RA.attn_defs(rcfg, 1), is_leaf=lambda x: isinstance(x, RefDef))}
    got = {k: (tuple(d.shape), d.init)
           for k, d in attn.attn_defs(cfg, 1).items()}
    assert got == ref
    rc = RA.cache_defs(rcfg, 1, 3, 20)
    pc = attn.cache_defs(cfg, 1, 3, 20)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in rc.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
        for k, v in pc.items()}
