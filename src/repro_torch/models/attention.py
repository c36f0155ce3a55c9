"""Attention: GQA at tp = 1 with sliding windows and ring KV caches.

The port of the JAX package's ``models/attention.py`` (``:41-380``) for one
card.  Prefill and decode compute the same masked attention two ways:

* prefill and training call ``attention_core_dispatch``, the hook the
  reference declares for the flash kernel (``attention.py:102``) and never
  calls; on a CUDA tensor it runs the hand-written flash kernel, and its
  backward kernel under autograd.
* decode keeps the reference's plain core (``attention_core``, called at
  ``attention.py:372``): each request carries its own ``(b, 1)`` query
  position against the ring's ``(b, C)`` key positions, and the flash
  kernel takes only positions shared by the batch.  At one query row the
  reference's chunking and banding never run, so that core is the flash
  kernel's plain version, dense masked float32 attention, which decode
  calls directly.

MLA, the seq-TP layout and its distributed decode come with the other
architectures and the mesh (ROADMAP Queue 1 items 6-7).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models.common import (ParamDef, ShardCtx, TensorSpec,
                                       apply_rope, kv_eff_heads, matmul)

POS_SENTINEL = 2**30    # k-slot "empty" marker (always masked out)


# ---------------------------------------------------------------------------
# Flash hook
# ---------------------------------------------------------------------------


def attention_core_dispatch(*args, **kw):
    """The flash-attention hook: the port's hand-written kernel on a CUDA
    tensor (its plain version on a CPU tensor)."""
    return fa_ops.flash_attention(*args, **kw)


# ---------------------------------------------------------------------------
# Parameter and cache definitions
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig, tp: int) -> Dict[str, ParamDef]:
    d, hq, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    if cfg.mla is not None:
        raise NotImplementedError("MLA is not ported yet (ROADMAP Queue 1 "
                                  "item 6)")
    head_tp = cfg.tp_strategy == "head"
    sh1 = (None, "model") if head_tp else (None, None)
    sh0 = ("model", None) if head_tp else (None, None)
    kv_eff, rep = (kv_eff_heads(cfg.n_kv_heads, tp) if head_tp
                   else (cfg.n_kv_heads, 1))
    if rep > 1:
        raise NotImplementedError("duplicated kv heads arise at tp > n_kv: "
                                  "they come with the mesh (ROADMAP Queue 1 "
                                  "item 7)")
    defs = {
        "wq": ParamDef((d, hq * dh), sh1),
        "wk": ParamDef((d, kv_eff * dh), sh1),
        "wv": ParamDef((d, kv_eff * dh), sh1),
        "wo": ParamDef((hq * dh, d), sh0),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((dh,), (None,), init="ones")
        defs["k_norm"] = ParamDef((dh,), (None,), init="ones")
    return defs


def cache_defs(cfg: ModelConfig, tp: int, batch_local: int,
               capacity: int) -> Dict[str, TensorSpec]:
    """Per-attention-layer KV cache.  ``capacity`` is the ring size
    (min(seq_len, window) for a windowed layer)."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA is not ported yet (ROADMAP Queue 1 "
                                  "item 6)")
    dt = getattr(torch, cfg.dtype)
    kv, dh = cfg.n_kv_heads, cfg.d_head
    return {
        "k": TensorSpec((batch_local, capacity, kv, dh), dt),
        "v": TensorSpec((batch_local, capacity, kv, dh), dt),
        "pos": TensorSpec((batch_local, capacity), torch.int32),
    }


# ---------------------------------------------------------------------------
# GQA forward
# ---------------------------------------------------------------------------


def _split_heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def _qk_normalize(x, scale):
    """Qwen3/OLMoE-style per-head RMS norm over the head dim."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), -1, keepdim=True) + 1e-6)
    return (x * scale.float()).to(dt)


def attn_fwd(cfg: ModelConfig, ctx: ShardCtx, p: Dict, x: torch.Tensor, *,
             window: Optional[int], cache: Optional[Dict] = None,
             pos: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (b, s, d).  Two modes:
       * full (pos None): prefill over the whole sequence; if ``cache`` is
         given, it is filled in place with the last ``capacity`` k/v.
       * decode (pos (b,)): single new token against the cache, which is
         updated in place.
    Returns (y (b, s, d), cache)."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA is not ported yet (ROADMAP Queue 1 "
                                  "item 6)")
    if pos is None:
        return _gqa_full(cfg, ctx, p, x, window=window, cache=cache)
    return _gqa_decode(cfg, ctx, p, x, window=window, cache=cache, pos=pos)


def _gqa_full(cfg, ctx, p, x, *, window, cache):
    b, s, d = x.shape
    dh = cfg.d_head
    hq, kv = cfg.n_heads, cfg.n_kv_heads
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q = _split_heads(matmul(x, p["wq"]), hq, dh)
    k = _split_heads(matmul(x, p["wk"]), kv, dh)
    v = _split_heads(matmul(x, p["wv"]), kv, dh)
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
        k = _qk_normalize(k, p["k_norm"])
    k = apply_rope(k, positions, cfg.rope_theta)
    q = apply_rope(q, positions, cfg.rope_theta)

    G = hq // kv
    qg = q.reshape(b, s, kv, G, dh)
    # the reference calls the plain core here (attention.py:274); the port
    # goes through the flash hook, so the kernel carries the prefill
    o = attention_core_dispatch(qg, k, v, positions, positions,
                                window=window, cap=cfg.attn_softcap)
    y = matmul(o.reshape(b, s, hq * dh), p["wo"])
    if cache is not None:
        _fill_cache_from_full(cache, k, v, positions)
    return y, cache


def _fill_cache_from_full(cache, k, v, k_pos):
    """Prefill: write the last ``capacity`` keys into the ring cache, in
    place; every other slot is emptied."""
    capacity = cache["pos"].shape[1]
    s = k.shape[1]
    take = min(s, capacity)
    slots = (k_pos[s - take:] % capacity).long()             # (take,)
    b = k.shape[0]
    cache["k"].zero_()
    cache["v"].zero_()
    cache["pos"].fill_(POS_SENTINEL)
    cache["k"][:, slots] = k[:, s - take:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, s - take:].to(cache["v"].dtype)
    cache["pos"][:, slots] = k_pos[s - take:][None].expand(b, take)


def _ring_insert(cache_arr, new, slot):
    """cache (b, C, …); new (b, 1, …); slot (b,) — write slot[i] of row i,
    in place."""
    rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    cache_arr[rows, slot.long()] = new[:, 0].to(cache_arr.dtype)
    return cache_arr


def _gqa_decode(cfg, ctx, p, x, *, window, cache, pos):
    """x: (b, 1, d); pos: (b,) absolute position of the new token."""
    b = x.shape[0]
    dh = cfg.d_head
    hq, kv = cfg.n_heads, cfg.n_kv_heads
    q = _split_heads(matmul(x, p["wq"]), hq, dh)             # (b, 1, hq, dh)
    k_new = _split_heads(matmul(x, p["wk"]), kv, dh)
    v_new = _split_heads(matmul(x, p["wv"]), kv, dh)
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
        k_new = _qk_normalize(k_new, p["k_norm"])
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)

    slot = pos % cache["pos"].shape[1]                       # (b,)
    kc = _ring_insert(cache["k"], k_new, slot)
    vc = _ring_insert(cache["v"], v_new, slot)
    pc = _ring_insert(cache["pos"], pos[:, None], slot)
    G = hq // kv
    qg = q.reshape(b, 1, kv, G, dh)
    # the reference's attention_core (attention.py:372); at one query row
    # its chunking never runs, so it is the flash kernel's plain version
    o = fa_ref.attention(qg, kc, vc, pos[:, None], pc,
                         window=window, cap=cfg.attn_softcap)
    y = matmul(o.reshape(b, 1, hq * dh), p["wo"])
    return y, cache
