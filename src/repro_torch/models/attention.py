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

DeepSeek's multi-head latent attention (MLA, ``attention.py:141-153,
411-510``) takes the same two ways: its prefill expands the latent into 16
heads of q / k 192 wide (128 + 64 rotary) and v 128 wide and goes through
the flash hook (G = 1, dv != dh); its decode is the reference's absorbed
form, float32 einsums against the latent ring (``latent``, ``k_rope``,
``pos``), with no kernel, as in the reference.

The seq-TP layout and its distributed decode come with the mesh (ROADMAP
Queue 1 item 7).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models.common import (ParamDef, ShardCtx, TensorSpec,
                                       apply_rope, einsum, kv_eff_heads,
                                       matmul, rmsnorm, softcap)

NEG_INF = -1e30
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
        return mla_defs(cfg, tp)
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


def mla_defs(cfg: ModelConfig, tp: int) -> Dict[str, ParamDef]:
    m = cfg.mla
    d, hq = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    sh1 = (None, "model")
    return {
        "wq": ParamDef((d, hq * qd), sh1),
        "w_dkv": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                          (None, None)),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones"),
        "w_uk": ParamDef((m.kv_lora_rank, hq * m.qk_nope_head_dim), sh1),
        "w_uv": ParamDef((m.kv_lora_rank, hq * m.v_head_dim), sh1),
        "wo": ParamDef((hq * m.v_head_dim, d), ("model", None)),
    }


def cache_defs(cfg: ModelConfig, tp: int, batch_local: int,
               capacity: int) -> Dict[str, TensorSpec]:
    """Per-attention-layer KV cache.  ``capacity`` is the ring size
    (min(seq_len, window) for a windowed layer).  MLA's holds the latent
    and the rotary key, post-rope."""
    dt = getattr(torch, cfg.dtype)
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "latent": TensorSpec((batch_local, capacity, m.kv_lora_rank), dt),
            "k_rope": TensorSpec((batch_local, capacity, m.qk_rope_head_dim),
                                 dt),
            "pos": TensorSpec((batch_local, capacity), torch.int32),
        }
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
        return mla_fwd(cfg, ctx, p, x, window=window, cache=cache, pos=pos)
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
        _fill_ring(cache, {"k": k, "v": v}, positions)
    return y, cache


def _fill_ring(cache, new, k_pos):
    """Prefill: write the last ``capacity`` positions of each ``new[name]``
    (b, s, ...) into the ring ``cache[name]``, in place, and their positions
    into ``cache["pos"]``; every other slot is emptied."""
    capacity = cache["pos"].shape[1]
    b, s = next(iter(new.values())).shape[:2]
    take = min(s, capacity)
    slots = (k_pos[s - take:] % capacity).long()             # (take,)
    for name, t in new.items():
        cache[name].zero_()
        cache[name][:, slots] = t[:, s - take:].to(cache[name].dtype)
    cache["pos"].fill_(POS_SENTINEL)
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


# ---------------------------------------------------------------------------
# MLA forward (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_fwd(cfg: ModelConfig, ctx: ShardCtx, p: Dict, x: torch.Tensor, *,
            window: Optional[int], cache: Optional[Dict] = None,
            pos: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head latent attention, :func:`attn_fwd`'s two modes."""
    if pos is not None:
        return _mla_decode(cfg, ctx, p, x, window=window, cache=cache,
                           pos=pos)
    m = cfg.mla
    b, s, d = x.shape
    hq = cfg.n_heads
    nope, rope_d, vd, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                           m.v_head_dim, m.kv_lora_rank)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q = _split_heads(matmul(x, p["wq"]), hq, nope + rope_d)
    qn, qr = q[..., :nope], q[..., nope:]
    qr = apply_rope(qr, positions, cfg.rope_theta)
    dkv = matmul(x, p["w_dkv"])                              # (b, s, r+rope)
    latent = rmsnorm(dkv[..., :r], p["kv_norm"])
    k_rope = apply_rope(dkv[..., None, r:], positions,
                        cfg.rope_theta)                      # (b, s, 1, rope)
    kn = _split_heads(matmul(latent, p["w_uk"]), hq, nope)
    vv = _split_heads(matmul(latent, p["w_uv"]), hq, vd)
    k = torch.cat([kn, k_rope.expand(b, s, hq, rope_d)], -1)
    # GQA form: kv heads = hq, G = 1, v narrower than q / k
    qg = torch.cat([qn, qr], -1).reshape(b, s, hq, 1, nope + rope_d)
    # the reference calls the plain core here (attention.py:435); the port
    # goes through the flash hook, as for GQA
    o = attention_core_dispatch(qg, k, vv, positions, positions,
                                window=window, cap=cfg.attn_softcap)
    y = matmul(o.reshape(b, s, hq * vd), p["wo"])
    if cache is not None:
        _fill_ring(cache, {"latent": latent, "k_rope": k_rope[:, :, 0]},
                   positions)
    return y, cache


def _mla_decode(cfg, ctx, p, x, *, window, cache, pos):
    """Absorbed low-rank MLA decode: scores and values stay in latent
    space.  x: (b, 1, d); pos: (b,)."""
    m = cfg.mla
    b = x.shape[0]
    hq = cfg.n_heads
    nope, rope_d, vd, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                           m.v_head_dim, m.kv_lora_rank)
    q = _split_heads(matmul(x, p["wq"]), hq, nope + rope_d)  # (b, 1, h, qd)
    qn, qr = q[..., :nope], q[..., nope:]
    qr = apply_rope(qr, pos[:, None], cfg.rope_theta)
    dkv = matmul(x, p["w_dkv"])
    latent_new = rmsnorm(dkv[..., :r], p["kv_norm"])         # (b, 1, r)
    krope_new = apply_rope(dkv[..., None, r:], pos[:, None],
                           cfg.rope_theta)[:, :, 0]          # (b, 1, rope)

    slot = pos % cache["pos"].shape[1]
    lat_c = _ring_insert(cache["latent"], latent_new, slot)
    rope_c = _ring_insert(cache["k_rope"], krope_new, slot)
    pos_c = _ring_insert(cache["pos"], pos[:, None], slot)

    # absorb W_uk into q: (b, h, nope) x (r, h, nope) -> (b, h, r)
    w_uk = p["w_uk"].reshape(r, hq, nope)
    qlat = einsum("bhn,rhn->bhr", qn[:, 0].float(), w_uk.float())
    scale = 1.0 / math.sqrt(nope + rope_d)
    s_lat = einsum("bhr,bcr->bhc", qlat, lat_c.float())
    s_rope = einsum("bhd,bcd->bhc", qr[:, 0].float(), rope_c.float())
    s = softcap((s_lat + s_rope) * scale, cfg.attn_softcap)
    mask = pos_c[:, None, :] <= pos[:, None, None]
    if window is not None:
        mask &= pos_c[:, None, :] > (pos[:, None, None] - window)
    w = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o_lat = einsum("bhc,bcr->bhr", w, lat_c.float())         # (b, h, r)
    w_uv = p["w_uv"].reshape(r, hq, vd)
    o = einsum("bhr,rhv->bhv", o_lat, w_uv.float())
    o = o.reshape(b, 1, hq * vd).to(x.dtype)
    return matmul(o, p["wo"]), cache
