"""Feed-forward layers: the dense (gated / plain) MLP and the routed MoE.

The port of the JAX package's ``models/moe.py`` at tp = 1.  The MoE
(``moe.py:75-172``) routes each token to its top-k experts in float32,
packs the (token, k) pairs into an (E, C) dispatch buffer under a capacity
C, runs every expert as one batched product, and combines the experts'
outputs with the renormalised router weights; a pair past its expert's
capacity is dropped (the residual carries the token unchanged).  At tp = 1
the reference's two ``all_to_all`` exchanges (``moe.py:138,150``) are the
identity, so there are none.  The router's Switch-style load-balance loss
is returned beside the output.

The reference has no kernel here: its expert products are ``einsum``s, and
so are the port's (:func:`repro_torch.models.common.einsum`, which promotes
as JAX does).  The dispatch buffer is filled by a gather: every kept pair
owns one slot, so no slot is written twice and the buffer is the
reference's scatter-add into zeros, bit for bit, with no atomics.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import (ParamDef, ShardCtx, activation, einsum,
                                       matmul)


def mlp_defs(cfg: ModelConfig, tp: int,
             d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    shard_ff = cfg.tp_strategy in ("head", "seq")    # d_ff shards in both
    sh1 = (None, "model") if shard_ff else (None, None)
    sh0 = ("model", None) if shard_ff else (None, None)
    defs = {
        "w_in": ParamDef((d, ff), sh1),
        "w_out": ParamDef((ff, d), sh0),
    }
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((d, ff), sh1)
    return defs


def mlp_fwd(cfg: ModelConfig, ctx: ShardCtx, p: Dict,
            x: torch.Tensor) -> torch.Tensor:
    """x: (b, s, d) -> (b, s, d)."""
    h = matmul(x, p["w_in"])
    if cfg.gated_mlp:
        h = activation(cfg.act, h) * matmul(x, p["w_gate"])
    else:
        h = activation(cfg.act, h)
    return matmul(h, p["w_out"])


def moe_defs(cfg: ModelConfig, tp: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    m: MoEConfig = cfg.moe
    de = m.d_expert
    defs = {
        "router": ParamDef((d, m.n_experts), (None, None), scale=0.1),
        "w_in": ParamDef((m.n_experts, d, de), ("model", None, None)),
        "w_out": ParamDef((m.n_experts, de, d), ("model", None, None)),
    }
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((m.n_experts, d, de), ("model", None, None))
    if m.n_shared_experts:
        sh = {
            "w_in": ParamDef((d, m.d_shared), (None, "model")),
            "w_out": ParamDef((m.d_shared, d), ("model", None)),
        }
        if cfg.gated_mlp:
            sh["w_gate"] = ParamDef((d, m.d_shared), (None, "model"))
        defs["shared"] = sh
    return defs


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` of the router's probabilities (T, E): the k largest of
    each row in descending order, equal values lower expert first (a stable
    descending sort; ``torch.topk`` promises no order among ties).
    Returns (values (T, k), expert ids (T, k) int64)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def capacity(m: MoEConfig, tokens: int) -> int:
    """Slots an expert takes a forward: ceil(T K cf / E), at least 1."""
    return max(1, int(math.ceil(tokens * m.top_k * m.capacity_factor
                                / m.n_experts)))


def router_probs(p: Dict, xt: torch.Tensor) -> torch.Tensor:
    """The router's softmax over the experts, float32: xt (T, d) -> (T, E),
    the router (stored in the compute dtype) widened as the tokens are."""
    return torch.softmax(matmul(xt.float(), p["router"].float()), dim=-1)


def dispatch(m: MoEConfig, probs: torch.Tensor):
    """Routing and packing of T tokens' router probabilities (T, E).
    Returns (gate (T K,) the renormalised weights, expert (T K,) int64,
    keep (T K,) bool, slot (T K,) int64, C): pair (t, k) goes to slot
    ``expert C + rank`` where its rank among its expert's pairs, in token
    order, is below the capacity C; else it is dropped (slot E C, the
    overflow bin)."""
    T = probs.shape[0]
    E, K = m.n_experts, m.top_k
    gate_vals, expert_ids = route(probs, K)                   # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    C = capacity(m, T)
    flat_expert = expert_ids.reshape(-1)                      # (T K,)
    # rank of each (token, k) within its expert, in token order: the
    # reference's exclusive cumsum of a one-hot (T K, E), here as a stable
    # sort by expert (a pair's place in its expert's run) -- the same
    # integers, without a scan down E columns of T K rows
    order = torch.sort(flat_expert, stable=True).indices
    counts = torch.bincount(flat_expert, minlength=E)
    starts = torch.cumsum(counts, 0) - counts                 # (E,)
    rank_sorted = (torch.arange(flat_expert.numel(), device=probs.device)
                   - starts[flat_expert[order]])
    rank_in_e = torch.empty_like(rank_sorted).index_copy_(0, order,
                                                          rank_sorted)
    keep = rank_in_e < C
    slot = torch.where(keep, flat_expert * C + rank_in_e, E * C)
    return gate_vals.reshape(-1), flat_expert, keep, slot, C


def moe_fwd(cfg: ModelConfig, ctx: ShardCtx, p: Dict, x: torch.Tensor,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d).  Returns (y (b, s, d), aux loss 0-d float32)."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    T = b * s
    E, K = m.n_experts, m.top_k
    xt = x.reshape(T, d)

    # --- routing (float32) and dispatch packing -------------------------------
    probs = router_probs(p, xt)                               # (T, E)
    flat_gate, flat_expert, keep, slot, C = dispatch(m, probs)
    # Switch-style aux loss: E * sum_e f_e * p_e (f = fraction of the pairs)
    token_frac = torch.bincount(flat_expert, minlength=E).float() / (T * K)
    aux = E * torch.sum(token_frac * probs.mean(0))
    # each kept pair owns its slot; the rest land in the overflow bin E C,
    # which is dropped.  Each slot gathers its token's row (T: none, a zero
    # row)
    token_of_slot = torch.full((E * C + 1,), T, dtype=torch.long,
                               device=x.device)
    token_of_slot[slot] = torch.arange(T * K, device=x.device) // K
    xz = torch.cat([xt, xt.new_zeros((1, d))], 0)
    buf = xz[token_of_slot[:-1]].reshape(E, C, d)

    # --- experts ---------------------------------------------------------------
    h = einsum("ecd,edf->ecf", buf, p["w_in"])
    if cfg.gated_mlp:
        h = activation(cfg.act, h) * einsum("ecd,edf->ecf", buf, p["w_gate"])
    else:
        h = activation(cfg.act, h)
    out = einsum("ecf,efd->ecd", h, p["w_out"])
    del buf, h

    # --- combine -----------------------------------------------------------------
    out_flat = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))], 0)
    gathered = out_flat[slot]                                 # (T K, d)
    weighted = gathered * (flat_gate * keep).to(gathered.dtype)[:, None]
    y = weighted.reshape(T, K, d).sum(1).reshape(b, s, d)

    # --- shared experts: one dense MLP of their summed width -----------------------
    if m.n_shared_experts:
        y = y + mlp_fwd(cfg, ctx, p["shared"], x)
    return y, aux.float()

