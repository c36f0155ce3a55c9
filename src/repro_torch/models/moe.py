"""Feed-forward layers: the dense (gated / plain) MLP.

The port of the dense half of the JAX package's ``models/moe.py``
(``moe.py:32-72``) at tp = 1.  The expert-parallel MoE (``moe_defs``,
``moe_fwd``) comes with the MoE architectures (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, ShardCtx, activation, matmul


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


def moe_defs(cfg: ModelConfig, tp: int):
    raise NotImplementedError("the MoE feed-forward is not ported yet "
                              "(ROADMAP Queue 1 item 6)")


def moe_fwd(cfg: ModelConfig, ctx: ShardCtx, p: Dict, x: torch.Tensor):
    raise NotImplementedError("the MoE feed-forward is not ported yet "
                              "(ROADMAP Queue 1 item 6)")
