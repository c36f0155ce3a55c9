"""Recurrent mixers: RG-LRU (RecurrentGemma) and Mamba-2 SSD blocks.

The port of the JAX package's ``models/recurrent.py`` at tp = 1.  Both
mixers have a full-sequence mode (prefill and training: the ``rglru_scan``
or ``ssd_scan`` kernel, differentiated on the card by its backward kernel)
and a single-token decode mode carrying a recurrent state cache (plain
``rglru_step`` / ``ssd_step``):
  RG-LRU : {h (b, w), conv (b, cw-1, w)}
  Mamba2 : {h (b, nh, hd, ds), conv (b, cw-1, w + 2·g·ds)}
Where a cache is given, it is written in place and returned (the reference
returns a new one; its serve step donates the old).

Dtypes follow JAX's promotion: where a leaf the compute-dtype cast left in
float32 (a 1-D leaf of a prefix or tail block: ``conv_b``, ``b_a``,
``b_i``) meets bfloat16 activations, the sum is float32 and stays float32
until an explicit cast, exactly as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.common import (ParamDef, ShardCtx, TensorSpec,
                                       activation, einsum, matmul)

RGLRU_NUM_BLOCKS = 16     # gate block-diagonal blocks (divides widths & tp)


def _store(cache: Dict, key: str, value: torch.Tensor) -> None:
    """Write ``value`` into the cache leaf in place, cast to its dtype."""
    cache[key].copy_(value)


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin recurrent block)
# ---------------------------------------------------------------------------


def rglru_defs(cfg: ModelConfig, tp: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    r = cfg.recurrent
    w = r.width
    nb = RGLRU_NUM_BLOCKS
    blk = w // nb
    shard = cfg.tp_strategy == "head"
    sh1 = (None, "model") if shard else (None, None)
    sh0 = ("model", None) if shard else (None, None)
    shb = ("model", None, None) if shard else (None, None, None)
    shv = ("model",) if shard else (None,)
    return {
        "w_x": ParamDef((d, w), sh1),
        "w_gate": ParamDef((d, w), sh1),
        "conv_w": ParamDef((r.conv_width, w),
                           (None, "model") if shard else (None, None),
                           scale=0.3),
        "conv_b": ParamDef((w,), shv, init="zeros"),
        "w_a": ParamDef((nb, blk, blk), shb),
        "b_a": ParamDef((w,), shv, init="zeros"),
        "w_i": ParamDef((nb, blk, blk), shb),
        "b_i": ParamDef((w,), shv, init="zeros"),
        "a_param": ParamDef((w,), shv, init="ones", scale=1.0),
        "w_out": ParamDef((w, d), sh0),
    }


def _block_linear(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: (..., nb*blk); w: (nb, blk, blk); b: (nb*blk,)."""
    nb, blk = w.shape[0], w.shape[1]
    xs = x.reshape(*x.shape[:-1], nb, blk)
    y = einsum("...nw,nwv->...nv", xs, w)
    return y.reshape(*x.shape[:-1], nb * blk) + b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: (b, l, c); w: (cw, c); state: (b, cw-1, c)."""
    cw = w.shape[0]
    pad = (torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :]
              for i in range(cw))
    return out + b


def rglru_fwd(cfg: ModelConfig, ctx: ShardCtx, p: Dict, x: torch.Tensor, *,
              cache: Optional[Dict] = None, pos: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (b, s, d).  Full mode (pos None) runs the whole sequence through
    the ``rglru_scan`` kernel and, with a cache, fills it; decode mode
    (pos (b,)) is a single step against the state cache."""
    cw = p["conv_w"].shape[0]
    if pos is None:
        gate = activation("gelu", matmul(x, p["w_gate"]))    # (b, s, w)
        raw = matmul(x, p["w_x"])                            # pre-conv inputs
        xb = _causal_conv(raw, p["conv_w"], p["conv_b"])
        r_g = torch.sigmoid(_block_linear(xb, p["w_a"], p["b_a"]))
        i_g = torch.sigmoid(_block_linear(xb, p["w_i"], p["b_i"]))
        h, h_last = rg_ops.rglru(xb, r_g, i_g, p["a_param"])
        y = matmul(gate * h, p["w_out"])
        if cache is not None:
            # conv state = last cw-1 raw inputs (pre-conv xb inputs)
            _store(cache, "h", h_last)
            _store(cache, "conv", raw[:, -(cw - 1):])
        return y, cache

    # ---- decode ----
    gate = activation("gelu", matmul(x, p["w_gate"]))        # (b, 1, w)
    raw = matmul(x, p["w_x"])                                # (b, 1, w)
    conv_in = torch.cat([cache["conv"].to(raw.dtype), raw], dim=1)
    xb = einsum("btc,tc->bc", conv_in[:, -cw:], p["conv_w"]) + p["conv_b"]
    r_g = torch.sigmoid(_block_linear(xb, p["w_a"], p["b_a"]))
    i_g = torch.sigmoid(_block_linear(xb, p["w_i"], p["b_i"]))
    _, h_new = rg_ops.rglru_step(cache["h"], xb, r_g, i_g, p["a_param"])
    y = matmul(gate[:, 0] * h_new.to(gate.dtype), p["w_out"])
    _store(cache, "h", h_new)
    _store(cache, "conv", conv_in[:, -(cw - 1):])
    return y[:, None, :], cache


def rglru_cache_defs(cfg: ModelConfig, tp: int, batch_local: int,
                     ) -> Dict[str, TensorSpec]:
    r = cfg.recurrent
    w_loc = r.width // tp if cfg.tp_strategy == "head" else r.width
    dt = getattr(torch, cfg.dtype)
    return {
        "h": TensorSpec((batch_local, w_loc), torch.float32),
        "conv": TensorSpec((batch_local, r.conv_width - 1, w_loc), dt),
    }


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------


def mamba2_defs(cfg: ModelConfig, tp: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    r = cfg.recurrent
    w = r.width
    nh = w // r.head_dim
    gs = r.n_groups * r.d_state
    conv_dim = w + 2 * gs
    return {
        # in_proj order: [z (w) | x (w) | B (gs) | C (gs) | dt (nh)]
        "w_in": ParamDef((d, 2 * w + 2 * gs + nh), (None, None)),
        "conv_w": ParamDef((r.conv_width, conv_dim), (None, None), scale=0.3),
        "conv_b": ParamDef((conv_dim,), (None,), init="zeros"),
        "A_log": ParamDef((nh,), (None,), init="ones"),
        "D": ParamDef((nh,), (None,), init="ones"),
        "dt_bias": ParamDef((nh,), (None,), init="zeros"),
        "norm": ParamDef((w,), (None,), init="ones"),
        "w_out": ParamDef((w, d), (None, None)),
    }


def _mamba_split(cfg, h):
    r = cfg.recurrent
    w = r.width
    gs = r.n_groups * r.d_state
    nh = w // r.head_dim
    z = h[..., :w]
    xBC = h[..., w:w + w + 2 * gs]
    dt = h[..., w + w + 2 * gs:]
    return z, xBC, dt, w, gs, nh


def mamba2_fwd(cfg: ModelConfig, ctx: ShardCtx, p: Dict, x: torch.Tensor, *,
               cache: Optional[Dict] = None, pos: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (b, s, d), the full sequence (the replicated strategy).  Full mode
    runs the ``ssd_scan`` kernel; decode mode is one ``ssd_step``."""
    if cfg.tp_strategy == "seq_ssm" and pos is None:
        return _mamba2_fwd_seqpar(cfg, ctx, p, x, cache=cache)

    r = cfg.recurrent
    hd, ds, ng = r.head_dim, r.d_state, r.n_groups
    proj = matmul(x, p["w_in"])
    z, xBC, dt_raw, w, gs, nh = _mamba_split(cfg, proj)
    rep = nh // ng
    cw = p["conv_w"].shape[0]

    if pos is None:
        b, s, _ = x.shape
        xBC = activation("silu", _causal_conv(xBC, p["conv_w"], p["conv_b"]))
        xs = xBC[..., :w].reshape(b, s, nh, hd)
        B = xBC[..., w:w + gs].reshape(b, s, ng, ds)         # group granularity
        C = xBC[..., w + gs:].reshape(b, s, ng, ds)
        dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())
        y, state = ssd_ops.ssd_scan(xs, dt, A, B, C,
                                    chunk=min(r.chunk_size, s))
        y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
        y = y.reshape(b, s, w)
        y = _gated_rmsnorm(y, z, p["norm"])                  # gated RMSNorm
        out = matmul(y, p["w_out"])
        if cache is not None:
            _store(cache, "h", state)
            _store(cache, "conv", xBC_raw_tail(proj, cfg, cw))
        return out, cache

    # ---- decode: single token ----
    b = x.shape[0]
    raw = xBC[:, 0]                                          # (b, conv_dim)
    conv_in = torch.cat([cache["conv"].to(raw.dtype), raw[:, None]], dim=1)
    xBC1 = einsum("btc,tc->bc", conv_in[:, -cw:], p["conv_w"]) + p["conv_b"]
    xBC1 = activation("silu", xBC1)
    xs = xBC1[:, :w].reshape(b, nh, hd)
    B = torch.repeat_interleave(xBC1[:, w:w + gs].reshape(b, ng, ds), rep,
                                dim=1)
    C = torch.repeat_interleave(xBC1[:, w + gs:].reshape(b, ng, ds), rep,
                                dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, h_new = ssd_ops.ssd_step(cache["h"].float(), xs, dt, A, B, C)
    y = y + xs * p["D"].to(y.dtype)[None, :, None]
    y = y.reshape(b, 1, w)
    y = _gated_rmsnorm(y, z, p["norm"])
    out = matmul(y, p["w_out"])
    _store(cache, "h", h_new)
    _store(cache, "conv", conv_in[:, -(cw - 1):])
    return out, cache


def _mamba2_fwd_seqpar(cfg: ModelConfig, ctx: ShardCtx, p: Dict,
                       x: torch.Tensor, *, cache=None):
    raise NotImplementedError(
        "the sequence-parallel SSD (tp_strategy 'seq_ssm') needs a model "
        "axis: it comes with the mesh (ROADMAP Queue 1 item 7)")


def xBC_raw_tail(proj: torch.Tensor, cfg: ModelConfig,
                 cw: int) -> torch.Tensor:
    """Last cw-1 pre-conv xBC inputs (the decode conv state)."""
    r = cfg.recurrent
    w = r.width
    gs = r.n_groups * r.d_state
    xBC = proj[..., w:w + w + 2 * gs]
    return xBC[:, -(cw - 1):]


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    g = y.float() * F.silu(z.float())
    var = torch.mean(torch.square(g), dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + 1e-6) * scale.float()).to(y.dtype)


def mamba2_cache_defs(cfg: ModelConfig, tp: int, batch_local: int,
                      ) -> Dict[str, TensorSpec]:
    r = cfg.recurrent
    w = r.width
    nh = w // r.head_dim
    gs = r.n_groups * r.d_state
    dt = getattr(torch, cfg.dtype)
    return {
        "h": TensorSpec((batch_local, nh, r.head_dim, r.d_state),
                        torch.float32),
        "conv": TensorSpec((batch_local, r.conv_width - 1, w + 2 * gs), dt),
    }
