"""Plain PyTorch version of the flash-attention kernel: dense masked
attention in float32, the port of the JAX package's
``flash_attention/ref.py::attention``.

The CPU path of :mod:`repro_torch.kernels.flash_attention.ops` and the
oracle the CUDA kernel is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor,
              window: Optional[int] = None,
              cap: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, kvh, G, dh); k, v: (b, skv, kvh, dh_{k,v});
    q_pos: (b, sq) or (sq,); k_pos: (b, skv) or (skv,).  The mask is
    ``(k_pos <= q_pos) & (k_pos > q_pos - window)``; a row with no key left
    gives 0.  Returns (b, sq, kvh, G, dv) in q's dtype."""
    b, sq = q.shape[:2]
    skv = k.shape[1]
    if q_pos.dim() == 1:
        q_pos = q_pos[None].expand(b, sq)
    if k_pos.dim() == 1:
        k_pos = k_pos[None].expand(b, skv)
    q_pos, k_pos = q_pos.long(), k_pos.long()
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    m = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
    if window is not None:
        m &= k_pos[:, None, None, None, :] > (q_pos[:, None, None, :, None]
                                             - window)
    s = torch.where(m, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    w = torch.where(m.any(-1, keepdim=True), w, 0.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.to(q.dtype)
