"""Plain PyTorch version of the flash-attention kernel: dense masked
attention in float32, the port of the JAX package's
``flash_attention/ref.py::attention``.

The CPU path of :mod:`repro_torch.kernels.flash_attention.ops` and the
oracle the CUDA kernels are held against: ``attention`` for the forward,
``attention_lse`` for the rows' log-sum-exp it writes for its backward,
and ``attention_bwd``, the backward's explicit formulas.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _logits(q, k, q_pos, k_pos, window, cap):
    """(s, t, m): the logits (b, kvh, G, sq, skv) in float32 after the scale
    and the softcap, tanh(raw / cap) where capped (else None), and the
    mask."""
    b, sq = q.shape[:2]
    skv = k.shape[1]
    if q_pos.dim() == 1:
        q_pos = q_pos[None].expand(b, sq)
    if k_pos.dim() == 1:
        k_pos = k_pos[None].expand(b, skv)
    q_pos, k_pos = q_pos.long(), k_pos.long()
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    t = None
    if cap is not None:
        t = torch.tanh(s / cap)
        s = t * cap
    m = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
    if window is not None:
        m &= k_pos[:, None, None, None, :] > (q_pos[:, None, None, :, None]
                                             - window)
    return s, t, m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor,
              window: Optional[int] = None,
              cap: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, kvh, G, dh); k, v: (b, skv, kvh, dh_{k,v});
    q_pos: (b, sq) or (sq,); k_pos: (b, skv) or (skv,).  The mask is
    ``(k_pos <= q_pos) & (k_pos > q_pos - window)``; a row with no key left
    gives 0.  Returns (b, sq, kvh, G, dv) in q's dtype."""
    s, _, m = _logits(q, k, q_pos, k_pos, window, cap)
    s = torch.where(m, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    w = torch.where(m.any(-1, keepdim=True), w, 0.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.to(q.dtype)


def attention_lse(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor,
                  k_pos: torch.Tensor, window: Optional[int] = None,
                  cap: Optional[float] = None) -> torch.Tensor:
    """The row log-sum-exp of :func:`attention`'s masked logits, float32
    (b, kvh, G, sq); +inf for a row with no key, so that exp(s - lse) is 0
    there."""
    s, _, m = _logits(q, k, q_pos, k_pos, window, cap)
    lse = torch.logsumexp(torch.where(m, s, -math.inf), dim=-1)
    return torch.where(m.any(-1), lse, math.inf)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  window: Optional[int], cap: Optional[float],
                  do: torch.Tensor):
    """The vector-Jacobian product of :func:`attention`: given do (b, sq,
    kvh, G, dv), returns (dq, dk, dv) in q's dtype, computed in float32 by
    the explicit formulas: P the masked softmax (0 on a row with no key),
    dP = dO V^T, D = rowsum(P ∘ dP) (= rowsum(dO ∘ O) with O in float32),
    dS = P ∘ (dP - D), times 1 - tanh²(raw / cap) under a softcap, then dq
    = scale dS K, dk = scale dS^T Q (summed over the G heads), dv = P^T
    dO."""
    s, t, m = _logits(q, k, q_pos, k_pos, window, cap)
    p = torch.softmax(torch.where(m, s, NEG_INF), dim=-1)
    p = torch.where(m.any(-1, keepdim=True), p, 0.0)
    do32 = do.float()
    dp = torch.einsum("bqkgd,bskd->bkgqs", do32, v.float())
    dsum = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - dsum)
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * (1.0 / math.sqrt(q.shape[-1]))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float())
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do32)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
