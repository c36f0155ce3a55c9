"""Plain PyTorch version of the RG-LRU linear recurrence (arXiv:2402.19427).

The CPU path of :mod:`repro_torch.kernels.rglru_scan.ops` and the oracle the
CUDA kernel is held against (``rglru`` run on the card, where its exp,
log1p and sqrt are the kernel's CUDA functions; ``linear_recurrence`` on
any device).  ``linear_recurrence`` walks time in order,
one step at a time, like the TPU kernel and the CUDA kernel, with the
product and the sum rounded separately (two float32 ops, no fused
multiply-add): the JAX package's oracle (``rglru_scan/ref.py``) takes an
associative scan instead, which rounds in another order.  The gate math
(``rglru_gates``) is the reference's line for line.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                      initial: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (batch, l, w); h_t = a_t h_{t-1} + b_t in float32, from
    ``initial`` (batch, w) or zeros.  Returns (h in b's dtype, h_last
    (batch, w) float32), h_last being the state after the last step."""
    a32, b32 = a.float(), b.float()
    bsz, l, w = b.shape
    h = (torch.zeros((bsz, w), dtype=torch.float32, device=b.device)
         if initial is None else initial.float().clone())
    out = torch.empty((bsz, l, w), dtype=torch.float32, device=b.device)
    for t in range(l):
        h = a32[:, t] * h
        h = h + b32[:, t]
        out[:, t] = h
    return out.to(b.dtype), h


def rglru_gates(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
                a_param: torch.Tensor, c: float = 8.0,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log a_t = -c softplus(Λ) r_t; returns (a_t, sqrt(1 - a_t²) (i_t x_t)),
    both float32 (b, l, w)."""
    log_a = -c * F.softplus(a_param.float())[None, None, :] * r_gate.float()
    a = torch.exp(log_a)
    a2 = torch.exp(2.0 * log_a)
    gated = (torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12))
             * (i_gate.float() * x.float()))
    return a, gated


def rglru(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
          a_param: torch.Tensor, initial: Optional[torch.Tensor] = None,
          c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over (b, l, w) inputs; returns (h in x's dtype, h_last)."""
    a, gated = rglru_gates(x, r_gate, i_gate, a_param, c)
    h, h_last = linear_recurrence(a, gated, initial=initial)
    return h.to(x.dtype), h_last


def rglru_step(h: torch.Tensor, x_t: torch.Tensor, r_t: torch.Tensor,
               i_t: torch.Tensor, a_param: torch.Tensor, c: float = 8.0,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step: h (b, w); x_t/r_t/i_t (b, w).  Returns
    (new state in x_t's dtype, new state in float32)."""
    log_a = -c * F.softplus(a_param.float())[None, :] * r_t.float()
    a = torch.exp(log_a)
    a2 = torch.exp(2.0 * log_a)
    gated = (torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12))
             * (i_t.float() * x_t.float()))
    new = a * h.float() + gated
    return new.to(x_t.dtype), new
