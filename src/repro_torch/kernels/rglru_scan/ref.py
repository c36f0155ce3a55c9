"""Plain PyTorch version of the RG-LRU linear recurrence (arXiv:2402.19427).

The CPU path of :mod:`repro_torch.kernels.rglru_scan.ops` and the oracle the
CUDA kernel is held against (``rglru`` run on the card, where its exp,
log1p and sqrt are the kernel's CUDA functions; ``linear_recurrence`` on
any device).  ``linear_recurrence`` walks time in order,
one step at a time, like the TPU kernel and the CUDA kernel, with the
product and the sum rounded separately (two float32 ops, no fused
multiply-add): the JAX package's oracle (``rglru_scan/ref.py``) takes an
associative scan instead, which rounds in another order.  The gate math
(``rglru_gates``) is the reference's line for line.  ``rglru_bwd`` and
``linear_recurrence_bwd`` are the backward kernels' plain versions: the
state recomputed with ``linear_recurrence``'s loop, then an explicit
reverse sweep in float32 (autograd through the loop's per-step writes
is too slow at the train shape to serve as the card's plain version).
``linear_recurrence_states`` / ``rglru_states`` are the plain versions of
the states the forward kernel writes for the backward: the loop's float32
state entering every chunk of steps.
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


def _reverse_sweep(a: torch.Tensor, dh: Optional[torch.Tensor],
                   dh_last: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g_t = dh_t + a_{t+1} g_{t+1} over (batch, l, w) in float32, seeded
    with ``dh_last`` (the cotangent of h_last = h_{l-1}); either cotangent
    may be None (zeros).  Returns (g (batch, l, w), a_0 g_0 (batch, w): the
    cotangent of the initial state)."""
    bsz, l, w = a.shape
    carry = (torch.zeros((bsz, w), dtype=torch.float32, device=a.device)
             if dh_last is None else dh_last.float().clone())
    g = torch.empty((bsz, l, w), dtype=torch.float32, device=a.device)
    dh32 = None if dh is None else dh.float()
    for t in range(l - 1, -1, -1):
        g_t = carry if dh32 is None else dh32[:, t] + carry
        g[:, t] = g_t
        carry = a[:, t] * g_t
    return g, carry


def _states_before(a: torch.Tensor, b: torch.Tensor,
                   initial: Optional[torch.Tensor]) -> torch.Tensor:
    """s_{t-1} for every step t, float32 (batch, l, w): the initial state
    (or zeros), then the forward's own states (``linear_recurrence``'s loop,
    so the same bits)."""
    s, _ = linear_recurrence(a, b, initial)
    first = (torch.zeros_like(s[:, :1]) if initial is None
             else initial.float()[:, None])
    return torch.cat([first, s[:, :-1]], dim=1)


def linear_recurrence_states(a: torch.Tensor, b: torch.Tensor,
                             initial: Optional[torch.Tensor] = None,
                             chunk: int = 32) -> torch.Tensor:
    """The float32 state entering every ``chunk`` steps, (batch, ceil(l /
    chunk), w): s_{kc-1} for chunk k (the initial state or zeros for the
    first), from ``linear_recurrence``'s loop."""
    if a.shape[1] == 0:
        return torch.empty((a.shape[0], 0, a.shape[2]), dtype=torch.float32,
                           device=a.device)
    return _states_before(a.float(), b.float(),
                          initial)[:, ::chunk].contiguous()


def rglru_states(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
                 a_param: torch.Tensor, initial: Optional[torch.Tensor] = None,
                 c: float = 8.0, chunk: int = 32) -> torch.Tensor:
    """:func:`linear_recurrence_states` of :func:`rglru`'s recurrence."""
    a, gated = rglru_gates(x, r_gate, i_gate, a_param, c)
    return linear_recurrence_states(a, gated, initial, chunk)


def linear_recurrence_bwd(a: torch.Tensor, b: torch.Tensor,
                          initial: Optional[torch.Tensor],
                          dh: Optional[torch.Tensor],
                          dh_last: Optional[torch.Tensor] = None):
    """The vector-Jacobian product of :func:`linear_recurrence`: given dh
    (batch, l, w) and dh_last (batch, w) (either may be None), returns (da,
    db, dinitial): da in a's dtype, db in b's, dinitial float32 (None
    without an initial state).  An explicit reverse sweep in float32:
    da_t = g_t s_{t-1}, db_t = g_t, dinitial = a_0 g_0."""
    a32 = a.float()
    if a.shape[1] == 0:
        dinit = (None if initial is None else torch.zeros_like(
            initial, dtype=torch.float32) if dh_last is None
                 else dh_last.float().clone())
        return torch.zeros_like(a), torch.zeros_like(b), dinit
    prev = _states_before(a32, b.float(), initial)
    g, dinit = _reverse_sweep(a32, dh, dh_last)
    return ((g * prev).to(a.dtype), g.to(b.dtype),
            None if initial is None else dinit)


def rglru_bwd(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
              a_param: torch.Tensor, initial: Optional[torch.Tensor],
              dh: Optional[torch.Tensor],
              dh_last: Optional[torch.Tensor] = None, c: float = 8.0):
    """The vector-Jacobian product of :func:`rglru`: given dh (b, l, w) in
    h's dtype and dh_last (b, w) float32 (either may be None), returns (dx,
    dr, di, da_param, dinitial), the first four in their inputs' dtypes,
    dinitial float32 (None without an initial state).

    In float32: the state recomputed with the forward's loop, g_t = dh_t +
    a_{t+1} g_{t+1} seeded with dh_last, then the gates' chain in the order
    autograd takes it through :func:`rglru_gates`: d(ix) = g sqrt(keep);
    dkeep = g (i x) / (2 sqrt(keep)) where 1 - a² >= 1e-12 (torch's
    ``clamp_min`` passes the gradient at the tie), else 0; dlog_a = g
    s_{t-1} a - 2 dkeep a²; dr = dlog_a (-c softplus(Λ)); dΛ = dsp z /
    (z + 1) with z = exp(Λ) and dsp = -c Σ_{b,t} dlog_a r (softplus's
    threshold: dsp itself above 20)."""
    a, gated = rglru_gates(x, r_gate, i_gate, a_param, c)
    lam = a_param.float()
    nsp = -c * F.softplus(lam)
    r32, i32, x32 = r_gate.float(), i_gate.float(), x.float()
    if x.shape[1] == 0:              # no step: the state passes through
        prev = g = torch.zeros_like(a)
        dinit = (torch.zeros((a.shape[0], a.shape[2]), device=a.device)
                 if dh_last is None else dh_last.float().clone())
    else:
        prev = _states_before(a, gated, initial)
        g, dinit = _reverse_sweep(a, dh, dh_last)
    log_a = nsp[None, None, :] * r32
    a2 = torch.exp(2.0 * log_a)
    keep_raw = 1.0 - a2
    sq = torch.sqrt(torch.clamp_min(keep_raw, 1e-12))
    ix = i32 * x32
    dix = g * sq
    dkeep = torch.where(keep_raw >= 1e-12, (g * ix) / (2.0 * sq), 0.0)
    dlog_a = (g * prev) * a + 2.0 * (-dkeep * a2)
    dsp = -c * (dlog_a * r32).sum((0, 1))
    z = torch.exp(lam)
    dlam = torch.where(lam > 20.0, dsp, dsp * z / (z + 1.0))
    return ((dix * i32).to(x.dtype), (dlog_a * nsp).to(r_gate.dtype),
            (dix * x32).to(i_gate.dtype), dlam.to(a_param.dtype),
            None if initial is None else dinit)


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
