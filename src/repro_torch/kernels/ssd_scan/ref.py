"""Plain PyTorch version of the Mamba-2 SSD chunked scan (arXiv:2405.21060
§6), the port of the JAX package's ``ssd_scan/ref.py``.

The CPU path of :mod:`repro_torch.kernels.ssd_scan.ops` and the oracle the
CUDA kernel is held against.  It keeps the reference's dtype discipline,
because that is what the JAX model runs on the CPU: B and C stay at group
granularity; bulk tensors stay in the input dtype (bfloat16 in production)
and every einsum accumulates in float32 (``preferred_element_type``) before
its result is cast back; only the decay and cumsum bookkeeping and the
carried state are float32.  The CUDA kernel follows the TPU kernel's
all-float32 arithmetic instead, so in bfloat16 the two differ by rounding.
Left out: the reference's slicing of the batch when the score block would
pass ``max_score_bytes`` (``lax.map``), which changes memory, not values.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., l) -> (..., l, l) with out[m, s] = sum_{i=s+1..m} x_i (s<=m),
    -inf above the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.

    x:  (b, l, h, p)     inputs per head
    dt: (b, l, h)        discretization steps (post-softplus, f32)
    A:  (h,)             negative decay rates
    B:  (b, l, g, n)     input projections at group granularity (h % g == 0)
    C:  (b, l, g, n)     output projections
    Returns y (b, l, h, p) in x's dtype and final_state (b, h, p, n) f32.
    """
    b, l, h, p = x.shape
    g = B.shape[2]
    hg = h // g
    n = B.shape[-1]
    dt_c = x.dtype        # bulk compute dtype
    f32 = torch.float32

    l_orig = l
    if l % chunk:
        # zero-pad: dt=0 => decay=1 and zero input, so padded steps are no-ops
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        l = l + pad
    nc, cs_ = l // chunk, chunk

    xdt = (x.float() * dt.float()[..., None]).to(dt_c)                # dt·x
    dA = dt.float() * A.float()[None, None, :]                        # (b, l, h)

    xc = xdt.reshape(b, nc, cs_, h, p)
    Bc = B.to(dt_c).reshape(b, nc, cs_, g, n)
    Cc = C.to(dt_c).reshape(b, nc, cs_, g, n)
    dAc = dA.reshape(b, nc, cs_, h).permute(0, 3, 1, 2)               # (b, h, nc, cs)
    A_cum = torch.cumsum(dAc, dim=-1)                                 # f32

    # 1. intra-chunk (quadratic): group-level CBᵀ, head-level decay mask
    L = torch.exp(segsum(dAc)).to(dt_c)                               # (b, h, nc, m, s)
    cb = torch.einsum("bcmgn,bcsgn->bgcms", Cc.to(f32),
                      Bc.to(f32)).to(dt_c)                            # (b, g, nc, m, s)
    scores = (cb.reshape(b, g, 1, nc, cs_, cs_)
              * L.reshape(b, g, hg, nc, cs_, cs_)).reshape(b, h, nc, cs_, cs_)
    Y_diag = torch.einsum("bhcms,bcshp->bcmhp", scores.to(f32),
                          xc.to(f32)).to(dt_c)

    # 2. per-chunk output states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum).to(dt_c)       # (b, h, nc, cs)
    xdec = xc * decay_states.permute(0, 2, 3, 1)[..., None]          # (b,nc,cs,h,p)
    xdec_g = xdec.reshape(b, nc, cs_, g, hg, p)
    states = torch.einsum("bcsgn,bcsghp->bcghpn", Bc.to(f32),
                          xdec_g.to(f32))                             # f32
    states = states.reshape(b, nc, h, p, n)

    # 3. inter-chunk recurrence (sequential over chunks, f32 state)
    chunk_decay = torch.exp(A_cum[..., -1])                          # (b, h, nc) f32
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)                                           # state ENTERING chunk
        carry = states[:, c] + chunk_decay[..., c][..., None, None] * carry
    final_state = carry
    states_prev = torch.stack(prev, dim=1).to(dt_c)                  # (b, nc, h, p, n)

    # 4. inter-chunk contribution to outputs
    state_decay = torch.exp(A_cum).to(dt_c)                          # (b, h, nc, cs)
    Ch = Cc.reshape(b, nc, cs_, g, 1, n)
    sp = states_prev.reshape(b, nc, g, hg, p, n)
    Y_off = torch.einsum("bcmgon,bcghpn->bcmghp", Ch.to(f32),
                         sp.to(f32)).reshape(b, nc, cs_, h, p)
    Y_off = (Y_off * state_decay.permute(0, 2, 3, 1)[..., None]).to(dt_c)

    y = (Y_diag + Y_off).reshape(b, l, h, p)[:, :l_orig]
    return y.to(x.dtype), final_state


def ssd_step(h_state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.

    h_state: (b, h, p, n); x_t: (b, h, p); dt_t: (b, h); B_t/C_t: (b, h, n)
    Returns (y_t (b, h, p) in x_t's dtype, new_state f32).
    """
    dA = torch.exp(dt_t.float() * A.float()[None, :])                # (b, h)
    inp = dt_t.float()[..., None] * x_t.float()                      # (b, h, p)
    new = (h_state.float() * dA[..., None, None]
           + inp[..., None] * B_t.float()[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", new, C_t.float())
    return y.to(x_t.dtype), new


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 initial_state: Optional[torch.Tensor], dy: torch.Tensor,
                 dfinal: Optional[torch.Tensor] = None):
    """The plain version of the backward kernel: the vector-Jacobian product
    of :func:`ssd_chunked` by ``torch.autograd.grad``, computed in float32
    (every input cast first, as the kernel computes).  Returns (dx, ddt, dA,
    dB, dC, dinit): dx in x's dtype, dB and dC in B's, the rest float32;
    dinit is None without an initial state."""
    f32 = torch.float32
    with torch.enable_grad():
        ins = [t.detach().to(f32).requires_grad_(True)
               for t in (x, dt, A, B, C)]
        init = (None if initial_state is None else
                initial_state.detach().to(f32).requires_grad_(True))
        y, fin = ssd_chunked(*ins, chunk, initial_state=init)
        outs, seeds = [y], [dy.detach().to(f32)]
        if dfinal is not None:
            outs.append(fin)
            seeds.append(dfinal.detach().to(f32))
        wrt = ins + ([init] if init is not None else [])
        grads = torch.autograd.grad(outs, wrt, seeds, allow_unused=True)
    grads = [torch.zeros_like(w) if gr is None else gr
             for gr, w in zip(grads, wrt)]
    dx, ddt, dA, dB, dC = grads[:5]
    dinit = grads[5] if init is not None else None
    return (dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype), dinit)
