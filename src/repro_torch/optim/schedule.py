"""Learning-rate schedules: pure functions of the int32 step (a host
tensor), each returning a 0-d float32 tensor on the host (the port of the
JAX package's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def linear_warmup(lr: float, warmup: int, base):
    base_fn = base

    def fn(step):
        t = torch.as_tensor(step).to(_F32)
        scale = torch.clamp((t + 1.0) / max(warmup, 1), max=1.0)
        return scale * base_fn(step)
    return fn


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(torch.as_tensor(step).to(_F32) / max(total_steps, 1),
                        0.0, 1.0)
        return (lr * (final_frac + (1 - final_frac) * 0.5
                      * (1 + torch.cos(math.pi * t)))).to(_F32)
    return fn


def sqrt_decay(sigma: float):
    """The paper's Theorem-1 step size eta_t = sigma / sqrt(t) (t is
    1-based)."""
    def fn(step):
        return (torch.tensor(sigma, dtype=_F32)
                / torch.sqrt(torch.as_tensor(step).to(_F32) + 1.0))
    return fn
