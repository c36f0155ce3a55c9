"""Optimizers from scratch: SGD, momentum, Adam (the port of the JAX
package's ``optim/optimizers.py``).

Each optimizer produces an *update* (the paper's ``u``) from gradients; the
sync layer (:func:`repro_torch.core.sync.apply_and_sync`) applies it
locally and decides when to synchronize.  Optimizer state is per replica,
like the parameters.  Trees are nested dicts and lists of tensors, as the
model's parameters are; every update is plain elementwise PyTorch on their
leaves, as the reference computes it outside any kernel.  The dtype rules
are the reference's: compute in the gradient's dtype, store in the moments'
dtype, bias corrections in float32 from the int32 count.  The count is an
int32 tensor on the host, so the bias corrections cost no device round
trip.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.models.common import tree_map

PyTree = Any


@dataclasses.dataclass
class OptState:
    mu: PyTree                    # first moment (momentum/adam) or empty
    nu: PyTree                    # second moment (adam) or empty
    count: torch.Tensor           # int32 step counter (host)


def init_opt_state(params: PyTree, kind: str, dtype=None) -> OptState:
    """``dtype``: storage dtype of the moments (bfloat16 halves their
    bytes); the count lives on the host."""
    def zeros():
        return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype,
                                              device=x.device), params)

    empty = tree_map(lambda x: torch.zeros((), dtype=x.dtype,
                                           device=x.device), params)
    count = torch.zeros((), dtype=torch.int32)
    if kind == "sgd":
        return OptState(mu=empty, nu=empty, count=count)
    if kind == "momentum":
        return OptState(mu=zeros(), nu=empty, count=count)
    if kind == "adam":
        return OptState(mu=zeros(), nu=zeros(), count=count)
    raise ValueError(f"unknown optimizer {kind!r}")


def sgd(grads: PyTree, state: OptState, lr, **_) -> Tuple[PyTree, OptState]:
    upd = tree_map(lambda g: -lr * g, grads)
    return upd, dataclasses.replace(state, count=state.count + 1)


def momentum(grads: PyTree, state: OptState, lr, beta: float = 0.9,
             **_) -> Tuple[PyTree, OptState]:
    mu = tree_map(lambda m, g: beta * m + g, state.mu, grads)
    upd = tree_map(lambda m: -lr * m, mu)
    return upd, dataclasses.replace(state, mu=mu, count=state.count + 1)


def adam(grads: PyTree, state: OptState, lr, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, params: PyTree = None,
         ) -> Tuple[PyTree, OptState]:
    cnt = state.count + 1
    t = cnt.to(torch.float32)
    # compute in the grad dtype (f32), store back in the moment dtype
    mu = tree_map(
        lambda m, g: (b1 * m.to(g.dtype) + (1 - b1) * g).to(m.dtype),
        state.mu, grads)
    nu = tree_map(
        lambda v, g: (b2 * v.to(g.dtype)
                      + (1 - b2) * torch.square(g)).to(v.dtype),
        state.nu, grads)
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)

    def u(m, v, p=None):
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        step = -(lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps))
        if weight_decay and p is not None:
            step = step - lr * weight_decay * p
        return step

    if weight_decay and params is not None:
        upd = tree_map(u, mu, nu, params)
    else:
        upd = tree_map(u, mu, nu)
    return upd, OptState(mu=mu, nu=nu, count=cnt)


def optimizer_update(kind: str) -> Callable:
    return {"sgd": sgd, "momentum": momentum, "adam": adam}[kind]
