"""Shared model machinery: shard context, parameter specs, norms, RoPE.

The port of the JAX package's ``models/common.py`` for serving at tensor
parallel degree 1 on one card.  Parameter handling keeps its one source of
truth: the ``*_defs`` functions return a tree (nested dicts and lists) of
:class:`ParamDef` (shape + sharded dims + init rule), and
:func:`instantiate_tree` draws the tensors from a seeded ``torch.Generator``
with the same init rules as the reference (truncated normal at ±3σ with
fan-in std, ``embed``, ``zeros``, ``ones``).  A ``torch.Generator`` and a
``jax.random`` key give different numbers from one seed, so the parity
tests carry the JAX package's drawn tree across instead
(:func:`repro_torch.convert.model_params_from_reference`).

:class:`ShardCtx` exists so that the model code reads like the reference's;
at tp = 1 it has no model axis and every collective is the identity.  A
mesh (tp > 1) is ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


# ---------------------------------------------------------------------------
# Trees (nested dicts / lists)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> PyTree:
    """``fn`` over the leaves of a tree of dicts and lists, keeping its
    structure; with ``rest``, trees of the same structure whose leaves are
    passed beside the first's."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_paths(fn: Callable, tree: PyTree, sep: str = "/") -> PyTree:
    """``fn(path, leaf)`` over the leaves of a tree, keeping its structure;
    each path as :func:`tree_paths` names it."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(t)]
        return fn(sep.join(path), t)
    return walk(tree, ())


def tree_leaves(tree: PyTree, is_leaf: Optional[Callable[[Any], bool]] = None
                ) -> list:
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def tree_paths(tree: PyTree, sep: str = "/") -> Dict[str, Any]:
    """``{path: leaf}`` of a tree of dicts and lists: each path the keys and
    list indices joined by ``sep``, dict keys in sorted order (the order
    ``jax.tree_util`` flattens a dict in), so that the paths and their order
    are the JAX package's.  The leaves are the tree's own (views, for
    tensors)."""
    out: Dict[str, Any] = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            out[sep.join(path)] = t
    walk(tree, ())
    return out


# ---------------------------------------------------------------------------
# Shard context
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardCtx:
    """The reference's mesh context at tp = 1, the only degree the port
    runs: every collective of the reference's ``ShardCtx`` is the identity
    there, so the port's model code calls none and reads no field.  The two
    fields exist only to refuse a model axis."""

    model_axis: Optional[str] = None     # tensor-parallel axis name
    tp: int = 1                          # size of the model axis

    def __post_init__(self):
        if self.model_axis is not None or self.tp != 1:
            raise NotImplementedError(
                "the port's models run at tp = 1; a model axis comes with "
                "the mesh (ROADMAP Queue 1 item 7)")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: global shape + sharding + init rule."""

    shape: Tuple[int, ...]
    shard: Tuple[Optional[str], ...] = ()    # per-dim mesh axis (or None)
    init: str = "fan_in"                     # fan_in | zeros | ones | embed
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.shard and len(self.shard) != len(self.shape):
            raise ValueError(f"shard {self.shard} vs shape {self.shape}")

    def instantiate(self, generator: torch.Generator,
                    device) -> torch.Tensor:
        kw = dict(dtype=self.dtype, device=device)
        if self.init == "zeros":
            return torch.zeros(self.shape, **kw)
        if self.init == "ones":
            return torch.ones(self.shape, **kw)
        if self.init == "embed":
            t = torch.empty(self.shape, **kw).normal_(generator=generator)
            return t.mul_(self.scale)
        if self.init == "fan_in":
            # fan-in = the matmul input dim (second-to-last; robust to
            # scan-stacked leading dims)
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            std = self.scale / math.sqrt(max(fan_in, 1))
            t = torch.empty(self.shape, **kw)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0,
                                        generator=generator)
            return t.mul_(std)
        raise ValueError(f"unknown init {self.init!r}")


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor not made yet (a cache leaf): the port's
    ``jax.ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def compute_cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The reference's compute-dtype rule (``models/model.py:272-273``):
    a float32 leaf with more than one dimension goes to ``dtype``, every
    other leaf stays as it is.  A scan-stacked 1-D leaf has two dimensions,
    so it is cast too; a prefix or tail block's 1-D leaf stays float32."""
    if t.dtype == torch.float32 and t.dim() > 1:
        return t.to(dtype)
    return t


def instantiate_tree(defs: PyTree, generator: torch.Generator, device="cuda",
                     compute_dtype: Optional[torch.dtype] = None) -> PyTree:
    """Draw every leaf of ``defs`` from ``generator`` on ``device``, one leaf
    at a time.  With ``compute_dtype`` each leaf is cast by
    :func:`compute_cast` as soon as it is drawn, so the float32 tree never
    exists whole (8.6 B parameters are 34 GB in float32)."""
    def draw(d: ParamDef) -> torch.Tensor:
        t = d.instantiate(generator, device)
        return compute_cast(t, compute_dtype) if compute_dtype else t
    return tree_map(draw, defs, is_leaf=lambda x: isinstance(x, ParamDef))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor], eps: float = 1e-6,
            gemma_style: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    if scale is not None:
        s = scale.float()
        x = x * (1.0 + s) if gemma_style else x * s
    return x.to(dt)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def apply_norm(kind: str, x: torch.Tensor, params: Optional[Dict]
               ) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if kind == "gemma_rmsnorm":
        return rmsnorm(x, params["scale"], gemma_style=True)
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    if kind == "nonparam_ln":
        return layernorm(x, None, None)
    raise ValueError(f"unknown norm {kind!r}")


def norm_defs(kind: str, d: int) -> Optional[Dict[str, ParamDef]]:
    if kind in ("rmsnorm",):
        return {"scale": ParamDef((d,), (None,), init="ones")}
    if kind == "gemma_rmsnorm":
        return {"scale": ParamDef((d,), (None,), init="zeros")}   # (1+scale)
    if kind == "layernorm":
        return {"scale": ParamDef((d,), (None,), init="ones"),
                "bias": ParamDef((d,), (None,), init="zeros")}
    if kind == "nonparam_ln":
        return {}   # empty dict keeps the tree structure homogeneous
    raise ValueError(f"unknown norm {kind!r}")


# ---------------------------------------------------------------------------
# RoPE (in float32)
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (b, s, h, hd); positions: (b, s) or (s,) int32."""
    dt = x.dtype
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    ang = positions.float()[..., None] * inv                # (b, s, hd/2) / (s, hd/2)
    if ang.dim() == 2:                                      # (s, hd/2)
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# Activations / misc
# ---------------------------------------------------------------------------


def activation(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def kv_eff_heads(n_kv: int, tp: int) -> Tuple[int, int]:
    """(effective kv heads after duplication, repeat factor)."""
    if n_kv >= tp:
        if n_kv % tp:
            raise ValueError(f"n_kv={n_kv} not divisible by tp={tp}")
        return n_kv, 1
    if tp % n_kv:
        raise ValueError(f"tp={tp} not a multiple of n_kv={n_kv}")
    return tp, tp // n_kv


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` under JAX's type promotion: a bfloat16 operand meeting a
    float32 one is widened, where ``torch.matmul`` would refuse the pair.
    The result has the promoted dtype, as ``jnp.matmul``'s has."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands under JAX's type promotion."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))
