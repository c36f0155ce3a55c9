"""Model assembly: blocks -> stacked units -> language model.

The port of the JAX package's ``models/model.py`` at tp = 1.  The parameter
layout is the reference's: ``prefix`` / ``scan`` / ``tail`` blocks, where
the per-layer metadata repeats with a short period (3 for RecurrentGemma's
rec/rec/attn) and each ``scan`` leaf stacks the layers of one unit position
over the units.  The reference runs the units with ``lax.scan``; the port
runs them with a Python loop over the units, taking each stacked leaf apart
with one ``torch.unbind`` a forward (so that under autograd its gradient is
stacked once, not summed from one full-size gradient a unit).  ``remat``
runs each unit's body under ``torch.utils.checkpoint`` (non-reentrant), as
the reference wraps it in ``jax.checkpoint``; ``unroll`` has no meaning
here.

Training (:func:`lm_loss`) takes the float32 master tree and applies the
compute cast inside the differentiated function, as the reference does, so
gradients reach the float32 leaves.

Forward modes:
  * full   — prefill: the whole sequence (b, s, d)
  * decode — one token (b, 1, d) against per-layer caches
Caches are written in place (the reference's serve step donates them).

The compute-dtype cast that the reference applies on every call
(``model.py:272-273``: float32 leaves with ndim > 1 go to ``cfg.dtype``, so
a scan-stacked 1-D leaf is cast and a tail block's is not) is applied once,
when the weights are loaded (:func:`load_params`, :func:`init_params`), and
the forward functions take the tree as loaded.  The head needs more: the
reference's ``prefill`` and ``decode_step`` take the uncast tree and cast
its float32 master head to the hidden state's dtype, which is float32 in a
prefill where a recurrent block outside the scanned units promotes the
residual (RecurrentGemma's tail) and the compute dtype in decode.  So the
loaded tree also holds the float32 master head (``head_f32``) where a
prefill needs it (:func:`head_dtype`), and no call casts the head.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as ffn
from repro_torch.models import recurrent as rec
from repro_torch.models.common import (ParamDef, ShardCtx, TensorSpec,
                                       apply_norm, compute_cast,
                                       instantiate_tree, matmul, norm_defs,
                                       tree_leaves, tree_map)

PyTree = Any


# ---------------------------------------------------------------------------
# Layer metadata
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerMeta:
    kind: str                     # "attn" | "rec"
    window: Optional[int]         # attention window (None = full)
    use_moe: bool
    d_ff: int                     # dense FFN width (0 = no FFN)


def layer_metas(cfg: ModelConfig, long_ctx: bool = False) -> List[LayerMeta]:
    kinds = cfg.layer_kinds()
    metas = []
    attn_idx = 0
    for i, kind in enumerate(kinds):
        window = None
        if kind == "attn":
            if cfg.attn_kind == "swa":
                window = cfg.window
            elif cfg.attn_kind == "alternating":
                window = cfg.window if attn_idx % 2 == 0 else None
            attn_idx += 1
            if long_ctx and window is None:
                window = cfg.long_context_window   # bounded-memory long-context mode
        use_moe = (cfg.moe is not None and kind == "attn"
                   and i >= cfg.moe.first_dense_layers)
        if cfg.moe is not None and not use_moe and kind == "attn":
            d_ff = cfg.moe.d_ff_dense
        else:
            d_ff = cfg.d_ff
        metas.append(LayerMeta(kind, window, use_moe, d_ff))
    return metas


def group_layers(cfg: ModelConfig, metas: List[LayerMeta],
                 ) -> Tuple[List[LayerMeta], List[LayerMeta], int,
                            List[LayerMeta]]:
    """-> (prefix, unit, n_units, tail)."""
    start = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    period = len(cfg.layer_pattern)
    if cfg.attn_kind == "alternating":
        period = math.lcm(period, 2)
    body = metas[start:]
    n_units = len(body) // period
    tail_start = start + n_units * period
    prefix = metas[:start]
    unit = metas[start:start + period] if n_units else []
    tail = metas[tail_start:]
    return prefix, unit, n_units, tail


# ---------------------------------------------------------------------------
# Block defs / fwd
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, tp: int, meta: LayerMeta) -> Dict:
    defs: Dict[str, Any] = {"ln1": norm_defs(cfg.norm_kind, cfg.d_model)}
    if meta.kind == "attn":
        defs["mix"] = attn.attn_defs(cfg, tp)
    elif cfg.recurrent.kind == "rglru":
        defs["mix"] = rec.rglru_defs(cfg, tp)
    else:
        defs["mix"] = rec.mamba2_defs(cfg, tp)
    if cfg.post_norm:
        defs["post_ln1"] = norm_defs(cfg.norm_kind, cfg.d_model)
    if meta.d_ff or meta.use_moe:
        defs["ln2"] = norm_defs(cfg.norm_kind, cfg.d_model)
        defs["ffn"] = (ffn.moe_defs(cfg, tp) if meta.use_moe
                       else ffn.mlp_defs(cfg, tp, d_ff=meta.d_ff))
        if cfg.post_norm:
            defs["post_ln2"] = norm_defs(cfg.norm_kind, cfg.d_model)
    return defs


def block_fwd(cfg: ModelConfig, mixer_ctx: ShardCtx,
              meta: LayerMeta, p: Dict, x: torch.Tensor, *,
              cache: Optional[Dict], pos: Optional[torch.Tensor],
              ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, cache, aux): ``aux`` the MoE router's load-balance loss
    (0-d float32), None in a layer without MoE (the reference's 0, which
    :func:`forward` adds nothing for)."""
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    if meta.kind == "attn":
        mix, new_cache = attn.attn_fwd(cfg, mixer_ctx, p["mix"], h,
                                       window=meta.window, cache=cache,
                                       pos=pos)
    elif cfg.recurrent.kind == "rglru":
        mix, new_cache = rec.rglru_fwd(cfg, mixer_ctx, p["mix"], h,
                                       cache=cache, pos=pos)
    else:
        mix, new_cache = rec.mamba2_fwd(cfg, mixer_ctx, p["mix"], h,
                                        cache=cache, pos=pos)
    if cfg.post_norm:
        mix = apply_norm(cfg.norm_kind, mix, p["post_ln1"])
    x = x + mix
    aux = None
    if meta.d_ff or meta.use_moe:
        h = apply_norm(cfg.norm_kind, x, p["ln2"])
        if meta.use_moe:
            y, aux = ffn.moe_fwd(cfg, mixer_ctx, p["ffn"], h)
        else:
            y = ffn.mlp_fwd(cfg, mixer_ctx, p["ffn"], h)
        if cfg.post_norm:
            y = apply_norm(cfg.norm_kind, y, p["post_ln2"])
        x = x + y
    return x, new_cache, aux


def block_cache_defs(cfg: ModelConfig, tp: int, meta: LayerMeta,
                     batch_local: int, capacity: int):
    if meta.kind == "attn":
        cap = min(capacity, meta.window) if meta.window else capacity
        return attn.cache_defs(cfg, tp, batch_local, cap)
    if cfg.recurrent.kind == "rglru":
        return rec.rglru_cache_defs(cfg, tp, batch_local)
    return rec.mamba2_cache_defs(cfg, tp, batch_local)


# ---------------------------------------------------------------------------
# Whole-model defs and parameters
# ---------------------------------------------------------------------------


def stack_defs(defs: PyTree, n: int) -> PyTree:
    def s(d: ParamDef) -> ParamDef:
        shard = d.shard if d.shard else (None,) * len(d.shape)
        return dataclasses.replace(d, shape=(n,) + tuple(d.shape),
                                   shard=(None,) + tuple(shard))
    return tree_map(s, defs, is_leaf=lambda x: isinstance(x, ParamDef))


def model_defs(cfg: ModelConfig, tp: int, long_ctx: bool = False) -> Dict:
    """The parameter tree's defs.  A modality frontend adds none: it is a
    stub whose embeddings the caller supplies (:func:`forward`'s
    ``extra_emb``)."""
    metas = layer_metas(cfg, long_ctx)
    prefix, unit, n_units, tail = group_layers(cfg, metas)
    d = cfg.d_model
    vp = cfg.padded_vocab(tp)
    defs: Dict[str, Any] = {
        "embed": ParamDef((vp, d), ("model", None), init="embed",
                          scale=1.0 / math.sqrt(d)),
        "final_norm": norm_defs(cfg.norm_kind, d),
        "prefix": [block_defs(cfg, tp, m) for m in prefix],
        "scan": (stack_defs([block_defs(cfg, tp, m) for m in unit], n_units)
                 if n_units else []),
        "tail": [block_defs(cfg, tp, m) for m in tail],
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, vp), (None, "model"))
    return defs


def head_dtype(cfg: ModelConfig) -> torch.dtype:
    """The dtype of the hidden state that reaches the head in a full
    forward (prefill).  A recurrent block outside the scanned units keeps
    float32 1-D leaves (``conv_b``, ``b_a``, ``b_i``) that promote the
    residual stream to float32 there; its decode step casts back to the
    compute dtype, so decode's hidden state always has the compute dtype."""
    dtype = getattr(torch, cfg.dtype)
    prefix, _, _, tail = group_layers(cfg, layer_metas(cfg))
    if any(m.kind == "rec" for m in prefix + tail):
        return torch.promote_types(dtype, torch.float32)
    return dtype


def load_params(cfg: ModelConfig, tree: PyTree) -> PyTree:
    """The reference's parameter tree (float32 leaves) as the forward
    functions take it: the compute-dtype cast applied once, and
    ``head_f32``, the float32 master head (d, V), kept where a prefill's
    hidden state is float32.  A tree already loaded is returned as it
    is."""
    dtype = getattr(torch, cfg.dtype)
    out = {k: v if k == "head_f32" else
           tree_map(lambda t: compute_cast(t, dtype), v)
           for k, v in tree.items()}
    if head_dtype(cfg) != dtype and "head_f32" not in out:
        out["head_f32"] = head_matrix(cfg, tree).float()
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> PyTree:
    """Random weights for ``cfg`` drawn on ``device`` (the card unless the
    caller asks for the CPU) from a ``torch.Generator`` seeded with
    ``seed``, with the reference's init rules, loaded as
    :func:`load_params` loads: every leaf but the head is cast as it is
    drawn, so the float32 tree never exists whole.  The same distribution
    as the JAX package's weights, not the same numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    head = "embed" if cfg.tie_embeddings else "head"
    tree = {k: instantiate_tree(v, gen, dev, compute_dtype=(
                None if k == head else getattr(torch, cfg.dtype)))
            for k, v in model_defs(cfg, 1).items()}
    return load_params(cfg, tree)


class LM(nn.Module):
    """The language model as a module holding the parameter tree.

    Each leaf is a buffer (named by its path, ``scan__0__mix__w_x``), so
    ``.to()``, ``state_dict()`` and memory accounting see the weights;
    ``params`` is the tree in the reference's layout, which the functional
    API (:func:`prefill`, :func:`decode_step`, the step factories of
    :mod:`repro_torch.launch.steps`) takes.  ``tree`` is cast on the way in
    (:func:`load_params`)."""

    def __init__(self, cfg: ModelConfig, tree: PyTree):
        super().__init__()
        self.cfg = cfg
        tree = load_params(cfg, tree)
        self._names = _name_tree(tree)
        for name, leaf in zip(tree_leaves(self._names), tree_leaves(tree)):
            self.register_buffer(name, leaf)

    @property
    def params(self) -> PyTree:
        return tree_map(lambda name: self._buffers[name], self._names)

    def forward(self, ids: torch.Tensor, caches: Optional[Dict] = None,
                pos: Optional[torch.Tensor] = None):
        return forward(self.cfg, ShardCtx(), self.params, ids, caches=caches,
                       pos=pos)


def _name_tree(tree: PyTree, path: Tuple[str, ...] = ()) -> PyTree:
    if isinstance(tree, dict):
        return {k: _name_tree(v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_name_tree(v, path + (str(i),)) for i, v in enumerate(tree)]
    return "__".join(path)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def model_cache_defs(cfg: ModelConfig, tp: int, batch_local: int,
                     capacity: int, long_ctx: bool = False) -> Dict:
    metas = layer_metas(cfg, long_ctx)
    prefix, unit, n_units, tail = group_layers(cfg, metas)

    def stack(c):
        return tree_map(lambda s: TensorSpec((n_units,) + s.shape, s.dtype),
                        c)

    return {
        "prefix": [block_cache_defs(cfg, tp, m, batch_local, capacity)
                   for m in prefix],
        "scan": [stack(block_cache_defs(cfg, tp, m, batch_local, capacity))
                 for m in unit],
        "tail": [block_cache_defs(cfg, tp, m, batch_local, capacity)
                 for m in tail],
    }


def empty_cache_tree(defs: PyTree, device) -> PyTree:
    def mk(s: TensorSpec):
        if s.dtype == torch.int32:
            return torch.full(s.shape, attn.POS_SENTINEL, dtype=s.dtype,
                              device=device)
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    return tree_map(mk, defs)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, ctx: ShardCtx, params: Dict,
                 ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup at tp = 1.  ids: (b, s)."""
    e = params["embed"][ids]
    if cfg.norm_kind == "gemma_rmsnorm":            # gemma scales embeddings
        # the scale is rounded to the embedding's dtype first, as jnp does;
        # a 0-dim host tensor goes to the kernel as a scalar, with no copy
        e = e * torch.tensor(math.sqrt(cfg.d_model), dtype=e.dtype)
    return e.to(getattr(torch, cfg.dtype))


def _frontend_override(cfg: ModelConfig, x: torch.Tensor,
                       extra_emb: Optional[torch.Tensor],
                       positions: torch.Tensor) -> torch.Tensor:
    """Replace the first ``n_embeds`` positions of ``x`` (b, s, d) with the
    frontend's embeddings ``extra_emb`` (b, n_embeds, d): VLM patches or
    audio conditioning.  Positions at or past ``n_embeds`` keep the token
    embedding; the embedding's gradient gets nothing from the replaced
    ones."""
    if cfg.frontend is None or extra_emb is None:
        return x
    n = cfg.frontend.n_embeds
    idx = positions.clamp(0, n - 1)                           # (s,)
    override = extra_emb.index_select(1, idx).to(x.dtype)
    return torch.where((positions < n)[None, :, None], override, x)


def forward(cfg: ModelConfig, ctx: ShardCtx, params: Dict, ids: torch.Tensor,
            *, extra_emb: Optional[torch.Tensor] = None,
            caches: Optional[Dict] = None,
            pos: Optional[torch.Tensor] = None,
            long_ctx: bool = False, remat: bool = False,
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (hidden (b, s, d), caches, aux): ``caches``, where given, is
    updated in place; ``aux`` is the sum of the MoE layers' router
    load-balance losses (0-d float32, 0 without MoE).  ``params`` is the tree as loaded
    (:func:`load_params`), or cast for compute inside :func:`lm_loss`.
    ``extra_emb`` (b, n_embeds, d), a frontend's embeddings, replaces the
    first positions of a full sequence (``pos`` None), as the reference's
    does; decode ignores it.  ``remat`` recomputes each unit's body in the
    backward (training only: not with caches)."""
    metas = layer_metas(cfg, long_ctx)
    prefix, unit, n_units, tail = group_layers(cfg, metas)
    x = embed_tokens(cfg, ctx, params, ids)
    if pos is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        x = _frontend_override(cfg, x, extra_emb, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_block(meta, p, x, aux, cache):
        x, _, a = block_fwd(cfg, ctx, meta, p, x, cache=cache, pos=pos)
        return x, (aux if a is None else aux + a)

    for i, meta in enumerate(prefix):
        c = caches["prefix"][i] if caches is not None else None
        x, aux = run_block(meta, params["prefix"][i], x, aux, c)

    # the reference's lax.scan over units: a Python loop over the stacked
    # leaves, each taken apart once (a cache leaf's unit is a view, so it is
    # written in place)
    units = [tree_map(lambda a: a.unbind(0), params["scan"][j])
             for j in range(len(unit))] if n_units else []

    def unit_body(x, aux, u):
        for j, meta in enumerate(unit):
            p_u = tree_map(lambda parts: parts[u], units[j])
            c_u = (tree_map(lambda a: a[u], caches["scan"][j])
                   if caches is not None else None)
            x, aux = run_block(meta, p_u, x, aux, c_u)
        return x, aux

    for u in range(n_units):
        if remat and caches is None:
            x, aux = checkpoint(unit_body, x, aux, u, use_reentrant=False)
        else:
            x, aux = unit_body(x, aux, u)

    for i, meta in enumerate(tail):
        c = caches["tail"][i] if caches is not None else None
        x, aux = run_block(meta, params["tail"][i], x, aux, c)

    x = apply_norm(cfg.norm_kind, x, params["final_norm"])
    return x, caches, aux


# ---------------------------------------------------------------------------
# Head / decode
# ---------------------------------------------------------------------------


def head_matrix(cfg: ModelConfig, params: Dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T          # (d, V)
    return params["head"]


def head_for(cfg: ModelConfig, params: Dict,
             dtype: torch.dtype) -> torch.Tensor:
    """The (d, V) head as hidden states of ``dtype`` meet it: the float32
    master (``head_f32``) for float32 ones where the tree holds it, else
    the loaded head; in a loaded tree either is already in ``dtype``."""
    if dtype == torch.float32 and "head_f32" in params:
        return params["head_f32"]
    return head_matrix(cfg, params)


def logits_of(cfg: ModelConfig, params: Dict,
              x: torch.Tensor) -> torch.Tensor:
    """float32 logits of hidden states ``x`` (..., d).  The reference casts
    its head to ``x``'s dtype (``model.py:459,473``); for a loaded tree
    that cast is a no-op."""
    logits = matmul(x, head_for(cfg, params, x.dtype).to(x.dtype)).float()
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def lm_loss(cfg: ModelConfig, ctx: ShardCtx, params: Dict, ids: torch.Tensor,
            labels: torch.Tensor, *,
            extra_emb: Optional[torch.Tensor] = None, remat: bool = True,
            chunk: int = 256) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy over the float32 master tree ``params``
    (labels < 0 are masked).  The compute cast (``model.py:272-273`` of the
    reference) is applied here, inside the differentiated function, and the
    head is the master head cast to the hidden state's dtype.  The sequence
    is cut into ``s // chunk`` chunks of equal length (the tokens past the
    last whole one count nothing, as in the reference), each chunk's float32
    logits made and dropped in turn; ``remat`` also recomputes each chunk's
    logits in the backward.  With MoE the loss adds ``router_aux_coef``
    times the router's load-balance loss, as the reference's does.  A
    frontend's ``extra_emb`` replaces the first positions (:func:`forward`).
    Returns (loss, {"xent", "aux", "tokens"})."""
    dtype = getattr(torch, cfg.dtype)
    cast = {k: v for k, v in params.items() if k != "head_f32"}
    cast = tree_map(lambda t: compute_cast(t, dtype), cast)
    x, _, aux = forward(cfg, ctx, cast, ids, extra_emb=extra_emb,
                        remat=remat)
    w = head_matrix(cfg, params).to(x.dtype)
    b, s, d = x.shape
    n_chunks = max(1, s // chunk)
    cs = s // n_chunks
    xs = x[:, :n_chunks * cs].reshape(b, n_chunks, cs, d).transpose(0, 1)
    ls = labels[:, :n_chunks * cs].reshape(b, n_chunks, cs).transpose(0, 1)
    vloc = w.shape[1]

    def chunk_loss(xc, lc):
        logits = matmul(xc, w).float()                       # (b, cs, V)
        if cfg.final_softcap is not None:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        # the max shift is a constant with respect to the gradient
        mx = logits.amax(-1).detach()
        lse = mx + torch.log(torch.exp(logits - mx[..., None]).sum(-1))
        ok = (lc >= 0) & (lc < vloc)
        ll = torch.take_along_dim(logits, lc.clamp(0, vloc - 1)[..., None],
                                  dim=-1)[..., 0]
        ll = torch.where(ok, ll, torch.zeros((), dtype=ll.dtype,
                                             device=ll.device))
        mask = (lc >= 0).to(torch.float32)
        return torch.sum((lse - ll) * mask), torch.sum(mask)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        if remat:
            l_c, n_c = checkpoint(chunk_loss, xs[c], ls[c],
                                  use_reentrant=False)
        else:
            l_c, n_c = chunk_loss(xs[c], ls[c])
        tot, n = tot + l_c, n + n_c
    loss = tot / torch.clamp(n, min=1.0)
    metrics = {"xent": loss, "aux": aux, "tokens": n}
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_coef * aux
    return loss, metrics


def prefill(cfg: ModelConfig, ctx: ShardCtx, params: Dict, ids: torch.Tensor,
            capacity: int, *, extra_emb: Optional[torch.Tensor] = None,
            long_ctx: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Run the full prompt (its first positions a frontend's ``extra_emb``
    where given), fill fresh caches, return last-position logits (b, V)
    float32 and the caches."""
    b, s = ids.shape
    caches = empty_cache_tree(
        model_cache_defs(cfg, 1, b, capacity, long_ctx), ids.device)
    x, caches, _ = forward(cfg, ctx, params, ids, extra_emb=extra_emb,
                           caches=caches, long_ctx=long_ctx)
    return logits_of(cfg, params, x[:, -1]), caches


def decode_step(cfg: ModelConfig, ctx: ShardCtx, params: Dict,
                ids: torch.Tensor, pos: torch.Tensor, caches: Dict, *,
                long_ctx: bool = False,
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  ids: (b, 1); pos: (b,).  Returns (logits (b, V),
    caches), the caches updated in place."""
    x, caches, _ = forward(cfg, ctx, params, ids, caches=caches, pos=pos,
                           long_ctx=long_ctx)
    return logits_of(cfg, params, x[:, 0]), caches


def sample_greedy(ctx: ShardCtx, logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling: the first index of the largest logit, int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
