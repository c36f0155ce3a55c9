"""Step factories for serving: ``prefill_step`` and ``serve_step``.

The port of the serving half of the JAX package's ``launch/steps.py``
(``make_ctx``, ``make_prefill_step`` at :131, ``make_serve_step`` at :163)
for ``mesh=None``: one card, tp = 1.  Each factory returns a plain callable
that runs eagerly under ``torch.inference_mode`` on the device its inputs
lie on.  The serve step updates the caches in place, where the reference
donates them.  A mesh, and the train step with its optimizers and the
sync layer, come later (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as M
from repro_torch.models.common import ShardCtx


def make_ctx(mesh) -> ShardCtx:
    if mesh is None:
        return ShardCtx()
    raise NotImplementedError("the port serves on one card (mesh=None); a "
                              "mesh is ROADMAP Queue 1 item 7")


def make_prefill_step(cfg: ModelConfig, mesh, shape: InputShape,
                      long_ctx: bool = False) -> Callable:
    """(params, batch{ids (B, S)}) -> (next_token (B,) int32, caches), the
    caches sized for ``shape.seq_len`` tokens."""
    ctx = make_ctx(mesh)

    @torch.inference_mode()
    def prefill_step(params: Dict, batch: Dict):
        if "extra_emb" in batch:
            raise NotImplementedError("modality frontends are not ported yet "
                                      "(ROADMAP Queue 1 item 6)")
        logits, caches = M.prefill(cfg, ctx, params, batch["ids"],
                                   capacity=shape.seq_len, long_ctx=long_ctx)
        return M.sample_greedy(ctx, logits), caches

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh, shape: InputShape,
                    long_ctx: bool = False) -> Callable:
    """(params, caches, batch{ids (B, 1), pos (B,)}) -> (next_token (B,)
    int32, caches), the caches updated in place."""
    ctx = make_ctx(mesh)

    @torch.inference_mode()
    def serve_step(params: Dict, caches: Dict, batch: Dict):
        logits, caches = M.decode_step(cfg, ctx, params, batch["ids"],
                                       batch["pos"], caches,
                                       long_ctx=long_ctx)
        return M.sample_greedy(ctx, logits), caches

    return serve_step
