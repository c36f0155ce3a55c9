"""Step factories: ``train_step``, ``prefill_step`` and ``serve_step``.

The port of the JAX package's ``launch/steps.py`` for ``mesh=None``: one
card, tp = 1.  Each factory returns a plain callable that runs eagerly on
the device its inputs lie on.

``train_step`` is where the paper's technique lives in the LLM substrate,
the reference's ``local_step`` (``steps.py:67-107``): the gradients of
:func:`repro_torch.models.model.lm_loss`, the local optimizer update, then
:func:`repro_torch.core.sync.apply_and_sync` (read-my-writes apply and the
policy-triggered delta sum over the replicas).  A state whose leaves lead
with a replica dimension of k > 1 is trained replica by replica on one
card, each on its own slice of the batch, and synced over
``dp_axes=("data",)``: the reference's step under ``jax.vmap(axis_name=
"data")``, with its metrics averaged over the replicas as its ``pmean``
averages them.  With k = 1 the replica dimension is squeezed and the sync
runs over no axis, as the reference's ``mesh=None`` step does.

The serve steps run under ``torch.inference_mode`` and update the caches
in place, where the reference donates them.  A mesh is ROADMAP Queue 1
item 7.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig
from repro_torch.core import policies as pol
from repro_torch.core.sync import apply_and_sync
from repro_torch.launch.state import TrainState, squeeze_dp, \
    unsqueeze_dp
from repro_torch.models import model as M
from repro_torch.models.common import ShardCtx, tree_leaves, tree_map, \
    tree_paths
from repro_torch.optim import OptState, optimizer_update
from repro_torch.optim.schedule import constant, linear_warmup

def make_ctx(mesh) -> ShardCtx:
    if mesh is None:
        return ShardCtx()
    raise NotImplementedError("the port runs on one card (mesh=None); a "
                              "mesh is ROADMAP Queue 1 item 7")


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    mesh=None) -> Callable:
    """(state, batch{ids, labels (k b, s)[, extra_emb (k b, n, d)]}) ->
    (state, metrics).

    ``state`` leads every leaf with a replica dimension k; replica r trains
    on batch rows [r b, (r + 1) b), of ``extra_emb`` too (a frontend's
    embeddings, which replace the first positions).  The parameters and δ
    are updated in place (the reference donates the state), the
    optimizer's moments are written back into the state's buffers, the
    other fields are new.
    ``metrics``: 0-d float32 tensors ``loss``, ``xent``, ``aux``,
    ``synced``, ``grad_norm``, ``lr``, averaged over the replicas."""
    ctx = make_ctx(mesh)
    policy = pol.from_spec(tcfg.consistency)
    lr_fn = linear_warmup(tcfg.lr, tcfg.warmup_steps, constant(tcfg.lr))
    opt_fn = optimizer_update(tcfg.optimizer)
    compress = "bf16" if tcfg.quantize_sync else None

    def train_step(state: TrainState, batch: Dict):
        dev = tree_leaves(state.params)[0].device
        k = int(state.step.shape[0])
        ids = torch.as_tensor(batch["ids"]).to(dev, torch.long)
        labels = torch.as_tensor(batch["labels"]).to(dev, torch.long)
        extra = batch.get("extra_emb")
        if extra is not None:
            extra = torch.as_tensor(extra).to(dev)
        if ids.shape[0] % k:
            raise ValueError(f"a batch of {ids.shape[0]} rows does not "
                             f"split over {k} replicas")
        rows = ids.shape[0] // k
        lr = lr_fn(state.step[0])
        update = tree_map(torch.empty_like, state.params)
        state_f = [tree_paths(t) for t in (state.params, state.opt.mu,
                                           state.opt.nu, update)]
        per_replica = []
        for r in range(k):
            p_r = tree_map(lambda a: a[r].detach().requires_grad_(True),
                           state.params)
            leaves = tree_leaves(p_r)
            sl = slice(r * rows, (r + 1) * rows)
            loss, m = M.lm_loss(cfg, ctx, p_r, ids[sl], labels[sl],
                                extra_emb=None if extra is None
                                else extra[sl], remat=tcfg.remat)
            grad_leaves = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda _: next(grad_leaves), p_r)
            with torch.no_grad():
                # leaf by leaf (every optimizer is elementwise, so the
                # numbers are the tree's): one leaf's new moments and update
                # are held at a time, not a tree's worth of each
                for path, g in tree_paths(grads).items():
                    p, mu, nu, u = (flat[path] for flat in state_f)
                    upd, new_opt = opt_fn(
                        g, OptState(mu=mu[r], nu=nu[r],
                                    count=state.opt.count[r]),
                        lr, weight_decay=tcfg.weight_decay, params=p[r])
                    u[r].copy_(upd)
                    mu[r].copy_(new_opt.mu)
                    nu[r].copy_(new_opt.nu)
                    del upd, new_opt
                # the reference's leaf order: sorted paths
                sq = sum(torch.dot(g.reshape(-1), g.reshape(-1))
                         for g in tree_paths(grads).values())
                per_replica.append({
                    "loss": loss.detach().float(),
                    "xent": m["xent"].detach().float(),
                    "aux": m["aux"].detach(),
                    "grad_norm": torch.sqrt(sq).float()})
            del loss, m, grads, grad_leaves, p_r, leaves
        with torch.no_grad():
            params_f, update_f = tree_paths(state.params), tree_paths(update)
            if k == 1:               # the reference's mesh=None step
                params_f, update_f = squeeze_dp(params_f), squeeze_dp(update_f)
                sync, dp_axes = squeeze_dp(state.sync), ()
            else:
                sync, dp_axes = state.sync, ("data",)
            _, sync, synced = apply_and_sync(
                params_f, sync, update_f, policy, dp_axes, compress=compress,
                hierarchy=tcfg.hierarchical_sync)
            if k == 1:
                sync = unsqueeze_dp(sync)
        new = TrainState(params=state.params,
                         opt=OptState(mu=state.opt.mu, nu=state.opt.nu,
                                      count=state.opt.count + 1),
                         sync=sync, step=state.step + 1)
        metrics = {key: torch.stack([m[key].cpu() for m in per_replica])
                   .mean() for key in per_replica[0]}
        metrics["synced"] = torch.tensor(float(synced), dtype=torch.float32)
        metrics["lr"] = lr
        return new, {key: metrics[key] for key in
                     ("loss", "xent", "aux", "synced", "grad_norm", "lr")}

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh, shape: InputShape,
                      long_ctx: bool = False) -> Callable:
    """(params, batch{ids (B, S)[, extra_emb (B, n, d)]}) -> (next_token
    (B,) int32, caches), the caches sized for ``shape.seq_len`` tokens; a
    frontend's ``extra_emb`` replaces the prompt's first positions."""
    ctx = make_ctx(mesh)

    @torch.inference_mode()
    def prefill_step(params: Dict, batch: Dict):
        logits, caches = M.prefill(cfg, ctx, params, batch["ids"],
                                   capacity=shape.seq_len,
                                   extra_emb=batch.get("extra_emb"),
                                   long_ctx=long_ctx)
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
