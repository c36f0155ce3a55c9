"""Train state: per-replica parameters + optimizer + consistency sync state
(the port of the JAX package's ``launch/state.py``).

Layout: every leaf leads with a replica dimension, as in the reference's
global layout, where each data-parallel replica owns a drifting copy of the
parameters (the paper's per-worker replica).  On one card the replicas are
stacked on that card.  ``params`` and the optimizer's moments are trees of
the model's layout; the sync state keeps flat ``{path: tensor}`` dicts, the
paths those of :func:`repro_torch.models.common.tree_paths` (the JAX
package's key paths, joined by ``/``), as :mod:`repro_torch.core.sync`
takes them.  The step and the counters are int32 tensors on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.sync import SyncState, init_sync_state
from repro_torch.kernels import resolve_device
from repro_torch.models import model as M
from repro_torch.models.common import instantiate_tree, tree_map, tree_paths
from repro_torch.optim import OptState, init_opt_state

PyTree = Any


@dataclasses.dataclass
class TrainState:
    params: PyTree                # float32 master tree on the device
    opt: OptState
    sync: SyncState               # flat dicts keyed by parameter path
    step: torch.Tensor            # int32, host


def init_local_state(cfg: ModelConfig, tcfg: TrainConfig, tp: int,
                     seed: int = 0, device="cuda") -> TrainState:
    """Single-replica state (no replica dimension).  The float32 tree is
    drawn whole on ``device`` (the card unless the caller asks for the
    CPU) from a ``torch.Generator`` seeded with ``seed``: the reference's
    distribution, not its numbers."""
    if tp != 1:
        raise NotImplementedError("the port trains at tp = 1; a model axis "
                                  "comes with the mesh (ROADMAP Queue 1 "
                                  "item 7)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = instantiate_tree(M.model_defs(cfg, tp), gen, dev)
    # the storage dtype of δ and the Adam moments (None: the leaves')
    sdt = (getattr(torch, tcfg.state_dtype)
           if tcfg.state_dtype != "float32" else None)
    return TrainState(
        params=params,
        opt=init_opt_state(params, tcfg.optimizer, dtype=sdt),
        sync=init_sync_state(tree_paths(params),
                             hierarchy=tcfg.hierarchical_sync,
                             compress="bf16" if tcfg.quantize_sync else None,
                             dtype=sdt, dp_axes=()),
        step=torch.zeros((), dtype=torch.int32),
    )


def map_state(fn: Callable[[torch.Tensor], torch.Tensor], state: Any) -> Any:
    """``fn`` over every tensor of a state (a ``TrainState`` or one of its
    parts), keeping its structure."""
    def over(obj):
        if isinstance(obj, torch.Tensor):
            return fn(obj)
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{
                f.name: over(getattr(obj, f.name))
                for f in dataclasses.fields(obj)})
        return tree_map(fn, obj)
    return over(state)


def add_dp_axis(state: TrainState, dp: int) -> TrainState:
    """One replica's state copied to ``dp`` identical replicas (the paper's
    common x0): real copies, since each replica is updated in place."""
    return map_state(lambda x: x[None].expand(dp, *x.shape).contiguous(),
                     state)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, tp: int, dp: int,
                     seed: int = 0, device="cuda") -> TrainState:
    return add_dp_axis(init_local_state(cfg, tcfg, tp, seed, device), dp)


def squeeze_dp(state: Any) -> Any:
    """A state (or one of its parts) of one replica without its replica
    dimension (views)."""
    return map_state(lambda x: x[0], state)


def unsqueeze_dp(state: Any) -> Any:
    """The inverse of :func:`squeeze_dp`: a replica dimension of 1."""
    return map_state(lambda x: x[None], state)
