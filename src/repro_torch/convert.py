"""Carry parameter-server state between the JAX package and the port.

The JAX package hands state around as ``{key: np.ndarray}`` in each key's
own shape: ``repro.runtime.PSRuntime.master_value(k)``, a simulator's
``AsyncPS.views[p]``, or a snapshot's assembled params.  The port's
canonical form is one ``(R, C)`` float64 tensor per key — the layout of the
shard blocks: an array of shape ``(R, ...)`` keeps its leading dimension as
rows and flattens the rest into columns, a 1-D array becomes one column.

The sync layer's state crosses too: :func:`sync_state_from_reference` takes
the JAX package's ``SyncState`` with numpy leaves (stacked per replica, as
``jax.vmap`` carries it) and :func:`sync_state_to_numpy` gives it back as a
dict of numpy arrays, each keeping its dtype and shape.  bfloat16 crosses as
its bits: numpy has no bfloat16 of its own, so an array whose dtype is named
``bfloat16`` (the reference's) is read through a 16-bit integer view, and a
bfloat16 tensor comes back as float32, which holds it exactly.

So does a model's parameter tree: :func:`model_params_from_reference` takes
the JAX package's ``instantiate_tree(model_defs(cfg, 1), key)`` as numpy
(nested dicts and lists, ``scan`` leaves stacked over the units) and gives
the port's tree of the same layout and dtypes, which
:func:`repro_torch.models.model.load_params` then casts for compute.

And a whole train state: :func:`train_state_from_reference` takes the JAX
package's ``TrainState`` with numpy leaves (params, ``OptState``,
``SyncState``, step; with a leading replica dimension or without) and gives
the port's :class:`~repro_torch.launch.state.TrainState`, whose sync state
keeps flat dicts keyed by the ``/``-joined parameter paths;
:func:`train_state_to_numpy` gives it back as numpy, in the same keys.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def canonical(a) -> np.ndarray:
    """``a`` as a float64 ``(R, C)`` host array (a view where possible)."""
    a = np.asarray(a, dtype=np.float64)
    return a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(-1, 1)


def state_from_reference(params: Mapping[str, np.ndarray],
                         device) -> Dict[str, torch.Tensor]:
    """The reference's ``{key: array}`` as the port's canonical ``(R, C)``
    float64 tensors on ``device``.  Always copies: the result shares no
    memory with ``params``."""
    return {k: torch.tensor(canonical(v), dtype=torch.float64, device=device)
            for k, v in params.items()}


def state_to_numpy(state: Mapping[str, torch.Tensor],
                   shapes: Optional[Mapping[str, Tuple[int, ...]]] = None,
                   ) -> Dict[str, np.ndarray]:
    """The port's tensors as host float64 arrays the reference accepts,
    reshaped to ``shapes[key]`` where given.  Always copies."""
    out = {}
    for k, t in state.items():
        a = t.detach().to("cpu", dtype=torch.float64, copy=True).numpy()
        out[k] = a.reshape(shapes[k]) if shapes is not None else a
    return out


_SYNC_TREES = ("delta", "residual", "pod_pending")
_SYNC_SCALARS = ("steps_since_sync", "sync_count", "max_update_mag",
                 "max_update_l2")


def _to_tensor(a, device) -> torch.Tensor:
    """A host array as a tensor of the same dtype and shape on ``device``
    (a bfloat16 array through its bits).  Always copies."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a, copy=True, order="C")
                                .view(np.int16))
        return bits.view(torch.bfloat16).to(device, copy=True)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array of its dtype (bfloat16 as float32, exact).
    Always copies."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def sync_state_from_reference(state: Any, device):
    """The JAX package's ``SyncState`` with numpy leaves (stacked per
    replica) as the port's :class:`~repro_torch.core.sync.SyncState`: the
    trees and running maxima on ``device``, the clock counters on the
    host."""
    from repro_torch.core.sync import SyncState

    trees = {f: {k: _to_tensor(v, device)
                 for k, v in getattr(state, f).items()}
             for f in _SYNC_TREES}
    host = {f: _to_tensor(getattr(state, f), "cpu").to(torch.int32)
            for f in ("steps_since_sync", "sync_count")}
    maxima = {f: _to_tensor(getattr(state, f), device).to(torch.float32)
              for f in ("max_update_mag", "max_update_l2")}
    return SyncState(**trees, **host, **maxima)


def sync_state_to_numpy(state) -> Dict[str, Any]:
    """The port's ``SyncState`` as ``{field: array or {key: array}}`` on the
    host, the field names those of the JAX package's ``SyncState``."""
    out: Dict[str, Any] = {f: {k: _to_array(v)
                               for k, v in getattr(state, f).items()}
                           for f in _SYNC_TREES}
    out.update({f: _to_array(getattr(state, f))
                for f in _SYNC_SCALARS})
    return out


def model_params_from_reference(tree: Any, device) -> Any:
    """The JAX package's model parameter tree (numpy leaves, nested dicts
    and lists) as the port's tree of tensors on ``device``, each leaf of the
    same dtype and shape (bfloat16 through its bits).  Always copies."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda a: _to_tensor(a, device), tree)


def train_state_from_reference(state: Any, device):
    """The JAX package's ``TrainState`` with numpy leaves as the port's
    ``TrainState``: params and the moments on ``device`` (each leaf's dtype
    and shape kept), the sync state as :func:`sync_state_from_reference`
    makes it from the flattened trees, the step and the optimizer's count as
    int32 host tensors.  Always copies."""
    from types import SimpleNamespace

    from repro_torch.launch.state import TrainState
    from repro_torch.models.common import tree_paths
    from repro_torch.optim import OptState

    sync = state.sync
    flat = SimpleNamespace(
        **{f: tree_paths(getattr(sync, f)) for f in _SYNC_TREES},
        **{f: getattr(sync, f) for f in _SYNC_SCALARS})
    return TrainState(
        params=model_params_from_reference(state.params, device),
        opt=OptState(mu=model_params_from_reference(state.opt.mu, device),
                     nu=model_params_from_reference(state.opt.nu, device),
                     count=_to_tensor(state.opt.count, "cpu")
                     .to(torch.int32)),
        sync=sync_state_from_reference(flat, device),
        step=_to_tensor(state.step, "cpu").to(torch.int32))


def train_state_to_numpy(state) -> Dict[str, Any]:
    """The port's ``TrainState`` on the host: ``{"params": tree, "opt":
    {"mu": tree, "nu": tree, "count": array}, "sync":
    sync_state_to_numpy(...), "step": array}``, bfloat16 as float32."""
    from repro_torch.models.common import tree_map

    return {"params": tree_map(_to_array, state.params),
            "opt": {"mu": tree_map(_to_array, state.opt.mu),
                    "nu": tree_map(_to_array, state.opt.nu),
                    "count": _to_array(state.opt.count)},
            "sync": sync_state_to_numpy(state.sync),
            "step": _to_array(state.step)}
