"""Carry parameter-server state between the JAX package and the port.

The JAX package hands state around as ``{key: np.ndarray}`` in each key's
own shape: ``repro.runtime.PSRuntime.master_value(k)``, a simulator's
``AsyncPS.views[p]``, or a snapshot's assembled params.  The port's
canonical form is one ``(R, C)`` float64 tensor per key — the layout of the
shard blocks: an array of shape ``(R, ...)`` keeps its leading dimension as
rows and flattens the rest into columns, a 1-D array becomes one column.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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
