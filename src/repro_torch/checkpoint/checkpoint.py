"""Tree checkpointing to npz (+ json metadata), the port of the JAX
package's ``checkpoint/checkpoint.py``.

The files are the reference's: ``ckpt_<step:08d>.npz`` holds one array per
leaf under its ``/``-joined key path (dict keys and list indices, as
``jax.tree_util`` names them), ``ckpt_<step:08d>.json`` the step, the
number of arrays and the caller's metadata.  So either package reads the
other's checkpoints.  A bfloat16 leaf is saved as float32, which holds it
exactly (numpy has no bfloat16), and cast back on restore.

Checkpoints are taken at sync boundaries: the trainer force-syncs first, so
the saved parameters are the fully synchronized state.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_map_paths, tree_paths

PyTree = Any
_SEP = "/"


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().to("cpu")
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def save_checkpoint(directory: str, step: int, tree: PyTree,
                    metadata: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"
    arrays = {k: _to_numpy(v) for k, v in tree_paths(tree, _SEP).items()}
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    meta = {"step": step, "n_arrays": len(arrays), **(metadata or {})}
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def restore_checkpoint(directory: str, like: PyTree,
                       step: Optional[int] = None) -> Tuple[PyTree, int]:
    """Restore into the structure of ``like`` (a tree of tensors; shape
    checked, each leaf given ``like``'s dtype and device)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        def load(key: str, leaf: torch.Tensor) -> torch.Tensor:
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"expected {tuple(leaf.shape)}")
            return torch.from_numpy(np.array(arr)).to(leaf.device,
                                                       leaf.dtype)
        return tree_map_paths(load, like, _SEP), step


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None
