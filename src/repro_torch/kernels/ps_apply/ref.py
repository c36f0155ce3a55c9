"""Plain PyTorch version of the shard's ordered scatter-add.

The CPU path of :func:`repro_torch.kernels.ps_apply.ops.scatter_add_` and the
oracle the CUDA kernel is held against.  ``index_add_`` on a CPU tensor walks
the index in order and adds each source row with one ``+`` per element, so
duplicate rows accumulate bitwise like ``np.add.at`` (the tests hold it to
that with heavy duplicates).  On a CUDA tensor ``index_add_`` uses atomics
and is not order-exact, which is why the port has a kernel of its own.
"""
from __future__ import annotations

import torch


def scatter_add_(dense: torch.Tensor, rows: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """dense[rows[i]] += delta[i] in order, in place; row R is a no-op."""
    keep = rows < dense.shape[0]
    if not bool(keep.all()):
        rows, delta = rows[keep], delta[keep]
    return dense.index_add_(0, rows, delta)
