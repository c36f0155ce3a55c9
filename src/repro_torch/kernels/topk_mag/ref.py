"""Plain PyTorch version of the largest-|Δ|-first send order.

The CPU path of :func:`repro_torch.kernels.topk_mag.ops.magnitude_order` and
the oracle the CUDA kernel is held against: a stable ascending sort of the
negated f64 magnitudes, i.e. ``np.argsort(-mags, kind="stable")`` (ties in
first-occurrence order, NaN last).
"""
from __future__ import annotations

import torch


def magnitude_order(mags: torch.Tensor) -> torch.Tensor:
    """int64 indices ordering f64 ``mags`` descending; ties stable."""
    return torch.argsort(-mags, stable=True)
