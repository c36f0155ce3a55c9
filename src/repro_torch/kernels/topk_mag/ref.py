"""Plain PyTorch version of the largest-|Δ|-first send order.

The CPU path of :func:`repro_torch.kernels.topk_mag.ops.magnitude_order` and
the oracle the CUDA kernel is held against: a stable ascending sort of the
negated f64 magnitudes, i.e. ``np.argsort(-mags, kind="stable")`` (ties in
first-occurrence order, NaN last).

:func:`sort_keys` writes out the key the CUDA kernel sorts by, for the tests
that hold the key's order against that contract.
"""
from __future__ import annotations

import torch


def magnitude_order(mags: torch.Tensor) -> torch.Tensor:
    """int64 indices ordering f64 ``mags`` descending; ties stable."""
    return torch.argsort(-mags, stable=True)


def sort_keys(mags: torch.Tensor) -> torch.Tensor:
    """The kernel's uint64 sort key of each f64 magnitude, as int64 bits
    (view them as unsigned to compare): ascending keys are descending
    magnitudes.  -0.0 is taken as +0.0; with ``b`` the value's bits, the key
    is ``b`` if the sign bit is set, else ``b ^ 0x7fff...f``; every NaN gets
    all ones.  Sorting ``(key, index)`` pairs is then
    ``np.argsort(-mags, kind="stable")``."""
    b = torch.where(mags == 0, torch.zeros_like(mags), mags).view(torch.int64)
    key = torch.where(b < 0, b, b ^ 0x7FFF_FFFF_FFFF_FFFF)
    return torch.where(torch.isnan(mags), torch.full_like(key, -1), key)
