"""Public send-order op: the CUDA kernel for CUDA tensors, ``ref`` on CPU.

``magnitude_order`` is what the runtime's worker flush calls to send the
largest updates first (paper §4.2).  It keeps the reference's contract,
``np.argsort(-mags, kind="stable")`` on the f64 magnitudes, so the flush
ships updates in the same order on either device.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_mag import ref

# kernel launches made by magnitude_order (reset by callers that count a run)
launches = 0
_COUNT_LOCK = threading.Lock()

_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p]


@functools.cache
def _entry():
    return _build.entry("topk_mag_f64", _ARGS)


def magnitude_order(mags: torch.Tensor,
                    k: Optional[int] = None) -> torch.Tensor:
    """The first ``k`` (default all) indices of ``mags`` in descending
    order, ties in first-occurrence order, NaN last.

    ``mags`` is a contiguous 1-D float64 tensor; the result is int64 on the
    same device.
    """
    if mags.dim() != 1 or mags.dtype != torch.float64:
        raise TypeError(f"topk_mag: need 1-D float64 magnitudes, got "
                        f"{mags.dtype} of shape {tuple(mags.shape)}")
    if not mags.is_contiguous():
        raise ValueError("topk_mag: magnitudes must be contiguous")
    n = mags.shape[0]
    k = n if k is None else int(k)
    if not 0 <= k <= n:
        raise ValueError(f"topk_mag: k={k} outside [0, {n}]")
    if mags.device.type == "cpu":
        return ref.magnitude_order(mags)[:k]
    out = torch.empty(n, dtype=torch.int64, device=mags.device)
    if n == 0:
        return out
    err = _entry()(mags.device.index, mags.data_ptr(), n, out.data_ptr(),
                   torch.cuda.current_stream(mags.device).cuda_stream)
    if err:
        raise RuntimeError(f"topk_mag kernel launch failed: CUDA error {err}")
    global launches
    with _COUNT_LOCK:
        launches += 1
    return out[:k]
