"""Public shard-apply op: the CUDA kernel for CUDA tensors, ``ref`` on CPU.

``scatter_add_`` is what :class:`repro_torch.runtime.shard.ServerShard` calls
to land a coalesced batch of row updates in its dense master block.  It
keeps the reference's contract (``np.add.at`` order, sentinel row ``R``), so
the runtime's final state stays bitwise equal to the simulator's on either
device.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ps_apply import ref

# kernel launches made by scatter_add_ (reset by callers that count a run)
launches = 0
_COUNT_LOCK = threading.Lock()

_ENTRY = {torch.float64: "ps_apply_f64", torch.float32: "ps_apply_f32"}
_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]


@functools.cache
def _entry(name: str):
    return _build.entry(name, _ARGS)


def _check(dense: torch.Tensor, rows: torch.Tensor, delta: torch.Tensor,
           rows_checked: bool) -> None:
    if dense.dtype not in _ENTRY:
        raise TypeError(f"ps_apply: dense must be float32/float64, "
                        f"got {dense.dtype}")
    if dense.dim() != 2 or rows.dim() != 1 or delta.dim() != 2:
        raise ValueError("ps_apply: need dense (R, C), rows (N,), delta (N, C)")
    if delta.shape != (rows.shape[0], dense.shape[1]):
        raise ValueError(f"ps_apply: delta {tuple(delta.shape)} does not "
                         f"match rows {tuple(rows.shape)} x dense "
                         f"{tuple(dense.shape)}")
    if rows.dtype != torch.int64 or delta.dtype != dense.dtype:
        raise TypeError(f"ps_apply: need int64 rows and {dense.dtype} delta, "
                        f"got {rows.dtype} / {delta.dtype}")
    if not (dense.device == rows.device == delta.device):
        raise ValueError("ps_apply: dense, rows and delta must share a device")
    if not (dense.is_contiguous() and rows.is_contiguous()
            and delta.is_contiguous()):
        raise ValueError("ps_apply: tensors must be contiguous")
    if rows.numel() and not rows_checked:
        lo, hi = torch.stack(torch.aminmax(rows)).tolist()
        if lo < 0 or hi > dense.shape[0]:
            raise IndexError(f"ps_apply: rows span [{lo}, {hi}], outside "
                             f"[0, {dense.shape[0]}]")


def scatter_add_(dense: torch.Tensor, rows: torch.Tensor,
                 delta: torch.Tensor, *,
                 rows_checked: bool = False) -> torch.Tensor:
    """Accumulate ``delta[i]`` into ``dense[rows[i]]`` in submission order.

    ``dense`` (R, C) float32/float64, ``rows`` (N,) int64 in [0, R] where
    ``R`` is a no-op sentinel, ``delta`` (N, C) of dense's dtype, all on one
    device and contiguous.  Updates ``dense`` in place and returns it.

    The row-range check reads ``rows``' min and max back to the host, which
    on a CUDA tensor is a device round trip that waits for the stream.  A
    caller that has checked the rows on the host before copying them to the
    card (as the shard does) passes ``rows_checked=True`` to skip it.
    """
    _check(dense, rows, delta, rows_checked)
    if dense.device.type == "cpu":
        return ref.scatter_add_(dense, rows, delta)
    R, C = dense.shape
    N = rows.shape[0]
    if N == 0 or C == 0 or R == 0:
        return dense
    err = _entry(_ENTRY[dense.dtype])(
        dense.device.index, dense.data_ptr(), R, C, rows.data_ptr(),
        delta.data_ptr(), N, torch.cuda.current_stream(dense.device).cuda_stream)
    if err:
        raise RuntimeError(f"ps_apply kernel launch failed: CUDA error {err}")
    global launches
    with _COUNT_LOCK:
        launches += 1
    return dense
