"""Public RG-LRU op: the CUDA linear recurrence for CUDA tensors, ``ref`` on
CPU.

``rglru`` is what :func:`repro_torch.models.recurrent.rglru_fwd` runs over a
whole sequence (prefill): the gate math in plain torch, as the reference's
``rglru_pallas`` keeps it in jnp, then :func:`linear_recurrence`, the
kernel.  Decode runs the plain ``rglru_step``.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import ref

# kernel launches made by linear_recurrence (reset by callers that count a run)
launches = 0
_COUNT_LOCK = threading.Lock()

_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_void_p]

rglru_step = ref.rglru_step


@functools.cache
def _entry():
    return _build.entry("linear_recurrence_f32", _ARGS)


def _check(a: torch.Tensor, b: torch.Tensor,
           initial: Optional[torch.Tensor]) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"linear_recurrence: need a, b (batch, l, w) of one "
                         f"shape, got {tuple(a.shape)} / {tuple(b.shape)}")
    if initial is not None and tuple(initial.shape) != (b.shape[0],
                                                        b.shape[2]):
        raise ValueError(f"linear_recurrence: initial {tuple(initial.shape)}"
                         f" is not (batch, w) = ({b.shape[0]}, {b.shape[2]})")
    devs = {a.device, b.device} | ({initial.device} if initial is not None
                                   else set())
    if len(devs) != 1:
        raise ValueError("linear_recurrence: tensors must share a device")
    if a.device.type == "cpu":
        return
    if b.shape[0] > 65535:
        raise ValueError(f"linear_recurrence: batch {b.shape[0]} exceeds the "
                         f"kernel's grid (65,535)")
    if a.dtype != torch.float32 or b.dtype != torch.float32 or (
            initial is not None and initial.dtype != torch.float32):
        raise TypeError(f"linear_recurrence: on the card a, b and initial "
                        f"must be float32, got {a.dtype} / {b.dtype}")


def linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                      initial: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t ⊙ h_{t-1} + b_t over (batch, l, w), the state in float32.

    Returns (h (batch, l, w) in b's dtype, h_last (batch, w) float32, the
    state after the last step).  On the card a, b and ``initial`` are
    float32 (the RG-LRU's gates make them so); a CPU tensor takes the plain
    version, which takes any floating dtype."""
    _check(a, b, initial)
    if a.device.type == "cpu":
        return ref.linear_recurrence(a, b, initial)
    bsz, l, w = b.shape
    a, b = a.contiguous(), b.contiguous()
    init = None if initial is None else initial.contiguous()
    h = torch.empty_like(b)
    if initial is None:
        h_last = torch.zeros((bsz, w), dtype=torch.float32, device=b.device)
    else:
        h_last = init.clone()
    if h.numel() == 0:
        return h, h_last
    err = _entry()(b.device.index, a.data_ptr(), b.data_ptr(),
                   init.data_ptr() if init is not None else None,
                   h.data_ptr(), h_last.data_ptr(), bsz, l, w,
                   torch.cuda.current_stream(b.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    global launches
    with _COUNT_LOCK:
        launches += 1
    return h, h_last


def rglru(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
          a_param: torch.Tensor, initial: Optional[torch.Tensor] = None,
          c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over (b, l, w): gates in plain torch (float32), the
    recurrence through :func:`linear_recurrence`.  Returns (h in x's dtype,
    h_last float32)."""
    a, gated = ref.rglru_gates(x, r_gate, i_gate, a_param, c)
    h, h_last = linear_recurrence(a, gated, initial=initial)
    return h.to(x.dtype), h_last
