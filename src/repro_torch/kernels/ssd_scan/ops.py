"""Public SSD-scan op: the CUDA kernel for CUDA tensors, ``ref`` on CPU.

``ssd_scan`` is what :func:`repro_torch.models.recurrent.mamba2_fwd` runs
over a whole sequence (prefill); decode runs the plain ``ssd_step``.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

# kernel launches made by ssd_scan (reset by callers that count a run)
launches = 0
_COUNT_LOCK = threading.Lock()

MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 256   # the kernel's tiles
_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 7
         + [ctypes.c_void_p])

ssd_step = ref.ssd_step


@functools.cache
def _entry(name: str):
    return _build.entry(name, _ARGS)


def _check(x, dt, A, B, C, chunk, initial_state) -> None:
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError("ssd_scan: need x (b, l, h, p) and B, C (b, l, g, n)")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if B.shape[:2] != (b, l) or tuple(dt.shape) != (b, l, h) \
            or tuple(A.shape) != (h,) or g == 0 or h % g:
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}")
    if initial_state is not None and tuple(initial_state.shape) != (b, h, p,
                                                                    n):
        raise ValueError(f"ssd_scan: initial_state "
                         f"{tuple(initial_state.shape)} is not (b, h, p, n)")
    if chunk <= 0:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    tensors = [x, dt, A, B, C] + ([initial_state] if initial_state is not None
                                  else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd_scan: tensors must share a device")
    if x.device.type == "cpu":
        return
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in _ENTRY \
            or dt.dtype != torch.float32 or A.dtype != torch.float32 or (
                initial_state is not None
                and initial_state.dtype != torch.float32):
        raise TypeError(f"ssd_scan: on the card x, B, C must be all float32 "
                        f"or all bfloat16 and dt, A, initial_state float32; "
                        f"got {x.dtype} / {B.dtype} / {C.dtype}, {dt.dtype}, "
                        f"{A.dtype}")
    if p > MAX_HEAD_DIM or n > MAX_STATE or min(chunk, l) > MAX_CHUNK:
        raise ValueError(f"ssd_scan: the kernel takes head dim <= "
                         f"{MAX_HEAD_DIM}, state <= {MAX_STATE}, chunk <= "
                         f"{MAX_CHUNK}; got {p}, {n}, {chunk}")
    if b > 65535 or h > 65535:
        raise ValueError("ssd_scan: b and h must be below 65,536")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in chunks of ``chunk`` steps (the contract of the JAX
    package's ``ssd_chunked``; the last chunk is padded).

    x (b, l, h, p), dt (b, l, h), A (h,), B and C (b, l, g, n) at group
    granularity, initial_state (b, h, p, n) or None.  Returns y (b, l, h, p)
    in x's dtype and the final state (b, h, p, n) float32.  On the card x,
    B, C are all float32 or all bfloat16, dt, A and the state float32,
    p <= 64, n <= 128, chunk <= 256; anything else raises.
    """
    _check(x, dt, A, B, C, chunk, initial_state)
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, B, C, chunk,
                               initial_state=initial_state)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    fin = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
           if initial_state is None else initial_state.float().clone())
    if y.numel() == 0:
        return y, fin
    x, dt, A = x.contiguous(), dt.contiguous(), A.contiguous()
    B, C = B.contiguous(), C.contiguous()
    init = None if initial_state is None else initial_state.contiguous()
    # a chunk longer than the sequence is one padded chunk: cut it to l
    cs = min(chunk, l)
    err = _entry(_ENTRY[x.dtype])(
        x.device.index, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(),
        init.data_ptr() if init is not None else None, y.data_ptr(),
        fin.data_ptr(), b, l, h, g, p, n, cs,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    global launches
    with _COUNT_LOCK:
        launches += 1
    return y, fin
