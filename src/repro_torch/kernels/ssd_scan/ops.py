"""Public SSD-scan op: the CUDA kernels for CUDA tensors, ``ref`` on CPU.

``ssd_scan`` is what :func:`repro_torch.models.recurrent.mamba2_fwd` runs
over a whole sequence (prefill); decode runs the plain ``ssd_step``.  On the
card the entry follows the dtype: bfloat16 runs three tensor-core launches
parallel over chunks (the chunks' state mass, the pass that carries the
state across chunks, the chunks' outputs), float32 the one float32-pipe
kernel; neither falls back to the other.
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
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# each entry's C signature: device, pointers, sizes, [strides, vec,] stream
_ARGS = {"ssd_scan_f32": [_INT] + [_P] * 8 + [_I64] * 11 + [_P],
         "ssd_chunk_state_bf16": [_INT] + [_P] * 6 + [_I64] * 11 + [_INT, _P],
         "ssd_state_pass": [_INT] + [_P] * 5 + [_I64] * 6 + [_P],
         "ssd_chunk_scan_bf16": [_INT] + [_P] * 7 + [_I64] * 11 + [_INT, _P]}

ssd_step = ref.ssd_step


@functools.cache
def _entry(name: str):
    return _build.entry(name, _ARGS[name])


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
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in _DTYPES \
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
    dev, f32 = x.device, torch.float32
    if x.numel() == 0:
        return (torch.empty_like(x, memory_format=torch.contiguous_format),
                torch.zeros((b, h, p, n), dtype=f32, device=dev)
                if initial_state is None else initial_state.float().clone())
    # x, B and C are read where they lie (Mamba2 hands over column slices
    # of one projection) when each step's rows are packed and B and C
    # share strides; otherwise as copies
    x, B, C = _packed(x), _packed(B), _packed(C)
    if B.stride() != C.stride():
        B, C = B.contiguous(), C.contiguous()
    strides = (x.stride(0), x.stride(1), B.stride(0), B.stride(1))
    dt, A = dt.contiguous(), A.contiguous()
    init = None if initial_state is None else initial_state.contiguous()
    if init is not None and init.data_ptr() % 16:
        init = init.clone()          # the state pass reads it 16 bytes a time
    # a chunk longer than the sequence is one padded chunk: cut it to l
    cs = min(chunk, l)
    run = functools.partial(_launch, dev)
    if x.dtype == torch.bfloat16:
        # each launch is issued as soon as its inputs exist, so that the
        # host allocates the next one's while the card runs it
        nc = -(-l // cs)
        # 16-byte copies need whole rows of 8 bf16 on 16-byte boundaries
        vec = int(all(v % 8 == 0 for v in (p, n) + strides)
                  and all(t.data_ptr() % 16 == 0 for t in (x, B, C)))
        acum = torch.empty((b, h, nc * cs), dtype=f32, device=dev)
        states = torch.empty((b, nc, h, p, n), dtype=f32, device=dev)
        run("ssd_chunk_state_bf16", _ptr(x), _ptr(dt), _ptr(A), _ptr(B),
            _ptr(acum), _ptr(states), b, l, h, g, p, n, cs, *strides, vec)
        # the state entering each chunk, split into bf16 hi and lo planes
        s_in = torch.empty((b, nc, h, 2, p, n), dtype=torch.bfloat16,
                           device=dev)
        fin = torch.empty((b, h, p, n), dtype=f32, device=dev)
        run("ssd_state_pass", _ptr(acum), _ptr(init), _ptr(states),
            _ptr(s_in), _ptr(fin), b, l, h, p, n, cs)
        y = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
        run("ssd_chunk_scan_bf16", _ptr(x), _ptr(dt), _ptr(B), _ptr(C),
            _ptr(acum), _ptr(s_in), _ptr(y), b, l, h, g, p, n, cs, *strides,
            vec)
    else:
        y = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
        fin = torch.empty((b, h, p, n), dtype=f32, device=dev)
        run("ssd_scan_f32", _ptr(x), _ptr(dt), _ptr(A), _ptr(B), _ptr(C),
            _ptr(init), _ptr(y), _ptr(fin), b, l, h, g, p, n, cs, *strides)
    global launches
    with _COUNT_LOCK:
        launches += 1
    return y, fin


def _packed(t: torch.Tensor) -> torch.Tensor:
    """t (b, l, k, m) with each step's k rows of m packed (strides m and 1;
    any batch and time strides), as the kernels read it, else a copy."""
    k, m = t.shape[2], t.shape[3]
    if (t.stride(3) == 1 or m == 1) and (t.stride(2) == m or k == 1):
        return t
    return t.contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(device: torch.device, name: str, *args) -> None:
    """One C entry on ``device``'s current stream; raises on its error."""
    fn = _entry(name)            # builds the library at first use
    err = fn(device.index, *args,
             torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan: {name} launch failed: CUDA error {err}")
