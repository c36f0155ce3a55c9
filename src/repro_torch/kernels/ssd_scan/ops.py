"""Public SSD-scan op: the CUDA kernels for CUDA tensors, ``ref`` on CPU.

``ssd_scan`` is what :func:`repro_torch.models.recurrent.mamba2_fwd` runs
over a whole sequence (prefill and training); decode runs the plain
``ssd_step``.  On the card the entry follows the dtype: bfloat16 runs three
tensor-core launches parallel over chunks (the chunks' state mass, the pass
that carries the state across chunks, the chunks' outputs), float32 the one
float32-pipe kernel; neither falls back to the other.

On the card, where an input requires grad under grad mode, ``ssd_scan`` is
a ``torch.autograd.Function``: its backward is :func:`ssd_scan_bwd`, the
kernels of ``backward.cu``, again by dtype (bfloat16 five launches on the
tensor cores with float32 operands split, float32 six on the float32
pipes); otherwise it launches the forward alone.  On the CPU it is
``ref.ssd_chunked``, which autograd differentiates as it is.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

# kernel calls made by ssd_scan and by its backward, one per call (reset by
# callers that count a run)
launches = 0
bwd_launches = 0
_COUNT_LOCK = threading.Lock()

MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 256   # the kernel's tiles
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# each entry's C signature: device, pointers, sizes, [strides, vec,] stream
_ARGS = {"ssd_scan_f32": [_INT] + [_P] * 8 + [_I64] * 11 + [_P],
         "ssd_chunk_state_bf16": [_INT] + [_P] * 6 + [_I64] * 11 + [_INT, _P],
         "ssd_state_pass": [_INT] + [_P] * 5 + [_I64] * 6 + [_P],
         "ssd_chunk_scan_bf16": [_INT] + [_P] * 7 + [_I64] * 11 + [_INT, _P],
         "ssd_scan_bwd_f32": [_INT] + [_P] * 22 + [_I64] * 11 + [_P],
         "ssd_scan_bwd_bf16": [_INT] + [_P] * 25 + [_I64] * 11 + [_INT, _P],
         "ssd_scan_bwd_bf16_attrs": [_INT, _P]}
# the bfloat16 backward's kernels, in launch order (the float32 entry's are
# bwd_chunk_state, bwd_state_pass, bwd_chunk, bwd_group_sum; both end with
# bwd_dt and bwd_dA)
BWD_BF16_KERNELS = ("bwd_mass_bf16_kernel", "bwd_pass_bf16_kernel",
                    "bwd_chunk_bf16_kernel")

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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, initial_state)):
        return _SSDScan.apply(x, dt, A, B, C, initial_state, chunk)
    # no gradient wanted (serving): the launches without the Function
    return _forward(x, dt, A, B, C, chunk, initial_state)


def _forward(x, dt, A, B, C, chunk, initial_state):
    """The forward launches on the card (inputs checked)."""
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


class _SSDScan(torch.autograd.Function):
    """The scan on the card with its gradient: forward :func:`_forward`,
    backward :func:`ssd_scan_bwd`.  x, B and C are saved as the views they
    came in as."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        return _forward(x, dt, A, B, C, chunk, initial_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, init = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd(x, dt, A, B, C, ctx.chunk,
                                                  init, dy, dfinal)
        return dx, ddt, dA, dB, dC, dinit, None


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 initial_state: Optional[torch.Tensor], dy: torch.Tensor,
                 dfinal: Optional[torch.Tensor] = None):
    """The vector-Jacobian product of :func:`ssd_scan`: given dy (b, l, h,
    p) and optionally dfinal (b, h, p, n), returns (dx, ddt, dA, dB, dC,
    dinit): dx in x's dtype, ddt (b, l, h), dA (h,) and dinit (b, h, p, n)
    float32 (dinit None without an initial state), dB and dC (b, l, g, n) in
    B's dtype.  On the card dy has x's dtype and dfinal is float32, with
    :func:`ssd_scan`'s limits; a CPU tensor takes ``ref.ssd_scan_bwd``."""
    _check(x, dt, A, B, C, chunk, initial_state)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dy.shape) != (b, l, h, p) or (
            dfinal is not None and tuple(dfinal.shape) != (b, h, p, n)):
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} / dfinal "
                         f"{None if dfinal is None else tuple(dfinal.shape)}"
                         f" do not match x {tuple(x.shape)}, n {n}")
    if dy.device != x.device or (dfinal is not None
                                 and dfinal.device != x.device):
        raise ValueError("ssd_scan_bwd: tensors must share a device")
    if x.device.type == "cpu":
        return ref.ssd_scan_bwd(x, dt, A, B, C, chunk, initial_state, dy,
                                dfinal)
    if dy.dtype != x.dtype or (dfinal is not None
                               and dfinal.dtype != torch.float32):
        raise TypeError(f"ssd_scan_bwd: dy must have x's dtype and dfinal "
                        f"float32, got {dy.dtype} / "
                        f"{None if dfinal is None else dfinal.dtype}")
    dev, f32 = x.device, torch.float32
    init = None if initial_state is None else initial_state.contiguous()
    dx = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, l, h), dtype=f32, device=dev)
    dA = torch.empty((h,), dtype=f32, device=dev)
    dB = torch.empty((b, l, g, n), dtype=B.dtype, device=dev)
    dC = torch.empty((b, l, g, n), dtype=C.dtype, device=dev)
    dinit = None if init is None else torch.empty_like(init)
    if x.numel() == 0:                 # no step: the state passes through
        if dinit is not None and dfinal is not None:
            dinit.copy_(dfinal)
        elif dinit is not None:
            dinit.zero_()
        return dx, ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_(), dinit
    x, B, C = _packed(x), _packed(B), _packed(C)
    if B.stride() != C.stride():
        B, C = B.contiguous(), C.contiguous()
    dt, A, dy = dt.contiguous(), A.contiguous(), dy.contiguous()
    dfin = None if dfinal is None else dfinal.contiguous()
    # the state passes read and write the states 16 bytes a time
    init, dfin = (None if t is None else t.clone() if t.data_ptr() % 16 else t
                  for t in (init, dfin))
    cs = min(chunk, l)
    nc = -(-l // cs)
    strides = (x.stride(0), x.stride(1), B.stride(0), B.stride(1))
    common = (_ptr(x), _ptr(dt), _ptr(A), _ptr(B), _ptr(C), _ptr(init),
              _ptr(dy), _ptr(dfin), _ptr(dx), _ptr(ddt), _ptr(dA), _ptr(dB),
              _ptr(dC), _ptr(dinit))
    if x.dtype == torch.bfloat16:
        # float32 scratch in one allocation: a and dt (chunk rows of 256,
        # the kernel's widest chunk), the state masses, C B^T tiles, the
        # tiles' dB / dC over their pairs, <dS_out, S_in> partials, the d a
        # planes, dA partials; the split states in another
        nt = -(-cs // 64)
        shapes = {"acum": (2, b, h, nc, MAX_CHUNK),
                  "states": (2, b, nc, h, p, n),
                  "cbt": (b, g, nc, nt, nt, 64 * 64),
                  "acc": (b, g, nc, 2, nt, 64 * MAX_STATE),
                  "sdot": (b, nc, h, -(-(p * n) // 1024)),
                  "rqx": (4, b, h, nc, MAX_CHUNK),
                  "dA_part": (b, nc, h)}
        # each part starts 16-byte aligned
        sizes = [-(-math.prod(v) // 4) * 4 for v in shapes.values()]
        flat = torch.empty(sum(sizes), dtype=f32, device=dev)
        part = dict(zip(shapes, torch.split(flat, sizes)))
        planes = torch.empty((2, b, nc, h, 2, p, n), dtype=x.dtype,
                             device=dev)
        pn, cnt = p * n, b * nc * h * 2
        # 16-byte copies need whole rows of 8 bf16 on 16-byte boundaries
        vec = int(all(v % 8 == 0 for v in (p, n) + strides)
                  and all(t.data_ptr() % 16 == 0 for t in (x, B, C, dy)))
        ptr = {k: t.data_ptr() for k, t in part.items()}
        _launch(dev, "ssd_scan_bwd_bf16", *common, ptr["acum"],
                ptr["acum"] + 4 * b * h * nc * MAX_CHUNK, ptr["states"],
                ptr["states"] + 4 * b * nc * h * pn, _ptr(planes),
                _ptr(planes) + 2 * cnt * pn, ptr["cbt"], ptr["acc"],
                ptr["sdot"], ptr["rqx"], ptr["dA_part"], b, l, h, g, p, n,
                cs, *strides, vec)
    else:
        nblk = -(-(p * n) // 256)
        acum = torch.empty((b, h, nc * cs), dtype=f32, device=dev)
        states = torch.empty((2, b, nc, h, p, n), dtype=f32, device=dev)
        sdot = torch.empty((b, nc, h, nblk), dtype=f32, device=dev)
        rqx = torch.empty((3, b, h, nc * cs), dtype=f32, device=dev)
        dBh = torch.empty((2, b, l, h, n), dtype=f32, device=dev)
        dA_part = torch.empty((b, nc, h), dtype=f32, device=dev)
        _launch(dev, "ssd_scan_bwd_f32", *common, _ptr(acum),
                _ptr(states[0]), _ptr(states[1]), _ptr(sdot), _ptr(rqx),
                _ptr(dBh[0]), _ptr(dBh[1]), _ptr(dA_part), b, l, h, g, p, n,
                cs, *strides)
    global bwd_launches
    with _COUNT_LOCK:
        bwd_launches += 1
    return dx, ddt, dA, dB, dC, dinit


def bwd_bf16_attrs(device: torch.device) -> dict:
    """Each of the bfloat16 backward's own kernels: registers a thread,
    spilled (local) bytes a thread, static and dynamic shared memory a
    block, and blocks a multiprocessor, as the CUDA runtime reports them."""
    out = (ctypes.c_int * (5 * len(BWD_BF16_KERNELS)))()
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    err = _entry("ssd_scan_bwd_bf16_attrs")(index, out)
    if err:
        raise RuntimeError(f"ssd_scan: kernel attributes: CUDA error {err}")
    keys = ("registers", "local_bytes", "static_smem_bytes",
            "dynamic_smem_bytes", "blocks_per_sm")
    return {name: dict(zip(keys, out[5 * k:5 * k + 5]))
            for k, name in enumerate(BWD_BF16_KERNELS)}


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
