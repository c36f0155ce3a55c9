"""Public flash-attention op: the CUDA kernels for CUDA tensors, ``ref`` on
CPU.

``flash_attention`` is what the port's ``attention_core_dispatch`` calls for
the full-sequence (prefill and training) attention of
:func:`repro_torch.models.attention.attn_fwd`.  Its contract is the TPU
kernel's (``flash_attention/kernel.py:86``): positions are shared by the
batch, ``q_pos`` (sq,) and ``k_pos`` (skv,), and 2-D positions are refused
with ``ValueError`` on either device; decode, whose positions differ per
request, keeps the plain version (``ref.attention``).

On the card, where q, k or v requires grad under grad mode, it is a
``torch.autograd.Function``: its forward is ``return_lse``'s, which also
writes the rows' log-sum-exp and, in bfloat16, the output's rounding
residual (from which the backward's D = rowsum(dO O) takes the float32
output's precision), and its backward is :func:`flash_attention_bwd`, the
kernels of ``backward.cu``; otherwise the forward launches alone with
neither (serving).  On the CPU it is the plain version, which autograd
differentiates as it is; the ``Function`` runs there too when called
directly, its backward then the plain ``ref.attention_bwd``."""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

# kernel calls made by flash_attention and by its backward, one per call
# (reset by callers that count a run)
launches = 0
bwd_launches = 0
_COUNT_LOCK = threading.Lock()

MAX_HEAD_DIM = 256          # dh and dv: the kernel's tile width
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
             torch.bfloat16: "flash_attention_bwd_bf16"}
_TAIL = [ctypes.c_int64] * 8 + [ctypes.c_double, ctypes.c_double,
                                ctypes.c_void_p]
_ARGS = {**dict.fromkeys(_ENTRY.values(),
                         [ctypes.c_int] + [ctypes.c_void_p] * 8 + _TAIL),
         **dict.fromkeys(BWD_ENTRY.values(),
                         [ctypes.c_int] + [ctypes.c_void_p] * 13 + _TAIL),
         "flash_attention_bwd_bf16_attrs": [ctypes.c_int, ctypes.c_void_p]}
# the bfloat16 backward's kernels, in launch order (the sum only where the
# G heads are split into slices), at d 256
BWD_BF16_KERNELS = ("flash_bwd_dot_kernel", "flash_bwd_kv_wgmma_kernel",
                    "flash_bwd_sum_kernel", "flash_bwd_q_wgmma_kernel")


@functools.cache
def _entry(name: str):
    return _build.entry(name, _ARGS[name])


def _check(q, k, v, q_pos, k_pos) -> None:
    if q_pos.dim() != 1 or k_pos.dim() != 1:
        raise ValueError("flash kernel expects shared (sq,)/(skv,) positions")
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: need q (b, sq, kvh, G, dh), "
                         "k (b, skv, kvh, dh), v (b, skv, kvh, dv)")
    b, sq, kvh, _, dh = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kvh, dh) \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} disagree")
    if q_pos.shape[0] != sq or k_pos.shape[0] != k.shape[1]:
        raise ValueError("flash_attention: positions do not match sq / skv")
    if len({q.device, k.device, v.device, q_pos.device, k_pos.device}) != 1:
        raise ValueError("flash_attention: tensors must share a device")
    if q.device.type == "cpu":
        return
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention: on the card q, k, v must be one "
                        f"of float32 / bfloat16, got {q.dtype} / {k.dtype} / "
                        f"{v.dtype}")
    dv = v.shape[-1]
    if q.dtype == torch.bfloat16:
        if dh % 16 or dv % 16 or dh > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: the bfloat16 kernel takes dh "
                             f"and dv multiples of 16, at most "
                             f"{MAX_HEAD_DIM}; got {dh}, {dv}")
        if max(sq, k.shape[1]) >= 2**31:
            raise ValueError("flash_attention: sq and skv must be < 2^31")
    elif dh % 4 or dh > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes dh a multiple "
                         f"of 4 and dh, dv <= {MAX_HEAD_DIM}; got {dh}, {dv}")
    if b * kvh * q.shape[3] > 65535:
        raise ValueError("flash_attention: b * kvh * G exceeds the kernel's "
                         "grid (65,535)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    window: Optional[int] = None,
                    cap: Optional[float] = None, return_lse: bool = False):
    """Masked GQA attention: query head ``(kv, g)`` attends to kv head
    ``kv``; key j is seen by query i where ``k_pos[j] <= q_pos[i]`` and,
    with a window, ``k_pos[j] > q_pos[i] - window``; logits are soft-capped
    by ``cap`` (tanh) where given; a row with no key gives 0.

    q (b, sq, kvh, G, dh), k (b, skv, kvh, dh), v (b, skv, kvh, dv), q_pos
    (sq,) and k_pos (skv,) integers (``2**30`` marks an empty key slot).
    Returns (b, sq, kvh, G, dv) in q's dtype; with ``return_lse`` the
    saved state :func:`flash_attention_bwd` takes, (out, lse, out_lo), and
    then no autograd graph: lse the rows' log-sum-exp (b, kvh, G, sq)
    float32 (+inf on a row with no key), out_lo in bfloat16 each output
    element's rounding residual bf16(o - bf16(o)) of the float32 output o
    (None in float32).  On the card q, k, v are all bfloat16 (the
    tensor-core kernel: dh and dv multiples of 16, at most 256, P rounded to
    bfloat16 for the second product) or all float32 (the float32-pipe
    kernel: dh a multiple of 4, dh and dv at most 256), with float32
    accumulators; anything else raises.
    """
    _check(q, k, v, q_pos, k_pos)
    if q.device.type == "cpu":
        if not return_lse:
            return ref.attention(q, k, v, q_pos, k_pos, window=window,
                                 cap=cap)
        o = ref.attention(q.float(), k.float(), v.float(), q_pos, k_pos,
                          window=window, cap=cap)
        out = o.to(q.dtype)
        lo = (o - out.float()).to(q.dtype) if q.dtype == torch.bfloat16 \
            else None
        return out, ref.attention_lse(q, k, q_pos, k_pos, window, cap), lo
    if not return_lse and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_pos, k_pos, window, cap)
    out, lse, lo = _forward(q, k, v, q_pos, k_pos, window, cap, return_lse)
    return (out, lse, lo) if return_lse else out


def _forward(q, k, v, q_pos, k_pos, window, cap, with_lse):
    """The forward launch on the card (inputs checked): (out, lse, out_lo)
    with ``with_lse`` (out_lo None in float32), else (out, None, None)."""
    b, sq, kvh, G, dh = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    out = torch.empty((b, sq, kvh, G, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, kvh, G, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lo = (torch.empty_like(out)
          if with_lse and q.dtype == torch.bfloat16 else None)
    if out.numel() == 0 or skv == 0:   # no key at all: every row gives 0
        if lse is not None:
            lse.fill_(math.inf)
        if lo is not None:
            lo.zero_()
        return out.zero_(), lse, lo
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bfloat16 kernel reads q, k, v "
                         "with TMA, which needs 16-byte aligned tensors")
    qp = q_pos.to(torch.int32).contiguous()
    kp = k_pos.to(torch.int32).contiguous()
    err = _entry(_ENTRY[q.dtype])(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
        None if lo is None else lo.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, skv, kvh, G, dh, dv,
        -1 if window is None else int(window),
        0.0 if cap is None else float(cap), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}" + (" (libcuda's CUresult, "
                                             "encoding a TMA tensor map)"
                                             if err < 0 else ""))
    global launches
    with _COUNT_LOCK:
        launches += 1
    return out, lse, lo


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its gradient,
    :func:`flash_attention_bwd`: the kernels on the card (the forward writes
    the rows' log-sum-exp for it, and in bfloat16 the output's rounding
    residual), the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window, cap):
        ctx.window, ctx.cap = window, cap
        out, lse, lo = flash_attention(q, k, v, q_pos, k_pos, window, cap,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse, lo)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, out, lse, lo = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, dout,
                                     ctx.window, ctx.cap, lo),
                None, None, None, None)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, window: Optional[int] = None,
                        cap: Optional[float] = None,
                        out_lo: Optional[torch.Tensor] = None):
    """The vector-Jacobian product of :func:`flash_attention`: given the
    forward's ``out``, ``lse`` and ``out_lo`` (``return_lse=True``) and the
    cotangent ``dout`` (b, sq, kvh, G, dv), returns (dq, dk, dv) in q's
    dtype.  ``out_lo``, out's rounding residual, is required in bfloat16
    and refused in float32, on either device: D = rowsum(dout (out +
    out_lo)) comes from the forward's float32 output, where from the
    bfloat16 ``out`` alone its 2^-9 relative error enters dS where dP and D
    nearly cancel.  On the card one call of ``flash_attention_bwd_bf16`` /
    ``_f32``, with :func:`flash_attention`'s limits and dout and out in q's
    dtype: D, then dk and dv, then dq.  bfloat16 runs every product
    on the tensor cores (P and dS rounded to bfloat16 as operands, float32
    sums; the G heads may be split into slices whose float32 partial dk and
    dv pass through dq's memory and are summed by a fourth launch; q, k, v
    and dout 16-byte aligned for TMA), float32 the float32 pipes.  A CPU
    tensor takes ``ref.attention_bwd``, which recomputes what ``out`` and
    ``lse`` hold."""
    _check(q, k, v, q_pos, k_pos)
    b, sq, kvh, G, dh = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    shape_o = (b, sq, kvh, G, dv)
    if tuple(dout.shape) != shape_o or tuple(out.shape) != shape_o or tuple(
            lse.shape) != (b, kvh, G, sq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, lse "
                         f"{tuple(lse.shape)} and dout {tuple(dout.shape)} do "
                         f"not match q {tuple(q.shape)}, dv {dv}")
    if len({q.device, out.device, lse.device, dout.device}) != 1:
        raise ValueError("flash_attention_bwd: tensors must share a device")
    if q.dtype != torch.bfloat16:
        if out_lo is not None:
            raise ValueError(f"flash_attention_bwd: out_lo is bfloat16's "
                             f"alone, not {q.dtype}'s")
    elif out_lo is None or tuple(out_lo.shape) != shape_o \
            or out_lo.dtype != torch.bfloat16 or out_lo.device != q.device:
        got = None if out_lo is None else (
            f"{tuple(out_lo.shape)} {out_lo.dtype} on {out_lo.device}")
        raise ValueError(f"flash_attention_bwd: a bfloat16 backward needs "
                         f"out_lo, the forward's bfloat16 residual of out "
                         f"{shape_o}; got {got}")
    if q.device.type == "cpu":
        return ref.attention_bwd(q, k, v, q_pos, k_pos, window, cap, dout)
    if out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: out and dout must be "
                        f"{q.dtype} and lse float32, got {out.dtype} / "
                        f"{dout.dtype} / {lse.dtype}")
    dq, dk, dvv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    if q.numel() == 0 or skv == 0 or dv == 0:
        return dq.zero_(), dk.zero_(), dvv.zero_()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, lse, dout = out.contiguous(), lse.contiguous(), dout.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v, dout)):
        raise ValueError("flash_attention_bwd: the bfloat16 kernels read q, "
                         "k, v and dout with TMA, which needs 16-byte "
                         "aligned tensors")
    qp = q_pos.to(torch.int32).contiguous()
    kp = k_pos.to(torch.int32).contiguous()
    dsum = torch.empty((b, kvh, G, sq), dtype=torch.float32, device=q.device)
    err = _entry(BWD_ENTRY[q.dtype])(
        q.device.index, *(t.data_ptr() for t in (q, k, v, qp, kp, out)),
        None if out_lo is None else out_lo.contiguous().data_ptr(),
        *(t.data_ptr() for t in (lse, dout, dq, dk, dvv, dsum)),
        b, sq, skv, kvh, G, dh, dv, -1 if window is None else int(window),
        0.0 if cap is None else float(cap), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}" + (" (libcuda's CUresult, encoding "
                                             "a TMA tensor map)"
                                             if err < 0 else ""))
    global bwd_launches
    with _COUNT_LOCK:
        bwd_launches += 1
    return dq, dk, dvv


def bwd_bf16_attrs(device: torch.device) -> dict:
    """Each of the bfloat16 backward's kernels at d 256: registers a thread,
    spilled (local) bytes a thread, static and dynamic shared memory a
    block, and blocks a multiprocessor, as the CUDA runtime reports them."""
    out = (ctypes.c_int * (5 * len(BWD_BF16_KERNELS)))()
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    err = _entry("flash_attention_bwd_bf16_attrs")(index, out)
    if err:
        raise RuntimeError(f"flash_attention_bwd: kernel attributes: CUDA "
                           f"error {err}")
    keys = ("registers", "local_bytes", "static_smem_bytes",
            "dynamic_smem_bytes", "blocks_per_sm")
    return {name: dict(zip(keys, out[5 * i:5 * i + 5]))
            for i, name in enumerate(BWD_BF16_KERNELS)}
