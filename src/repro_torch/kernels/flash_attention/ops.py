"""Public flash-attention op: the CUDA kernel for CUDA tensors, ``ref`` on
CPU.

``flash_attention`` is what the port's ``attention_core_dispatch`` calls for
the full-sequence (prefill) attention of
:func:`repro_torch.models.attention.attn_fwd`.  Its contract is the TPU
kernel's (``flash_attention/kernel.py:86``): positions are shared by the
batch, ``q_pos`` (sq,) and ``k_pos`` (skv,), and 2-D positions are refused
with ``ValueError`` on either device; decode, whose positions differ per
request, keeps the plain version (``ref.attention``).  The kernel has no
backward yet: on the card an input that requires grad under grad mode
raises (:func:`repro_torch.kernels.refuse_grad`); on the CPU the plain
version is differentiated by autograd.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.flash_attention import ref

# kernel launches made by flash_attention (reset by callers that count a run)
launches = 0
_COUNT_LOCK = threading.Lock()

MAX_HEAD_DIM = 256          # dh and dv: the kernel's tile width
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7
         + [ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p])


@functools.cache
def _entry(name: str):
    return _build.entry(name, _ARGS)


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
                    cap: Optional[float] = None) -> torch.Tensor:
    """Masked GQA attention: query head ``(kv, g)`` attends to kv head
    ``kv``; key j is seen by query i where ``k_pos[j] <= q_pos[i]`` and,
    with a window, ``k_pos[j] > q_pos[i] - window``; logits are soft-capped
    by ``cap`` (tanh) where given; a row with no key gives 0.

    q (b, sq, kvh, G, dh), k (b, skv, kvh, dh), v (b, skv, kvh, dv), q_pos
    (sq,) and k_pos (skv,) integers (``2**30`` marks an empty key slot).
    Returns (b, sq, kvh, G, dv) in q's dtype.  On the card q, k, v are all
    bfloat16 (the tensor-core kernel: dh and dv multiples of 16, at most
    256, P rounded to bfloat16 for the second product) or all float32 (the
    float32-pipe kernel: dh a multiple of 4, dh and dv at most 256), with
    float32 accumulators; anything else raises.
    """
    _check(q, k, v, q_pos, k_pos)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, q_pos, k_pos, window=window, cap=cap)
    refuse_grad("flash_attention", q, k, v)
    b, sq, kvh, G, dh = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    out = torch.empty((b, sq, kvh, G, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if skv == 0:                # no key at all: every row gives 0
        return out.zero_()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bfloat16 kernel reads q, k, v "
                         "with TMA, which needs 16-byte aligned tensors")
    qp = q_pos.to(torch.int32).contiguous()
    kp = k_pos.to(torch.int32).contiguous()
    err = _entry(_ENTRY[q.dtype])(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qp.data_ptr(), kp.data_ptr(), out.data_ptr(), b, sq, skv, kvh, G, dh,
        dv, -1 if window is None else int(window),
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
    return out
