"""Public send-order op: the CUDA kernel for CUDA tensors, ``ref`` on CPU.

``magnitude_order`` is what the runtime's worker flush calls to send the
largest updates first (paper §4.2).  It keeps the reference's contract,
``np.argsort(-mags, kind="stable")`` on the f64 magnitudes, so the flush
ships updates in the same order on either device.

On the card a call launches the kernels of ``kernel.cu``: one for
n <= ``TILE`` (a warp for n <= 32, else one block), and for n > ``TILE`` one
tile sort plus ``ceil(log2(ceil(n / TILE)))`` merge passes
(:func:`launches_per_call`).
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

TILE = 4096            # kernel.cu's kTile: one block's sort
MAX_N = 2 ** 31 - 1    # indices travel as uint32, UINT32_MAX marks padding

_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


@functools.cache
def _entry():
    tile = _build.entry("topk_mag_tile", [])()
    if tile != TILE:
        raise RuntimeError(f"topk_mag: kernel built with tile {tile}, "
                           f"ops.TILE is {TILE}")
    return _build.entry("topk_mag_f64", _ARGS)


def launches_per_call(n: int, k: Optional[int] = None) -> int:
    """Device launches that ``magnitude_order`` makes for ``n`` magnitudes
    and prefix ``k`` (default n) on the card."""
    k = n if k is None else k
    if n == 0 or k == 0:
        return 0
    if n <= TILE:
        return 1
    tiles = -(-n // TILE)
    return 1 + (tiles - 1).bit_length()     # + ceil(log2(tiles)) passes


def magnitude_order(mags: torch.Tensor,
                    k: Optional[int] = None) -> torch.Tensor:
    """The first ``k`` (default all) indices of ``mags`` in descending
    order, ties in first-occurrence order, NaN last.

    ``mags`` is a contiguous 1-D float64 tensor of fewer than 2**31
    elements; the result is int64 on the same device.
    """
    if mags.dim() != 1 or mags.dtype != torch.float64:
        raise TypeError(f"topk_mag: need 1-D float64 magnitudes, got "
                        f"{mags.dtype} of shape {tuple(mags.shape)}")
    if not mags.is_contiguous():
        raise ValueError("topk_mag: magnitudes must be contiguous")
    n = mags.shape[0]
    if n > MAX_N:
        raise ValueError(f"topk_mag: {n} magnitudes; the kernel's indices "
                         f"are 32-bit, so at most {MAX_N}")
    k = n if k is None else int(k)
    if not 0 <= k <= n:
        raise ValueError(f"topk_mag: k={k} outside [0, {n}]")
    if mags.device.type == "cpu":
        return ref.magnitude_order(mags)[:k]
    out = torch.empty(k, dtype=torch.int64, device=mags.device)
    count = launches_per_call(n, k)
    if count == 0:
        return out
    scratch = None
    if n > TILE:
        scratch = torch.empty(24 * (-(-n // TILE) * TILE), dtype=torch.uint8,
                              device=mags.device)
    err = _entry()(mags.device.index, mags.data_ptr(), n, k,
                   None if scratch is None else scratch.data_ptr(),
                   out.data_ptr(),
                   torch.cuda.current_stream(mags.device).cuda_stream)
    if err:
        raise RuntimeError(f"topk_mag kernel launch failed: CUDA error {err}")
    global launches
    with _COUNT_LOCK:
        launches += count
    return out
