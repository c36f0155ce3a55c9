"""Hand-written Hopper kernels for the parameter-server hot path.

Each kernel lives in its own subpackage with three files:
  kernel.cu — the CUDA C++ source, compiled for sm_90a by :mod:`._build`
  ref.py    — the plain PyTorch version the kernel is held against
  ops.py    — the public wrapper: launch counter, ctypes binding, checks

Dispatch is by the tensor's device and nothing else: a CUDA tensor always
launches the kernel (or raises), a CPU tensor always takes ``ref.py``.  There
is no environment switch and no fallback from one to the other.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; raises if it is not usable.

    Asking for CUDA on a host without a CUDA device is an error, never a
    silent move to the CPU: the caller asks for the CPU explicitly.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the host")
    return dev
