"""Public RG-LRU ops: the CUDA kernel for CUDA tensors, ``ref`` on CPU.

``rglru`` is what :func:`repro_torch.models.recurrent.rglru_fwd` runs over a
whole sequence (prefill): on the card one launch computes the gates, the
recurrence and h's cast, as the reference's ``rglru_pallas`` computes the
gates in jnp around its recurrence kernel.  ``linear_recurrence`` is the
bare recurrence (the reference's ``linear_recurrence_pallas``), the same
kernel with the gates left out.  Decode runs the plain ``rglru_step``.
Neither kernel has a backward yet: on the card an input that requires grad
under grad mode raises (:func:`repro_torch.kernels.refuse_grad`); on the
CPU the plain versions are differentiated by autograd.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.rglru_scan import ref

# kernel launches made by rglru and linear_recurrence, in all and by entry
# (reset by callers that count a run)
launches = 0
_COUNT_LOCK = threading.Lock()

_P, _I = ctypes.c_void_p, ctypes.c_int64
_RGLRU_ARGS = [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
               ctypes.c_double, _P]
_ARGS = {"rglru_bf16": _RGLRU_ARGS, "rglru_f32": _RGLRU_ARGS,
         "linear_recurrence_f32": [ctypes.c_int, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _P]}
RGLRU_ENTRIES = {torch.bfloat16: "rglru_bf16", torch.float32: "rglru_f32"}
launches_by_entry = dict.fromkeys(_ARGS, 0)

rglru_step = ref.rglru_step


@functools.cache
def _entry(name: str):
    return _build.entry(name, _ARGS[name])


def _check(name: str, ins: Sequence[torch.Tensor],
           initial: Optional[torch.Tensor], dtypes: Sequence[torch.dtype],
           a_param: Optional[torch.Tensor] = None) -> None:
    """Shapes and devices everywhere; on the card also the dtypes the
    kernel takes (``dtypes``), all inputs in one of them."""
    shape = tuple(ins[0].shape)
    if len(shape) != 3 or any(tuple(t.shape) != shape for t in ins):
        raise ValueError(f"{name}: need (batch, l, w) inputs of one shape, "
                         f"got {[tuple(t.shape) for t in ins]}")
    if a_param is not None and tuple(a_param.shape) != (shape[2],):
        raise ValueError(f"{name}: a_param {tuple(a_param.shape)} is not "
                         f"(w,) = ({shape[2]},)")
    if initial is not None and tuple(initial.shape) != (shape[0], shape[2]):
        raise ValueError(f"{name}: initial {tuple(initial.shape)} is not "
                         f"(batch, w) = ({shape[0]}, {shape[2]})")
    extra = [t for t in (a_param, initial) if t is not None]
    if len({t.device for t in (*ins, *extra)}) != 1:
        raise ValueError(f"{name}: tensors must share a device")
    if ins[0].device.type == "cpu":
        return
    if shape[0] > 65535:
        raise ValueError(f"{name}: batch {shape[0]} exceeds the kernel's "
                         f"grid (65,535)")
    if max(shape[1:]) >= 2**31:
        raise ValueError(f"{name}: l and w {shape[1:]} must be below 2^31, "
                         f"the kernel's int32 coordinates")
    got = [t.dtype for t in ins] + ([a_param.dtype] if a_param is not None
                                    else [])
    if got[0] not in dtypes or len(set(got)) != 1:
        raise TypeError(f"{name}: on the card the inputs must all be one of "
                        f"{list(dtypes)}, got {got}")
    if initial is not None and initial.dtype != torch.float32:
        raise TypeError(f"{name}: on the card initial must be float32, got "
                        f"{initial.dtype}")


def _tma_ready(t: torch.Tensor, wp: int) -> torch.Tensor:
    """``t`` as a contiguous tensor of row length ``wp`` whose rows TMA can
    address (16-byte aligned, a multiple of 16 bytes long): itself where it
    is one, else a zero-padded copy."""
    if t.is_contiguous() and t.shape[-1] == wp and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((*t.shape[:-1], wp))
    out[..., :t.shape[-1]] = t
    return out


def _launch(name: str, ins: Sequence[torch.Tensor],
            initial: Optional[torch.Tensor],
            a_param: Optional[torch.Tensor] = None, c: float = 0.0,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of entry ``name`` over ``ins`` (b, l, w), with the gates'
    ``a_param`` and ``c`` where it computes them.  Returns (h in the inputs'
    dtype, h_last float32)."""
    fn = _entry(name)
    bsz, l, w = ins[0].shape
    dev = ins[0].device
    if bsz * l * w == 0:
        return (torch.empty((bsz, l, w), dtype=ins[0].dtype, device=dev),
                torch.zeros((bsz, w), dtype=torch.float32, device=dev)
                if initial is None else initial.clone())
    wp = w + (-w) % (16 // ins[0].element_size())
    ins = [_tma_ready(t, wp) for t in ins]
    init = None if initial is None else initial.contiguous()
    h = torch.empty((bsz, l, wp), dtype=ins[0].dtype, device=dev)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=dev)
    args = [t.data_ptr() for t in ins]
    if a_param is not None:
        a_param = a_param.contiguous()
        args.append(a_param.data_ptr())
    args += [None if init is None else init.data_ptr(), h.data_ptr(),
             h_last.data_ptr(), bsz, l, w, wp]
    if a_param is not None:
        args.append(c)
    err = fn(dev.index, *args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel ({name}) launch failed: "
                           f"{'CUDA error' if err > 0 else 'CUresult'} "
                           f"{abs(err)}")
    global launches
    with _COUNT_LOCK:
        launches += 1
        launches_by_entry[name] += 1
    return (h if wp == w else h[..., :w].contiguous()), h_last


def linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                      initial: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t ⊙ h_{t-1} + b_t over (batch, l, w), the state in float32.

    Returns (h (batch, l, w) in b's dtype, h_last (batch, w) float32, the
    state after the last step).  On the card a, b and ``initial`` are
    float32; a CPU tensor takes the plain version, which takes any floating
    dtype."""
    _check("linear_recurrence", (a, b), initial, (torch.float32,))
    if a.device.type == "cpu":
        return ref.linear_recurrence(a, b, initial)
    refuse_grad("linear_recurrence", a, b, initial)
    return _launch("linear_recurrence_f32", (a, b), initial)


def rglru(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
          a_param: torch.Tensor, initial: Optional[torch.Tensor] = None,
          c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over (b, l, w): log a_t = -c softplus(Λ) r_t, h_t = a_t
    h_{t-1} + sqrt(1 - a_t²) (i_t x_t).  Returns (h in x's dtype, h_last
    float32).  On the card one launch; x, r_gate, i_gate and a_param are
    all bfloat16 or all float32, ``initial`` float32.  A CPU tensor takes
    the plain version."""
    _check("rglru", (x, r_gate, i_gate), initial, tuple(RGLRU_ENTRIES),
           a_param)
    if x.device.type == "cpu":
        return ref.rglru(x, r_gate, i_gate, a_param, initial, c)
    refuse_grad("rglru", x, r_gate, i_gate, a_param, initial)
    return _launch(RGLRU_ENTRIES[x.dtype], (x, r_gate, i_gate), initial,
                   a_param, float(c))
