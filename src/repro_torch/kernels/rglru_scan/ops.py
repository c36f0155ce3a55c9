"""Public RG-LRU ops: the CUDA kernels for CUDA tensors, ``ref`` on CPU.

``rglru`` is what :func:`repro_torch.models.recurrent.rglru_fwd` runs over a
whole sequence (prefill and training): on the card one launch computes the
gates, the recurrence and h's cast, as the reference's ``rglru_pallas``
computes the gates in jnp around its recurrence kernel.
``linear_recurrence`` is the bare recurrence (the reference's
``linear_recurrence_pallas``), the same kernel with the gates left out.
Decode runs the plain ``rglru_step``.

On the card, where an input requires grad under grad mode, each is a
``torch.autograd.Function`` whose forward launch also writes the float32
state entering every ``CHUNK`` steps (:func:`rglru_with_states`), kept with
``save_for_backward``, and whose backward is :func:`rglru_bwd` /
:func:`linear_recurrence_bwd`, the kernels of ``backward.cu`` (g's chain
alone, then every chunk at once from its saved state); otherwise the
forward launches alone and writes no states (serving).  On the CPU they are
the plain versions, which autograd differentiates as they are; the
``Function``s run there too when called directly, their backward then the
plain ``ref.rglru_bwd`` / ``ref.linear_recurrence_bwd``."""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import ref

# kernel calls made by rglru and linear_recurrence and by their backwards,
# in all and by entry (reset by callers that count a run)
launches = 0
bwd_launches = 0
_COUNT_LOCK = threading.Lock()

_P, _I = ctypes.c_void_p, ctypes.c_int64
_RGLRU_ARGS = [ctypes.c_int] + [_P] * 8 + [_I] * 4 + [ctypes.c_double, _P]
_RGLRU_BWD_ARGS = [ctypes.c_int] + [_P] * 14 + [_I] * 4 + [ctypes.c_double,
                                                          _P]
_FWD_ARGS = {"rglru_bf16": _RGLRU_ARGS, "rglru_f32": _RGLRU_ARGS,
             "linear_recurrence_f32": [ctypes.c_int] + [_P] * 6 + [_I] * 4
             + [_P]}
_BWD_ARGS = {"rglru_bwd_bf16": _RGLRU_BWD_ARGS,
             "rglru_bwd_f32": _RGLRU_BWD_ARGS,
             "linear_recurrence_bwd_f32": [ctypes.c_int] + [_P] * 9
             + [_I] * 4 + [_P]}
_ARGS = {**_FWD_ARGS, **_BWD_ARGS,
         "rglru_bwd_attrs": [ctypes.c_int, _P]}
RGLRU_ENTRIES = {torch.bfloat16: "rglru_bf16", torch.float32: "rglru_f32"}
RGLRU_BWD_ENTRIES = {torch.bfloat16: "rglru_bwd_bf16",
                     torch.float32: "rglru_bwd_f32"}
launches_by_entry = dict.fromkeys(_FWD_ARGS, 0)
bwd_launches_by_entry = dict.fromkeys(_BWD_ARGS, 0)
CHUNK = 32          # steps a chunk: the forward's tile (kSteps), whose
                    # entering states the backward restarts from
# the backward's kernels, in the order rglru_bwd_attrs reports them
BWD_KERNELS = ("rglru_bwd_chain_kernel bf16", "rglru_bwd_chunk_kernel bf16",
               "rglru_bwd_chain_kernel f32", "rglru_bwd_chunk_kernel f32",
               "rglru_bwd_chain_kernel bare", "rglru_bwd_chunk_kernel bare",
               "rglru_bwd_dparam_kernel bf16", "rglru_bwd_dparam_kernel f32")

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


def _row_stride(t: torch.Tensor) -> int:
    """The row length, in elements, that TMA can address: w rounded up to
    16 bytes."""
    w = t.shape[-1]
    return w + (-w) % (16 // t.element_size())


def _states_buffer(like: torch.Tensor) -> torch.Tensor:
    """The float32 (b, ceil(l / CHUNK), w) buffer of the state entering
    every chunk."""
    bsz, l, w = like.shape
    return torch.empty((bsz, -(-l // CHUNK), w), dtype=torch.float32,
                       device=like.device)


def _launch(name: str, ins: Sequence[torch.Tensor],
            initial: Optional[torch.Tensor],
            a_param: Optional[torch.Tensor] = None, c: float = 0.0,
            states: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of entry ``name`` over ``ins`` (b, l, w), with the gates'
    ``a_param`` and ``c`` where it computes them, also writing the state
    entering every chunk into ``states`` where given.  Returns (h in the
    inputs' dtype, h_last float32)."""
    fn = _entry(name)
    bsz, l, w = ins[0].shape
    dev = ins[0].device
    if bsz * l * w == 0:
        return (torch.empty((bsz, l, w), dtype=ins[0].dtype, device=dev),
                torch.zeros((bsz, w), dtype=torch.float32, device=dev)
                if initial is None else initial.clone())
    wp = _row_stride(ins[0])
    ins = [_tma_ready(t, wp) for t in ins]
    init = None if initial is None else initial.contiguous()
    h = torch.empty((bsz, l, wp), dtype=ins[0].dtype, device=dev)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=dev)
    args = [t.data_ptr() for t in ins]
    if a_param is not None:
        a_param = a_param.contiguous()
        args.append(a_param.data_ptr())
    args += [None if init is None else init.data_ptr(), h.data_ptr(),
             h_last.data_ptr(), _ptr(states), bsz, l, w, wp]
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


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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
    if _wants_grad(a, b, initial):
        return _LinearRecurrence.apply(a, b, initial)
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
    if _wants_grad(x, r_gate, i_gate, a_param, initial):
        return _RGLRU.apply(x, r_gate, i_gate, a_param, initial, c)
    return _launch(RGLRU_ENTRIES[x.dtype], (x, r_gate, i_gate), initial,
                   a_param, float(c))


def rglru_with_states(x: torch.Tensor, r_gate: torch.Tensor,
                      i_gate: torch.Tensor, a_param: torch.Tensor,
                      initial: Optional[torch.Tensor] = None, c: float = 8.0,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`rglru`'s forward as the training path runs it: (h, h_last,
    states), states (b, ceil(l / CHUNK), w) float32 the state entering
    every chunk, which :func:`rglru_bwd` restarts from.  On the card the
    same one launch, writing the states too; a CPU tensor takes the plain
    versions (``ref.rglru_states``).  No graph."""
    _check("rglru", (x, r_gate, i_gate), initial, tuple(RGLRU_ENTRIES),
           a_param)
    if x.device.type == "cpu":
        return (*ref.rglru(x, r_gate, i_gate, a_param, initial, c),
                ref.rglru_states(x, r_gate, i_gate, a_param, initial, c,
                                 CHUNK))
    states = _states_buffer(x)
    h, h_last = _launch(RGLRU_ENTRIES[x.dtype], (x, r_gate, i_gate), initial,
                        a_param, float(c), states)
    return h, h_last, states


def linear_recurrence_with_states(a: torch.Tensor, b: torch.Tensor,
                                  initial: Optional[torch.Tensor] = None):
    """:func:`linear_recurrence`'s forward with its chunks' entering states,
    as :func:`rglru_with_states`."""
    _check("linear_recurrence", (a, b), initial, (torch.float32,))
    if a.device.type == "cpu":
        return (*ref.linear_recurrence(a, b, initial),
                ref.linear_recurrence_states(a, b, initial, CHUNK))
    states = _states_buffer(a)
    h, h_last = _launch("linear_recurrence_f32", (a, b), initial,
                        states=states)
    return h, h_last, states


class _RGLRU(torch.autograd.Function):
    """:func:`rglru` with its gradient, :func:`rglru_bwd`: the kernels on
    the card, the plain versions on the CPU.  The forward's states are
    saved with the inputs, so a checkpoint drops and rebuilds them with
    the rest."""

    @staticmethod
    def forward(ctx, x, r_gate, i_gate, a_param, initial, c):
        ctx.set_materialize_grads(False)
        ctx.c = c
        if x.device.type == "cpu":
            h, h_last = ref.rglru(x, r_gate, i_gate, a_param, initial, c)
            states = None
        else:
            h, h_last, states = rglru_with_states(x, r_gate, i_gate,
                                                  a_param, initial, c)
        ctx.save_for_backward(x, r_gate, i_gate, a_param, initial, states)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        x, r_gate, i_gate, a_param, initial, states = ctx.saved_tensors
        return (*rglru_bwd(x, r_gate, i_gate, a_param, initial, dh, dh_last,
                           ctx.c, states=states), None)


class _LinearRecurrence(torch.autograd.Function):
    """:func:`linear_recurrence` with its gradient,
    :func:`linear_recurrence_bwd`."""

    @staticmethod
    def forward(ctx, a, b, initial):
        ctx.set_materialize_grads(False)
        if a.device.type == "cpu":
            h, h_last = ref.linear_recurrence(a, b, initial)
            states = None
        else:
            h, h_last, states = linear_recurrence_with_states(a, b, initial)
        ctx.save_for_backward(a, b, initial, states)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, b, initial, states = ctx.saved_tensors
        return linear_recurrence_bwd(a, b, initial, dh, dh_last,
                                     states=states)


def _check_bwd(name: str, ins: Sequence[torch.Tensor],
               dh: Optional[torch.Tensor],
               dh_last: Optional[torch.Tensor], dtype) -> None:
    """The cotangents against the inputs: shapes and devices everywhere; on
    the card dh in ``dtype``, dh_last float32 and at most 65,535 chunks."""
    bsz, l, w = ins[0].shape
    if (dh is not None and tuple(dh.shape) != (bsz, l, w)) or (
            dh_last is not None and tuple(dh_last.shape) != (bsz, w)):
        raise ValueError(f"{name}: dh {None if dh is None else tuple(dh.shape)}"
                         f" / dh_last "
                         f"{None if dh_last is None else tuple(dh_last.shape)}"
                         f" do not match ({bsz}, {l}, {w})")
    if any(t is not None and t.device != ins[0].device
           for t in (dh, dh_last)):
        raise ValueError(f"{name}: tensors must share a device")
    if ins[0].device.type == "cpu":
        return
    if -(-l // CHUNK) > 65535:
        raise ValueError(f"{name}: {-(-l // CHUNK)} chunks of {CHUNK} steps "
                         f"exceed the kernel's grid (65,535)")
    if (dh is not None and dh.dtype != dtype) or (
            dh_last is not None and dh_last.dtype != torch.float32):
        raise TypeError(f"{name}: on the card dh must be {dtype} and dh_last "
                        f"float32, got "
                        f"{None if dh is None else dh.dtype} / "
                        f"{None if dh_last is None else dh_last.dtype}")


def _check_states(name: str, like: torch.Tensor,
                  states: torch.Tensor) -> None:
    """The forward's states against the inputs (b, l, w): (b, ceil(l /
    CHUNK), w) float32 on their device."""
    bsz, l, w = like.shape
    want = (bsz, -(-l // CHUNK), w)
    if tuple(states.shape) != want or states.device != like.device:
        raise ValueError(f"{name}: states {tuple(states.shape)} on "
                         f"{states.device} are not {want} on {like.device}")
    if states.dtype != torch.float32:
        raise TypeError(f"{name}: states must be float32, got "
                        f"{states.dtype}")


def _launch_bwd(name: str, ins: Sequence[torch.Tensor],
                outs: Sequence[torch.Tensor], states, dh, dh_last, dinit,
                a_param: Optional[torch.Tensor] = None, c: float = 0.0):
    """One call of backward entry ``name`` over ``ins`` (b, l, w), restarting
    from the forward's ``states``, writing ``outs`` (their cotangents, then
    da_param's where the entry computes the gates from ``a_param``) and
    ``dinit``: g's chain, every chunk at once, and with the gates dΛ's
    sum (three launches; two without the gates)."""
    bsz, l, w = ins[0].shape
    dev = ins[0].device
    wp = _row_stride(ins[0])
    ins = [_tma_ready(t, wp) for t in ins]
    dh = None if dh is None else _tma_ready(dh, wp)
    states, dh_last = states.contiguous(), (
        None if dh_last is None else dh_last.contiguous())
    # float32 scratch (b, chunks, w): the carry entering each chunk from the
    # right, and with the gates each chunk's dΛ partial
    scratch = [torch.empty_like(states)]
    gates = a_param is not None
    if gates:
        scratch.append(torch.empty_like(states))
    ptrs = [*ins, *([a_param] if gates else []), states, dh, dh_last,
            *scratch, *outs, dinit]
    err = _entry(name)(dev.index, *map(_ptr, ptrs), bsz, l, w, wp,
                       *([c] if gates else []),
                       torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan backward ({name}) launch failed: "
                           f"{'CUDA error' if err > 0 else 'CUresult'} "
                           f"{abs(err)}")
    global bwd_launches
    with _COUNT_LOCK:
        bwd_launches += 1
        bwd_launches_by_entry[name] += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _outputs(like: Sequence[torch.Tensor], initial, dh_last, steps: bool):
    """The cotangents' buffers: one like each of ``like`` (contiguous), and
    dinit where there is an initial state; with no step (l = 0, or no lane)
    zeros and dh_last passed through to dinit."""
    if steps:
        return ([torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in like],
                None if initial is None else torch.empty_like(
                    initial, memory_format=torch.contiguous_format))
    return ([torch.zeros_like(t) for t in like],
            None if initial is None else torch.zeros_like(initial)
            if dh_last is None else dh_last.float().clone())


def linear_recurrence_bwd(a: torch.Tensor, b: torch.Tensor,
                          initial: Optional[torch.Tensor],
                          dh: Optional[torch.Tensor],
                          dh_last: Optional[torch.Tensor] = None,
                          states: Optional[torch.Tensor] = None):
    """The vector-Jacobian product of :func:`linear_recurrence`: given dh
    (batch, l, w) and dh_last (batch, w) (either may be None), returns (da,
    db, dinitial), dinitial None without an initial state.  On the card
    everything is float32 (one call of ``linear_recurrence_bwd_f32``),
    restarting from the forward's ``states``
    (:func:`linear_recurrence_with_states`); without them the forward's
    launch writes them first.  A CPU tensor takes
    ``ref.linear_recurrence_bwd`` (``states`` unused)."""
    _check("linear_recurrence_bwd", (a, b), initial, (torch.float32,))
    _check_bwd("linear_recurrence_bwd", (a, b), dh, dh_last, torch.float32)
    if a.device.type == "cpu":
        return ref.linear_recurrence_bwd(a, b, initial, dh, dh_last)
    if states is not None:
        _check_states("linear_recurrence_bwd", a, states)
    outs, dinit = _outputs((a, b), initial, dh_last, a.numel() > 0)
    if a.numel():
        if states is None:
            states = linear_recurrence_with_states(a, b, initial)[2]
        _launch_bwd("linear_recurrence_bwd_f32", (a, b), outs, states, dh,
                    dh_last, dinit)
    return (*outs, dinit)


def rglru_bwd(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
              a_param: torch.Tensor, initial: Optional[torch.Tensor],
              dh: Optional[torch.Tensor],
              dh_last: Optional[torch.Tensor] = None, c: float = 8.0,
              states: Optional[torch.Tensor] = None):
    """The vector-Jacobian product of :func:`rglru`: given dh (b, l, w) in
    h's dtype and dh_last (b, w) float32 (either may be None), returns (dx,
    dr, di, da_param, dinitial): the first four in x's dtype, dinitial
    float32 (None without an initial state).  On the card one call of
    ``rglru_bwd_bf16`` / ``rglru_bwd_f32`` (three launches: g's chain, the
    chunks from the forward's ``states`` (:func:`rglru_with_states`), dΛ's
    sum); without ``states`` the forward's launch writes them first.  A CPU
    tensor takes ``ref.rglru_bwd`` (``states`` unused)."""
    _check("rglru_bwd", (x, r_gate, i_gate), initial, tuple(RGLRU_ENTRIES),
           a_param)
    _check_bwd("rglru_bwd", (x, r_gate, i_gate), dh, dh_last, x.dtype)
    if x.device.type == "cpu":
        return ref.rglru_bwd(x, r_gate, i_gate, a_param, initial, dh,
                             dh_last, c)
    if states is not None:
        _check_states("rglru_bwd", x, states)
    a_param = a_param.contiguous()
    outs, dinit = _outputs((x, r_gate, i_gate, a_param), initial, dh_last,
                           x.numel() > 0)
    if x.numel():
        if states is None:
            states = rglru_with_states(x, r_gate, i_gate, a_param, initial,
                                       c)[2]
        _launch_bwd(RGLRU_BWD_ENTRIES[x.dtype], (x, r_gate, i_gate), outs,
                    states, dh, dh_last, dinit, a_param, float(c))
    return (*outs, dinit)


def bwd_attrs(device: torch.device) -> dict:
    """Each of the backward's kernels (``BWD_KERNELS``): registers a thread,
    spilled (local) bytes a thread, static and dynamic shared memory a
    block, and blocks a multiprocessor, as the CUDA runtime reports
    them."""
    out = (ctypes.c_int * (5 * len(BWD_KERNELS)))()
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    err = _entry("rglru_bwd_attrs")(index, out)
    if err:
        raise RuntimeError(f"rglru_bwd: kernel attributes: CUDA error {err}")
    keys = ("registers", "local_bytes", "static_smem_bytes",
            "dynamic_smem_bytes", "blocks_per_sm")
    return {name: dict(zip(keys, out[5 * i:5 * i + 5]))
            for i, name in enumerate(BWD_KERNELS)}
