#!/usr/bin/env python3
"""Time ``repro_torch.kernels.rglru_scan.ops``'s calls on the card.

By default ``ops.rglru``'s whole call is timed as the RecurrentGemma-9B
prefill makes it: x, r_gate and i_gate of 4 x 4,096 x 4,096 (4 requests of
4,096 tokens, width 4,096), a_param (4,096,), no initial state, once in
bfloat16 and once in float32.  With ``--backward`` the train call is timed
instead, as RecurrentGemma-9B's training step makes it (2 x 4,096 x 4,096,
both dtypes): the forward as the training path runs it (``rglru_with_states``,
which also writes the state entering every chunk, where the tree has it),
the serve forward at that shape, and ``rglru_bwd`` from the forward's states;
then the bare recurrence's backward in float32.  Each with the profiler's
device time a call by kernel, from a window kept only if it holds every
kernel of every call.

Inputs are drawn on the card from ``--seed``.  Whatever the tree's
``ops`` runs is timed, so pointing PYTHONPATH at another checkout's ``src``
times that tree's version:

    PYTHONPATH=src python3 tools/time_rglru.py [--backward]
    PYTHONPATH=/path/to/other/checkout/src python3 tools/time_rglru.py

Prints one JSON line: the tree's path, the card's name and power limit,
and per call the median of ``--reps`` CUDA-event times in ms.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of fn() between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _kernels(fn, calls: int) -> list:
    """(name, device µs) of every kernel that ``calls`` calls of fn ran."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not any(
                k in e.name for k in ("Memcpy", "Memset")):
            name = e.name.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            out.append((name[:80], e.time_range.elapsed_us()))
    return out


def by_kernel(fn, calls: int = 5, windows: int = 3) -> dict:
    """The profiler's device ms a call of fn, by kernel name, from a window
    of ``calls`` calls that holds ``calls`` times one call's kernels; an
    incomplete window is discarded and another taken, up to ``windows``."""
    fn()
    per_call = len(_kernels(fn, 1))
    seen = []
    for _ in range(windows):
        events = _kernels(fn, calls)
        if len(events) == calls * per_call:
            out = {}
            for name, us in events:
                out[name] = out.get(name, 0.0) + us / 1e3 / calls
            return dict(sorted(out.items(), key=lambda kv: -kv[1]))
        seen.append(len(events))
    raise SystemExit(f"time_rglru: profiler windows of {seen} kernels, not "
                     f"{calls} x {per_call}")


def _timed(fn, reps: int) -> dict:
    return {"ms": cuda_ms(fn, reps), "device_ms_by_kernel": by_kernel(fn)}


def backward(ops, g, dev, reps: int) -> dict:
    """The train call's forwards and backwards (see the module's text)."""
    b, l, w = 2, 4096, 4096
    states = hasattr(ops, "rglru_with_states")        # an older tree: none
    out = {"shape": [b, l, w], "forward_writes_states": states}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((b, l, w), generator=g, device=dev).to(dtype)
        r = torch.rand((b, l, w), generator=g, device=dev).to(dtype)
        i = torch.rand((b, l, w), generator=g, device=dev).to(dtype)
        lam = torch.randn((w,), generator=g, device=dev).to(dtype)
        dh = torch.randn((b, l, w), generator=g, device=dev).to(dtype)
        name = str(dtype).removeprefix("torch.")
        out[name + "_serve_forward"] = _timed(
            lambda: ops.rglru(x, r, i, lam), reps)
        kw = {}
        if states:
            out[name + "_train_forward"] = _timed(
                lambda: ops.rglru_with_states(x, r, i, lam), reps)
            kw["states"] = ops.rglru_with_states(x, r, i, lam)[2]
        out[name + "_backward"] = _timed(
            lambda: ops.rglru_bwd(x, r, i, lam, None, dh, None, **kw), reps)
        del x, r, i, lam, dh, kw
    a = torch.rand((b, l, w), generator=g, device=dev) * 0.3 + 0.699
    bb = torch.randn((b, l, w), generator=g, device=dev) * 0.1
    s0, dl = (torch.randn((b, w), generator=g, device=dev) for _ in range(2))
    dh = torch.randn((b, l, w), generator=g, device=dev)
    kw = ({"states": ops.linear_recurrence_with_states(a, bb, s0)[2]}
          if states else {})
    out["linear_recurrence_backward"] = _timed(
        lambda: ops.linear_recurrence_bwd(a, bb, s0, dh, dl, **kw), reps)
    if hasattr(ops, "bwd_attrs"):
        out["kernel_attrs"] = ops.bwd_attrs(dev)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--backward", action="store_true",
                   help="time the train call's forwards and backwards")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_rglru: no CUDA device")
    from repro_torch.kernels.rglru_scan import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"tree": ops.__file__, "reps": args.reps,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    if args.backward:
        out.update(backward(ops, g, dev, args.reps))
        print(json.dumps(out), flush=True)
        return
    b, l, w = 4, 4096, 4096
    out["shape"] = [b, l, w]
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((b, l, w), generator=g, device=dev).to(dtype)
        r = torch.rand((b, l, w), generator=g, device=dev).to(dtype)
        i = torch.rand((b, l, w), generator=g, device=dev).to(dtype)
        lam = torch.randn((w,), generator=g, device=dev).to(dtype)
        out[str(dtype).removeprefix("torch.") + "_ms"] = cuda_ms(
            lambda: ops.rglru(x, r, i, lam), args.reps)
        del x, r, i, lam
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
