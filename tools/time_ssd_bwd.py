#!/usr/bin/env python3
"""Time ``repro_torch.kernels.ssd_scan.ops.ssd_scan_bwd`` on the card.

The call is timed as Mamba2-130M's training step makes it: x (4 x 4,096 x
24 x 64), B and C (4 x 4,096 x 1 x 128) as column slices of one projection
(Mamba2's ``xBC``), chunk 256, dt and A float32, dy in x's dtype, no initial
state and no dfinal.  Inputs are drawn on the card from ``--seed``.
Whatever ``ops.ssd_scan_bwd`` runs is timed, so pointing PYTHONPATH at
another checkout's ``src`` times that tree's version:

    PYTHONPATH=src python3 tools/time_ssd_bwd.py
    PYTHONPATH=/path/to/other/checkout/src python3 tools/time_ssd_bwd.py

Prints one JSON line: the tree's path, the card's name and power limit,
and per dtype the median of ``--reps`` CUDA-event times in ms and the
profiler's device time per call by kernel name.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
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


def by_kernel(fn, calls: int) -> dict:
    """The profiler's device ms per call of fn, summed by kernel name."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us and "Memcpy" not in e.key and "Memset" not in e.key:
            out[e.key[:60]] = us / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--dtypes", nargs="+", default=["bfloat16"],
                   choices=["bfloat16", "float32"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_ssd_bwd: no CUDA device")
    from repro_torch.kernels.ssd_scan import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    b, l, h, p_, gr, n, chunk = 4, 4096, 24, 64, 1, 128, 256
    out = {"tree": ops.__file__, "x": [b, l, h, p_], "B": [b, l, gr, n],
           "chunk": chunk, "reps": args.reps,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    for name in args.dtypes:
        dtype = getattr(torch, name)
        xbc = torch.randn((b, l, h * p_ + 2 * gr * n), generator=g,
                          device=dev).to(dtype)
        x = xbc[..., :h * p_].reshape(b, l, h, p_)
        B = xbc[..., h * p_:h * p_ + gr * n].reshape(b, l, gr, n)
        C = xbc[..., h * p_ + gr * n:].reshape(b, l, gr, n)
        dt = torch.nn.functional.softplus(
            torch.randn((b, l, h), generator=g, device=dev) - 1.0)
        A = -torch.exp(torch.randn((h,), generator=g, device=dev) * 0.5)
        dy = torch.randn((b, l, h, p_), generator=g, device=dev).to(dtype)

        def call():
            return ops.ssd_scan_bwd(x, dt, A, B, C, chunk, None, dy, None)
        out[name + "_ms"] = cuda_ms(call, args.reps)
        out[name + "_by_kernel_ms"] = by_kernel(call, 5)
        del xbc, x, B, C, dt, A, dy
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
