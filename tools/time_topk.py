#!/usr/bin/env python3
"""Time ``repro_torch.kernels.topk_mag.ops.magnitude_order`` on the card.

For each length in ``--sizes`` it draws f64 magnitudes from ``--seed`` (with
ties, and pairs that differ below f32 resolution), checks the call bitwise
against ``torch.argsort(-m, stable=True)`` on the CPU, and times it: the
median of ``--reps`` CUDA-event times around one call (``ms``) and the
device time per call from torch.profiler, every device event of ``--reps``
calls summed (``device_ms``).  ``torch.argsort(-m, stable=True)`` on the
card is timed the same way beside it (``argsort_ms``,
``argsort_device_ms``).  Whatever ``magnitude_order`` runs is timed, so
pointing PYTHONPATH at another checkout's ``src`` times that tree's version:

    PYTHONPATH=src python3 tools/time_topk.py
    PYTHONPATH=/path/to/other/checkout/src python3 tools/time_topk.py \
        --sizes 2 4096 65536

Prints one JSON line: the tree's path, the card's name and power limit, and
the numbers per length.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
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


def device_ms(fn, reps: int) -> float:
    """Device time per fn() call: the profiler's device events of ``reps``
    calls, summed, over ``reps``.  Run it in a fresh process: late in a
    process that has profiled ~10^5 device events, the profiler loses a
    window's first events."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    if not us or len(us) % reps:
        raise SystemExit(f"time_topk: {len(us)} device events in {reps} "
                         f"calls")
    return sum(us) / reps / 1e3


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="+",
                   default=[2, 4096, 65536, 1048576])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_topk: no CUDA device")
    from repro_torch.kernels.topk_mag import ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    out = {"tree": ops.__file__, "reps": args.reps, "sizes": {},
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    for n in args.sizes:
        m = rng.integers(0, max(n // 4, 2), size=n).astype(np.float64)
        m += rng.integers(0, 2, size=n) * 2.0 ** -40
        m_c = torch.from_numpy(m)
        m_d = m_c.to(dev)
        got = ops.magnitude_order(m_d).cpu()
        if not torch.equal(got, torch.argsort(-m_c, stable=True)):
            raise SystemExit(f"time_topk: n={n}: wrong order")
        out["sizes"][n] = {
            "ms": cuda_ms(lambda: ops.magnitude_order(m_d), args.reps),
            "device_ms": device_ms(lambda: ops.magnitude_order(m_d),
                                   args.reps),
            "argsort_ms": cuda_ms(lambda: torch.argsort(-m_d, stable=True),
                                  args.reps),
            "argsort_device_ms": device_ms(
                lambda: torch.argsort(-m_d, stable=True), args.reps)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
