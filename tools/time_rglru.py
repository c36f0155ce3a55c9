#!/usr/bin/env python3
"""Time ``repro_torch.kernels.rglru_scan.ops.rglru``'s whole call on the card.

The call is timed as the RecurrentGemma-9B prefill makes it: x, r_gate and
i_gate of 4 x 4,096 x 4,096 (4 requests of 4,096 tokens, width 4,096),
a_param (4,096,), no initial state, once in bfloat16 and once in float32.
Inputs are drawn on the card from ``--seed``.  Whatever ``ops.rglru`` runs
is timed (gates, kernel and h's cast), so pointing PYTHONPATH at another
checkout's ``src`` times that tree's version:

    PYTHONPATH=src python3 tools/time_rglru.py
    PYTHONPATH=/path/to/other/checkout/src python3 tools/time_rglru.py

Prints one JSON line: the tree's path, the card's name and power limit,
and per dtype the median of ``--reps`` CUDA-event times in ms.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch


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


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_rglru: no CUDA device")
    from repro_torch.kernels.rglru_scan import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    b, l, w = 4, 4096, 4096
    out = {"tree": ops.__file__, "shape": [b, l, w], "reps": args.reps,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
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
