#!/usr/bin/env python3
"""Time ``repro_torch.kernels.flash_attention.ops.flash_attention_bwd`` on
the card.

The call is timed as RecurrentGemma-9B's train step makes it: q (2 x 4,096
x 1 x 16 x 256), k and v (2 x 4,096 x 1 x 256) in bfloat16, a window of
2,048, no softcap, the forward's output, log-sum-exp and output residual
(as training's forward writes them), dout in q's dtype; inputs drawn on
the card from ``--seed``.  With ``--library``, beside it, one library call
for the same function: the backward of
``scaled_dot_product_attention`` with the window as a boolean mask (its
forward run once outside the timing).  Whatever ``ops.flash_attention_bwd``
runs is timed, so pointing PYTHONPATH at another checkout's ``src`` times
that tree's version:

    PYTHONPATH=src python3 tools/time_flash_bwd.py
    PYTHONPATH=/path/to/other/checkout/src python3 tools/time_flash_bwd.py

Prints one JSON line: the tree's path, the card's name and power limit,
the median of ``--reps`` CUDA-event times in ms, TFLOP/s (2 (3 dh + 2 dv)
flops a kept pair), the share of the bound (those flops at the bf16
tensor-core peak of 989 TFLOP/s), the profiler's device time per call by
kernel name, the kernels' registers and shared memory where the tree
reports them, and with ``--library`` the library call's time.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

PEAK_BF16 = 989e12


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
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
        us = getattr(e, "device_time_total", 0) or 0
        if us and "Memcpy" not in e.key and "Memset" not in e.key:
            out[e.key[:80]] = us / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--library", action="store_true",
                   help="also time scaled_dot_product_attention's backward")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_bwd: no CUDA device")
    from repro_torch.kernels.flash_attention import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    b, s, kvh, G, d, window = 2, 4096, 1, 16, 256, 2048
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                            - window)
    pairs = int(mask.sum()) * b * kvh * G
    flops = 2 * pairs * 5 * d
    out = {"tree": ops.__file__, "q": [b, s, kvh, G, d], "window": window,
           "pairs": pairs, "flops": flops, "reps": args.reps,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()
    q, k, v = randn(b, s, kvh, G, d), randn(b, s, kvh, d), randn(b, s, kvh, d)
    dout = randn(b, s, kvh, G, d)
    # the forward as training runs it; a tree from before the output's
    # rounding residual returns (out, lse) alone
    o, lse, *lo = ops.flash_attention(q, k, v, pos, pos, window, None,
                                      return_lse=True)
    kw = {"out_lo": lo[0]} if lo else {}

    def call():
        return ops.flash_attention_bwd(q, k, v, pos, pos, o, lse, dout,
                                       window, None, **kw)
    ms = cuda_ms(call, args.reps)
    out.update(ms=ms, tflops=flops / ms / 1e9,
               bound_share=flops / PEAK_BF16 * 1e3 / ms,
               by_kernel_ms=by_kernel(call, 3))
    if hasattr(ops, "bwd_bf16_attrs"):     # an older tree may not have it
        out["kernel_attrs"] = ops.bwd_bf16_attrs(dev)
    if args.library:
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * G, s, d) \
            .detach().requires_grad_(True)
        ks = k.permute(0, 2, 1, 3).detach().requires_grad_(True)
        vs = v.permute(0, 2, 1, 3).detach().requires_grad_(True)
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                               enable_gqa=True)
        do_lib = dout.permute(0, 2, 3, 1, 4).reshape(o_lib.shape)
        out["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o_lib, (qs, ks, vs), do_lib, retain_graph=True), args.reps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
