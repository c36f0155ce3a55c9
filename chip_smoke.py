#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port runs on the card.

Run from the repository root, with no arguments, on a host with one CUDA
device:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

  env      the card's name and power limit (nvidia-smi), the torch and CUDA
           versions, and the time to build the kernels from src/repro_torch.
  lda      the port's main path: run_lda(backend="runtime", device="cuda")
           with a 50,000 x 1,000 float64 word_topic master on the card, the
           kernels' launch counters set to 0 just before and read just after,
           under torch.profiler for the device's busy time by kernel name.
           The shape of every kernel call is noted.  Checks: no violations,
           master == x0 + sum(updates) exactly, every token counted once,
           topic == word_topic.sum(0), a finite rising log-likelihood, and
           both kernels launched.
  kernels  each CUDA kernel against its plain PyTorch version on CPU copies
           of the same inputs, bitwise, at the shapes the lda phase gave it
           (the median call per table, no sentinel rows, as the shard sends
           none) and at a larger stress shape with sentinel rows; its
           time (CUDA events, median of 20 runs after warm-up), the plain
           version's, one PyTorch library call's, and the least time the
           card could take (bytes over 3.35 TB/s, or operations over the
           peak rate, whichever is larger).

Then the kernel table ({"kernels": [...]}), the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.  Any failure raises: the exit code
is non-zero and the last line is not printed.  There is no CPU path.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
PEAK_OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12}   # no tensor
# cores: FP64 and FP32 vector rates of the H100 SXM data sheet
REPS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=REPS, warmup=3) -> float:
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


def host_ms(fn, reps=REPS, warmup=2) -> float:
    """Median host wall time of fn() (CPU work, or work that ends in a
    device-to-host copy)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, nops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def check_ps_apply(dev, R, C, N, dtype, seed, sentinels):
    """At the main path's shapes ``sentinels`` is off, as the shard never
    sends row R; the stress cases plant 2% sentinel no-ops."""
    from repro_torch.kernels.ps_apply import ops, ref

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, size=N).astype(np.int64)   # ~N^2/2R duplicates
    if sentinels:
        rows[rng.random(N) < 0.02] = R
    dense_c = torch.from_numpy(rng.normal(size=(R, C))).to(dtype)
    delta_c = torch.from_numpy(rng.normal(size=(N, C))).to(dtype)
    rows_c = torch.from_numpy(rows)

    want = ref.scatter_add_(dense_c.clone(), rows_c, delta_c)
    got = dense_c.to(dev)
    rows_d, delta_d = rows_c.to(dev), delta_c.to(dev)
    ops.scatter_add_(got, rows_d, delta_d)
    torch.cuda.synchronize()
    err = float((got.cpu() - want).abs().max()) if want.numel() else 0.0
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"ps_apply {R}x{C} N={N} {dtype}: kernel != "
                             f"plain (max abs err {err})")

    # timed as the shard calls it: rows checked on the host beforehand
    ms = cuda_ms(lambda: ops.scatter_add_(got, rows_d, delta_d,
                                          rows_checked=True))
    plain_c = dense_c.clone()
    plain_ms = host_ms(lambda: ref.scatter_add_(plain_c, rows_c, delta_c))
    # the library call has no sentinel: give it the real rows only
    keep = rows_d < R
    lib_rows, lib_delta = rows_d[keep].contiguous(), delta_d[keep].contiguous()
    library_ms = cuda_ms(lambda: got.index_add_(0, lib_rows, lib_delta))

    real = rows[rows < R]
    esize = dense_c.element_size()
    touched = np.unique(real).size
    # touched rows read and written, delta read for the real rows only (a
    # sentinel's delta row is never read), every row index read
    nbytes = 2 * touched * C * esize + real.size * C * esize + N * 8
    bound_ms, bound_by = bound(nbytes, real.size * C, dtype)
    return {"shape": f"dense {R}x{C} rows {N} {str(dtype)[6:]}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "unique_rows": int(touched)}


def check_topk_mag(dev, n, seed):
    from repro_torch.kernels.topk_mag import ops, ref

    rng = np.random.default_rng(seed)
    m = rng.integers(0, max(n // 4, 2), size=n).astype(np.float64)   # ties
    m += rng.integers(0, 2, size=n) * 2.0 ** -40     # below f32 resolution
    m_c = torch.from_numpy(m)
    want = ref.magnitude_order(m_c)
    m_d = m_c.to(dev)
    got = ops.magnitude_order(m_d)
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"topk_mag n={n}: kernel != plain")

    ms = cuda_ms(lambda: ops.magnitude_order(m_d))
    plain_ms = host_ms(lambda: ref.magnitude_order(m_c))
    library_ms = cuda_ms(lambda: torch.argsort(-m_d, stable=True))
    # what the runtime's flush pays per call: H2D, kernel, D2H
    call_ms = host_ms(lambda: ops.magnitude_order(
        torch.from_numpy(m).to(dev)).cpu().numpy())
    bound_ms, bound_by = bound(16 * n, n * n, torch.float64)
    return {"shape": f"mags {n} float64", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "call_ms": call_ms}


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

N_DOCS, VOCAB, TRUE_TOPICS, DOC_LEN = 400, 50_000, 20, 120
N_TOPICS, N_WORKERS, N_SHARDS, N_CLOCKS = 1_000, 4, 2, 3


def run_lda_phase(dev):
    from repro_torch.apps import lda
    from repro_torch.core import policies
    from repro_torch.data import synthetic_corpus
    from repro_torch.kernels.ps_apply import ops as apply_ops
    from repro_torch.kernels.topk_mag import ops as topk_ops

    t = time.perf_counter()
    corpus = synthetic_corpus(n_docs=N_DOCS, vocab_size=VOCAB,
                              n_topics=TRUE_TOPICS, doc_len=DOC_LEN, seed=0)
    corpus_s = time.perf_counter() - t

    # note the shape of every call the runtime makes, for the kernels phase
    calls = {"ps_apply": [], "topk_mag": []}
    scatter_add_, magnitude_order = (apply_ops.scatter_add_,
                                     topk_ops.magnitude_order)

    def noted_scatter_add_(dense, rows, delta, **kw):
        calls["ps_apply"].append((*dense.shape, rows.shape[0]))
        return scatter_add_(dense, rows, delta, **kw)

    def noted_magnitude_order(mags, k=None):
        calls["topk_mag"].append(mags.shape[0])
        return magnitude_order(mags, k)

    apply_ops.scatter_add_ = noted_scatter_add_
    topk_ops.magnitude_order = noted_magnitude_order
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    apply_ops.launches = 0
    topk_ops.launches = 0
    t = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lls, stats, rt = lda.run_lda(
                corpus, n_topics=N_TOPICS, policy=policies.ssp(1),
                n_workers=N_WORKERS, n_clocks=N_CLOCKS, threads_per_process=1,
                n_shards=N_SHARDS, seed=0, backend="runtime",
                collect_stats=True, return_ps=True, device="cuda")
            torch.cuda.synchronize()
    finally:
        apply_ops.scatter_add_ = scatter_add_
        topk_ops.magnitude_order = magnitude_order
    wall_s = time.perf_counter() - t
    launches = {"ps_apply": apply_ops.launches, "topk_mag": topk_ops.launches}
    # device time by kernel / copy name, from the profiler's device events
    device_s = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            device_s[name] = (device_s.get(name, 0.0)
                              + e.time_range.elapsed_us() / 1e6)
    busy_s = sum(device_s.values())
    peak = torch.cuda.max_memory_allocated(dev)

    block = rt.shards[0].dense["word_topic"]
    if not (block.is_cuda and block.dtype == torch.float64
            and tuple(block.shape) == (VOCAB // N_SHARDS, N_TOPICS)):
        raise AssertionError(f"word_topic master block is {block.dtype} "
                             f"{tuple(block.shape)} on {block.device}")
    if stats.violations:
        raise AssertionError(f"violations: {stats.violations[:5]}")
    wt = rt.master_value("word_topic")
    tc = rt.master_value("topic")
    for key, got in (("word_topic", wt), ("topic", tc)):
        if not np.array_equal(got, rt.expected_value(key)):
            raise AssertionError(f"master {key} != x0 + sum(updates)")
    if wt.shape != (VOCAB, N_TOPICS) or wt.sum() != corpus.n_tokens \
            or (wt < 0).any():
        raise AssertionError(f"word_topic {wt.shape} holds {wt.sum()} "
                             f"counts for {corpus.n_tokens} tokens")
    if not np.array_equal(tc, wt.sum(0)):
        raise AssertionError("topic != word_topic.sum(0)")
    if not (np.isfinite(lls).all() and len(lls) == N_CLOCKS
            and lls[-1] > lls[0]):
        raise AssertionError(f"log-likelihood not finite and rising: {lls}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")

    ct = [0.0] + list(stats.clock_times)
    rows_applied = sum(s.m_rows_applied for s in rt.shards)
    emit({"phase": "lda", "n_docs": N_DOCS, "vocab": VOCAB,
          "n_topics": N_TOPICS, "tokens": corpus.n_tokens,
          "workers": N_WORKERS, "shards": N_SHARDS, "policy": "ssp(1)",
          "clocks": N_CLOCKS, "reduced": None, "corpus_s": corpus_s,
          "wall_s": wall_s, "clock_s": [b - a for a, b in zip(ct, ct[1:])],
          "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s,
          "device_s_by_name": dict(sorted(device_s.items(),
                                          key=lambda kv: -kv[1])[:8]),
          "peak_device_bytes": peak, "launches": launches,
          "rows_per_apply": rows_applied / launches["ps_apply"],
          "log_likelihood": lls, "violations": 0, "master_exact": True})
    return launches, calls


def path_shapes(calls):
    """The median call of each kernel on the main path: ps_apply's per
    (R, C) block, heaviest block first, and topk_mag's per length."""
    blocks = {}
    for R, C, N in calls["ps_apply"]:
        blocks.setdefault((R, C), []).append(N)
    apply = [(R, C, statistics.median_low(ns))
             for (R, C), ns in sorted(blocks.items(),
                                      key=lambda kv: -kv[0][0] * kv[0][1])]
    return apply, sorted(set(calls["topk_mag"]))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke test runs "
                 "only on the card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.load()
    regs = re.findall(r"entry function '(\w+)'.*?Used (\d+) registers",
                      _build.BUILD_INFO["log"], re.S)
    emit({"phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": _build.BUILD_INFO["seconds"],
          "build_cached": _build.BUILD_INFO["cached"],
          "registers": {k[-40:]: int(v) for k, v in regs}})

    launches, calls = run_lda_phase(dev)

    # first the main path's median shapes (the table's rows), then stress
    # shapes: a batch 40,000 rows deep with sentinels in f64 and f32, and
    # 4,096 keys
    apply_shapes, topk_lengths = path_shapes(calls)
    R, C, _ = apply_shapes[0]
    cases = {
        "ps_apply": [check_ps_apply(dev, R, C, N, torch.float64, seed, False)
                     for seed, (R, C, N) in enumerate(apply_shapes)]
        + [check_ps_apply(dev, R, C, 40_000, torch.float64, 10, True),
           check_ps_apply(dev, R, C, 40_000, torch.float32, 11, True)],
        "topk_mag": [check_topk_mag(dev, n, 20 + i)
                     for i, n in enumerate(topk_lengths)]
        + [check_topk_mag(dev, 4_096, 30)],
    }
    emit({"phase": "kernels", "tolerance": "bitwise (0)",
          "path_calls": {k: len(v) for k, v in calls.items()},
          "cases": cases})

    source = {"ps_apply": ("src/repro_torch/kernels/ps_apply/kernel.cu",
                           "src/repro/kernels/ps_apply/kernel.py:47"),
              "topk_mag": ("src/repro_torch/kernels/topk_mag/kernel.cu",
                           "src/repro/kernels/topk_mag/kernel.py:41")}
    table = []
    for name, (src, replaces) in source.items():
        main_case = cases[name][0]          # the main path's shape
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      **{k: main_case[k] for k in (
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "shape")}})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
