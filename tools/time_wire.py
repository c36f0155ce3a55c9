#!/usr/bin/env python3
"""Where a wire-transport run of the lda configuration spends its wall.

Run from the repository root on a host with one CUDA device:

    PYTHONPATH=src python3 tools/time_wire.py
    PYTHONPATH=src python3 tools/time_wire.py --transports shm --clocks 3

Part 1, per transport in ``--transports``: chip_smoke.py's lda
configuration (V 50,000 x K 1,000 f64 masters on the card, 400 documents, 4
workers as 4 forked client processes, 2 shards, ssp(1), ``--clocks``
clocks) with stamps on one clock (``time.monotonic``, which the forked
processes share): the clients' start, each client's last clock, the
parent's receipt of every client's final state, the runtime's final
checks, and the shard apply's and outbox's host seconds.

Part 2, the state transfer alone: ``--children`` forked children each ship
a cache and a total at LDA's width (2 x 400 MB of f64) to a parent that
holds a 400 MB tensor on the card, first by ``multiprocessing.Connection``
``send``/``recv`` (the JAX package's way), then by the port's
``transport.send_state``/``recv_state``; the parent receives them in turn.

Prints one JSON line per part, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timeline(transport: str, clocks: int, device: str = "cuda") -> dict:
    """Part 1: one stamped run of the lda configuration."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.core import policies
    from repro_torch.data import synthetic_corpus
    from repro_torch.runtime import runtime as R
    from repro_torch.runtime import shard as S
    from repro_torch.runtime import transport as T

    stamps = {"recv": [], "apply_s": 0.0, "outbox_s": 0.0}
    host_run, recv_state = R._ClientHost.run, T.recv_state
    final_checks = R.PSRuntime._final_checks
    flush, outbox = S.ServerShard._flush_updates, S.ServerShard._flush_outbox

    def run(self):
        out = host_run(self)
        # the child's clock stamps on the shared monotonic clock
        out["last_clock_at"] = self._t0 + self.stats.clock_times[-1]
        out["started_at"] = self._t0
        return out

    def recv(fd, deadline):
        got = recv_state(fd, deadline)
        stamps["recv"].append(time.monotonic())
        return got

    def checks(self):
        stamps["checks_from"] = time.monotonic()
        final_checks(self)
        stamps["checks_to"] = time.monotonic()

    def timed(key, fn):
        def call(self, *a):
            t = time.monotonic()
            try:
                return fn(self, *a)
            finally:
                stamps[key] += time.monotonic() - t
        return call

    corpus = synthetic_corpus(n_docs=cs.N_DOCS, vocab_size=cs.VOCAB,
                              n_topics=cs.TRUE_TOPICS, doc_len=cs.DOC_LEN,
                              seed=0)
    rt, fn = cs._wire_runtime(torch.device(device), corpus,
                              policies.ssp(1), transport)
    R._ClientHost.run, T.recv_state = run, recv
    R.PSRuntime._final_checks = checks
    S.ServerShard._flush_updates = timed("apply_s", flush)
    S.ServerShard._flush_outbox = timed("outbox_s", outbox)
    finals = {}
    merge = R.PSRuntime._merge_finals

    def merge_finals(self, got):
        finals.update(got)
        merge(self, got)

    R.PSRuntime._merge_finals = merge_finals
    try:
        t0 = time.monotonic()
        rt.start(fn, clocks, timeout=600)
        stats = rt.wait()
        t1 = time.monotonic()
    finally:
        R._ClientHost.run, T.recv_state = host_run, recv_state
        R.PSRuntime._final_checks = final_checks
        S.ServerShard._flush_updates, S.ServerShard._flush_outbox = (
            flush, outbox)
        R.PSRuntime._merge_finals = merge
    if stats.violations:
        raise AssertionError(f"{transport}: {stats.violations[:3]}")
    last_clock = max(f["last_clock_at"] for f in finals.values())
    return {"transport": transport, "clocks": clocks, "wall_s": t1 - t0,
            "clients_started_s": max(f["started_at"] for f in finals.values())
            - t0,
            "clients_clocks_done_s": last_clock - t0,
            "states_received_s": max(stamps["recv"]) - t0,
            "final_checks_s": stamps["checks_to"] - stamps["checks_from"],
            "shard_apply_host_s": stamps["apply_s"],
            "shard_outbox_host_s": stamps["outbox_s"]}


def _child(how: str, fd: int, conn, n: int) -> None:
    from repro_torch.runtime import transport as T
    state = {"cache": np.full(n, 1.0), "total": np.full(n, 2.0)}
    if how == "connection":
        conn.send(state)
    else:
        T.send_state(fd, state)
    os._exit(0)


def transfer(children: int, n: int, device: str = "cuda") -> dict:
    """Part 2: the final-state transfer alone, both ways, in one process."""
    from repro_torch.runtime import transport as T

    held = torch.zeros(n, dtype=torch.float64, device=device)
    ctx = multiprocessing.get_context("fork")
    out = {"children": children, "bytes_each": 16 * n}
    for how in ("connection", "send_state"):
        procs, ends = [], []
        for _ in range(children):
            if how == "connection":
                r, w = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_child, args=(how, -1, w, n))
                p.start()
                w.close()
            else:
                r, w = os.pipe()
                p = ctx.Process(target=_child, args=(how, w, None, n))
                p.start()
                os.close(w)
            procs.append(p)
            ends.append(r)
        time.sleep(3.0)                 # every child has its state ready
        t = time.monotonic()
        for r in ends:
            got = (r.recv() if how == "connection"
                   else T.recv_state(r, time.monotonic() + 600))
            if got is None or float(got["total"][-1]) != 2.0:
                raise AssertionError(f"{how}: state lost")
        out[f"{how}_s"] = time.monotonic() - t
        for p in procs:
            p.join(timeout=60)
        for r in ends:
            if how == "connection":
                r.close()
            else:
                os.close(r)
    del held
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--transports", nargs="+", default=["shm", "tcp"],
                    choices=["shm", "tcp"])
    ap.add_argument("--clocks", type=int, default=3)
    ap.add_argument("--children", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_wire: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for transport in args.transports:
        print(json.dumps({"part": "timeline", "card": smi,
                          **timeline(transport, args.clocks)}), flush=True)
    print(json.dumps({"part": "transfer", "card": smi,
                      **transfer(args.children, 50_000_000)}), flush=True)


if __name__ == "__main__":
    main()
