#!/usr/bin/env python3
"""Count the pairs DeepSeek-V2-Lite-16B's MoE layers drop past capacity
while it trains on the card, by the ids it is fed.

The model and the steps are ``chip_smoke.py``'s train_deepseek cell: full
width, 3 of 27 layers (the dense first layer, two MoE layers), 2 x 4,096
tokens a step at the config's capacity factor 1.25 (C 960), Adam at lr
1e-3 with 2 warm-up steps, cvap(2, 1.8e-3), remat, random weights from
``--seed``.  The same initial state trains ``--steps`` steps on each of
three id sources:

* ``synthetic``: SyntheticLM's batches, as the smoke feeds them (a Zipf
  1.1 unigram, runs of bigram continuations);
* ``zipf_iid``: each id drawn alone from SyntheticLM's unigram (the same
  token frequencies, no runs);
* ``uniform``: ids uniform over the vocabulary (the serve phase's
  prompts).

Each step's forward dispatch calls are noted (not remat's recomputation):
the pairs dropped in each MoE layer, the largest expert's share of the
pairs and how many experts were over capacity; beside them the batch's
distinct ids and the most frequent id's share and the ten most frequent
ids' share.

    PYTHONPATH=src python3 tools/moe_drops.py [--seed 0] [--steps 4]

Prints one JSON line a source and a last line with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess

import numpy as np
import torch

ARCH, LAYERS, ROWS, SEQ = "deepseek-v2-lite-16b", 3, 2, 4_096
LR, WARMUP, STALENESS, VALUE_BOUND = 1e-3, 2, 2, 1.8e-3


def id_batches(source: str, vocab: int, seed: int):
    """Batches {'ids', 'labels'} of ROWS x SEQ from ``source``."""
    from repro_torch.data import SyntheticLM, batches

    if source == "synthetic":
        yield from batches(SyntheticLM(vocab, seed=seed), ROWS, SEQ)
    lm = SyntheticLM(vocab, seed=seed)
    rng = np.random.default_rng(seed)
    while True:
        if source == "zipf_iid":
            ids = lm._cdf.searchsorted(rng.random((ROWS, SEQ + 1)),
                                       side="right")
        else:
            ids = rng.integers(0, vocab, (ROWS, SEQ + 1))
        ids = ids.astype(np.int32)
        yield {"ids": ids[:, :-1], "labels": ids[:, 1:].copy()}


def token_stats(ids: np.ndarray) -> dict:
    counts = np.sort(np.unique(ids, return_counts=True)[1])[::-1]
    return {"distinct_ids": int(counts.size),
            "top1_share": float(counts[0] / ids.size),
            "top10_share": float(counts[:10].sum() / ids.size)}


def run_source(source: str, seed: int, n_steps: int, dev) -> dict:
    from repro_torch.configs import ConsistencySpec, TrainConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.state import init_train_state
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    tcfg = TrainConfig(arch=ARCH, optimizer="adam", lr=LR,
                       warmup_steps=WARMUP, seed=seed,
                       consistency=ConsistencySpec(
                           model="cvap", staleness=STALENESS,
                           value_bound=VALUE_BOUND))
    m = cfg.moe
    cap = moe.capacity(m, ROWS * SEQ)
    state = init_train_state(cfg, tcfg, tp=1, dp=1, seed=seed, device=dev)
    step_fn = steps.make_train_step(cfg, tcfg)
    it = id_batches(source, cfg.vocab_size, seed)
    orig, calls = moe.dispatch, []

    def dispatch(mc, probs):
        out = orig(mc, probs)
        if torch._C._current_graph_task_id() == -1:   # not remat's recompute
            calls.append((out[1].detach(), out[2].detach()))
        return out

    out = {"source": source, "capacity_factor": m.capacity_factor,
           "capacity": cap, "pairs_per_layer": ROWS * SEQ * m.top_k,
           "steps": []}
    moe.dispatch = dispatch
    try:
        for _ in range(n_steps):
            batch = next(it)
            calls.clear()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            layers = []
            for expert, keep in calls:
                load = torch.bincount(expert, minlength=m.n_experts)
                layers.append({
                    "dropped": int((~keep).sum()),
                    "dropped_share": float((~keep).float().mean()),
                    "largest_expert_share": float(load.max()
                                                  / expert.numel()),
                    "experts_over_capacity": int((load > cap).sum())})
            out["steps"].append({"loss": float(metrics["loss"]),
                                 **token_stats(batch["ids"]),
                                 "moe_layers": layers})
    finally:
        moe.dispatch = orig
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_drops: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for source in ("synthetic", "zipf_iid", "uniform"):
        print(json.dumps({"nvidia_smi": smi, "seed": args.seed,
                          **run_source(source, args.seed, args.steps,
                                       dev)}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
