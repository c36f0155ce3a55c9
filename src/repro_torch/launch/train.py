"""The training loop (the port of the JAX package's ``launch/train.py``).

On the card it trains the full-width model; ``--smoke`` takes the reduced
float32 variant, which also runs on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --device cpu --smoke --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --replicas 2 --batch 8 --seq 4096 --steps 8 \\
        --consistency cvap --staleness 2 --vthr 1e-3

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-9b --device cpu --smoke --steps 20

``--replicas k`` stacks k data-parallel replicas on the one card, each on
its own ``batch / k`` rows of every batch, synced by the consistency
policy.  Every architecture trains on the card through the port's kernels
and their backwards (``ssd_scan``, ``rglru_scan``, ``flash_attention``).
The frontend architectures (``pixtral-12b``, ``musicgen-medium``) get
stubbed frontend embeddings drawn each step from the seed, as the
reference draws them:

    PYTHONPATH=src python -m repro_torch.launch.train --arch pixtral-12b \\
        --device cpu --smoke --steps 20

The float32 master, Adam's moments and δ take 16 bytes a parameter, so
RecurrentGemma-9B needs 137 GB at full depth, more than one 80 GB card
holds; ``chip_smoke.py`` trains the larger models at full width and
reduced depth, and MusicGen-medium (1.37 B parameters, 21.8 GB) at full
depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import (ARCHS, ConsistencySpec, TrainConfig,
                                 get_config, reduced_config)
from repro_torch.core.sync import force_sync
from repro_torch.data import SyntheticLM, batches
from repro_torch.kernels import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.state import init_train_state
from repro_torch.models.common import tree_map, tree_map_paths, tree_paths


def run(tcfg: TrainConfig, cfg, mesh=None, batch_size: int = 8,
        seq_len: int = 64, log=print, device="cuda", replicas: int = 1):
    """Train ``tcfg.steps`` steps of ``cfg`` on ``device`` over
    ``replicas`` replicas stacked on it; ``batch_size`` is the global batch
    (``batch_size / replicas`` rows a replica).  Returns (state, history),
    the history one dict a logged step with the metrics, ``step`` and
    ``wall``."""
    steps.make_ctx(mesh)                       # a mesh raises
    dev = resolve_device(device)
    if batch_size % replicas:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{replicas} replicas")
    state = init_train_state(cfg, tcfg, tp=1, dp=replicas, seed=tcfg.seed,
                             device=dev)
    step_fn = steps.make_train_step(cfg, tcfg, mesh)
    source = SyntheticLM(cfg.vocab_size, seed=tcfg.seed)
    it = batches(source, batch_size, seq_len)
    draw = frontend_draws(cfg, tcfg.seed, batch_size)
    history = []
    t0 = time.time()
    for i in range(tcfg.steps):
        batch = next(it)
        if draw is not None:
            batch = {**batch, "extra_emb": draw()}
        state, metrics = step_fn(state, batch)
        if i % tcfg.log_every == 0 or i == tcfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall"] = time.time() - t0
            history.append(m)
            log(f"step {i:5d} loss={m['loss']:.4f} xent={m['xent']:.4f} "
                f"synced={m['synced']:.0f} lr={m['lr']:.2e}")
        if (tcfg.checkpoint_dir and tcfg.checkpoint_every
                and i and i % tcfg.checkpoint_every == 0):
            _checkpoint(tcfg, state, i)
    if tcfg.checkpoint_dir:
        _checkpoint(tcfg, state, tcfg.steps)
    return state, history


def frontend_draws(cfg, seed: int, batch_size: int):
    """For a config with a modality frontend, a function that draws one
    batch's stubbed frontend embeddings (batch_size, n_embeds, d_model) in
    ``cfg.dtype`` on the host, call by call: the reference's draws
    (``numpy``'s ``default_rng(seed).normal(0, 0.02, ...)``, one a step,
    cast from float64), bit for bit.  None without a frontend."""
    if cfg.frontend is None:
        return None
    rng = np.random.default_rng(seed)
    dtype = getattr(torch, cfg.dtype)
    shape = (batch_size, cfg.frontend.n_embeds, cfg.d_model)
    return lambda: torch.from_numpy(rng.normal(0, 0.02, shape)).to(dtype)


def synced_params(state):
    """Replica 0's parameters after a sync of every replica's δ (copies:
    the state is left as it is).  With one replica, its parameters."""
    k = int(state.step.shape[0])
    if k == 1:
        return tree_map(lambda a: a[0].detach().clone(), state.params)
    flat = {n: a.detach().clone() for n, a in
            tree_paths(state.params).items()}
    force_sync(flat, state.sync, ("data",))
    return tree_map_paths(lambda n, _: flat[n][0], state.params)


def _checkpoint(tcfg: TrainConfig, state, step: int) -> None:
    # sync replicas first: checkpoints hold the fully-synchronized state
    save_checkpoint(tcfg.checkpoint_dir, step, synced_params(state),
                    metadata={"arch": tcfg.arch,
                              "consistency": tcfg.consistency.model})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced float32 variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adam",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--consistency", default="bsp",
                    choices=["bsp", "ssp", "cap", "vap", "cvap"])
    ap.add_argument("--staleness", type=int, default=0)
    ap.add_argument("--vthr", type=float, default=0.0)
    ap.add_argument("--quantize-sync", action="store_true")
    ap.add_argument("--hierarchical-sync", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--history-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel replicas stacked on the device")
    args = ap.parse_args()

    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype="float32")
    tcfg = TrainConfig(
        arch=args.arch, steps=args.steps, lr=args.lr, optimizer=args.optimizer,
        seed=args.seed,
        consistency=ConsistencySpec(model=args.consistency,
                                    staleness=args.staleness,
                                    value_bound=args.vthr),
        quantize_sync=args.quantize_sync,
        hierarchical_sync=args.hierarchical_sync,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    _, history = run(tcfg, cfg, mesh=None, batch_size=args.batch,
                     seq_len=args.seq, device=args.device,
                     replicas=args.replicas)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=2)


if __name__ == "__main__":
    main()
