"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

The port serves two of the JAX package's ten architectures so far, the two
with recurrent mixers: ``recurrentgemma-9b`` (RG-LRU + local attention) and
``mamba2-130m`` (Mamba-2 SSD).  Any other id raises ``KeyError``; the other
eight (MoE, MLA, modality frontends, full and alternating attention) are
ROADMAP Queue 1 item 6.  ``reduced_config`` is the JAX package's smoke
variant of an architecture, rule for rule, so the two packages' CPU parity
tests build the same model.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma

ARCHS = {c.name: c for c in [_recurrentgemma, _mamba2]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP Queue 1 "
                       f"item 6); the port has: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """A tiny same-family variant for CPU tests (one pattern period,
    d_model 128), the same as the JAX package's ``reduced_config``."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        vocab_size=512,
        d_model=128,
        window=32,
        long_context_window=32,
        tp_strategy=cfg.tp_strategy,
    )
    if cfg.has_attention:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) or 4, d_head=32)
    kw["n_layers"] = len(cfg.layer_pattern)          # one full pattern period
    if cfg.d_ff:
        kw["d_ff"] = 256
    if cfg.recurrent.kind == "rglru":
        kw["recurrent"] = dataclasses.replace(cfg.recurrent, width=128)
    else:
        kw["recurrent"] = dataclasses.replace(
            cfg.recurrent, width=128, head_dim=32, d_state=16, chunk_size=16)
    return dataclasses.replace(cfg, **kw)
