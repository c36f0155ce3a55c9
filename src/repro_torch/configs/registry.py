"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

The port serves the JAX package's ten architectures: the two with
recurrent mixers (``recurrentgemma-9b``, ``mamba2-130m``), the dense ones
with full and alternating attention (``olmo-1b``, ``qwen3-8b``,
``gemma2-2b``, ``gemma2-9b``), the MoE ones, DeepSeek's with multi-head
latent attention (``olmoe-1b-7b``, ``deepseek-v2-lite-16b``), and the two
with stubbed modality frontends (``pixtral-12b``, ``musicgen-medium``),
whose precomputed embeddings replace the first positions of the token
stream.  The reference's two mesh variants (``pixtral-12b-cg``,
``mamba2-130m-sp``) change only how a mesh gathers and shards, so they
come with the mesh (ROADMAP Queue 1 item 7).  ``reduced_config`` is the
JAX package's smoke variant of an architecture, rule for rule, so the two
packages' CPU parity tests build the same model.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import FrontendConfig, MLAConfig, ModelConfig
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2_2b
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2_9b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma

ARCHS = {c.name: c for c in [_olmoe, _olmo, _pixtral, _qwen3, _gemma2_9b,
                             _gemma2_2b, _recurrentgemma, _musicgen,
                             _deepseek, _mamba2]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """A tiny same-family variant for CPU tests (at most 2 layers or one
    pattern period, d_model 128, 4 experts, 8 frontend embeddings), the
    same as the JAX package's ``reduced_config``."""
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
    if cfg.layer_pattern == ("attn",):
        kw["n_layers"] = 2
    else:
        kw["n_layers"] = len(cfg.layer_pattern)      # one full pattern period
    if cfg.d_ff:
        kw["d_ff"] = 256
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_expert=64,
            d_shared=64 if cfg.moe.n_shared_experts else 0,
            d_ff_dense=128 if cfg.moe.first_dense_layers else 0,
        )
        if cfg.moe.first_dense_layers:
            kw["n_layers"] = 2                       # 1 dense + 1 moe layer
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=32,
                              qk_rope_head_dim=16, v_head_dim=32)
        kw["d_head"] = 48
    if cfg.recurrent is not None:
        if cfg.recurrent.kind == "rglru":
            kw["recurrent"] = dataclasses.replace(cfg.recurrent, width=128)
        else:
            kw["recurrent"] = dataclasses.replace(
                cfg.recurrent, width=128, head_dim=32, d_state=16,
                chunk_size=16)
    if cfg.frontend is not None:
        kw["frontend"] = FrontendConfig(kind=cfg.frontend.kind, n_embeds=8,
                                        embed_dim=128)
    return dataclasses.replace(cfg, **kw)
