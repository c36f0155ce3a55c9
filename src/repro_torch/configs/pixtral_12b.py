"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — Mistral-Nemo decoder backbone.

The Pixtral-ViT vision encoder is stubbed, as in the JAX package: the
caller supplies precomputed patch embeddings (``extra_emb``), which replace
the first ``n_embeds`` positions of the token stream (see
``models/model.py``).
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    source="hf:mistralai/Pixtral-12B-2409",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    norm_kind="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision", n_embeds=256, embed_dim=5120),
    tp_strategy="head",
)
