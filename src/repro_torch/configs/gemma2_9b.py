"""Gemma2-9B [arXiv:2408.00118] — alternating local/global attention, softcaps."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    source="arXiv:2408.00118",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=14336,
    vocab_size=256000,
    attn_kind="alternating",   # local (sliding window) / global, interleaved
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    norm_kind="gemma_rmsnorm",
    post_norm=True,
    act="gelu",
    gated_mlp=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    tp_strategy="head",
)
