"""Gemma2-2B [arXiv:2408.00118] — alternating local/global attention, softcaps.

8 heads: the JAX package shards its attention by sequence (``tp_strategy
"seq"``); at tp = 1 the port runs it as every other layout.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    source="arXiv:2408.00118",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab_size=256000,
    attn_kind="alternating",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    norm_kind="gemma_rmsnorm",
    post_norm=True,
    act="gelu",
    gated_mlp=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    tp_strategy="seq",
)
