"""RecurrentGemma-9B [arXiv:2402.19427] — RG-LRU + local attention, 1:2 pattern."""
from repro_torch.configs.base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,              # MQA
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    attn_kind="swa",           # all attention layers are local, window 2048
    window=2048,
    norm_kind="gemma_rmsnorm",
    act="gelu",
    gated_mlp=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    layer_pattern=("rec", "rec", "attn"),
    recurrent=RecurrentConfig(kind="rglru", width=4096, conv_width=4),
    tp_strategy="head",
)
