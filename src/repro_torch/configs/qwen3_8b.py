"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense GQA with qk-norm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    norm_kind="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
    tp_strategy="head",
)
