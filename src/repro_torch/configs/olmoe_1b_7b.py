"""OLMoE-1B-7B [arXiv:2409.02060] — 64-expert top-8 MoE, qk-norm."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    source="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,                 # per-expert hidden width
    vocab_size=50304,
    qk_norm=True,
    norm_kind="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
    tp_strategy="head",
)
