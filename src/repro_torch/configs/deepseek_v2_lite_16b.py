"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434] — MLA + 64-routed/2-shared MoE.

V2-Lite has 64 routed experts, top-6 (full DeepSeek-V2 has 160); the first
layer is a dense MLP.  The same values as the JAX package's copy.
"""
from repro_torch.configs.base import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,             # MLA: all heads share the compressed kv latent
    d_head=192,                # qk head dim = nope(128) + rope(64)
    d_ff=1408,                 # routed-expert hidden width
    vocab_size=102400,
    norm_kind="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408,
                  n_shared_experts=2, d_shared=2816,
                  first_dense_layers=1, d_ff_dense=10944),
    tp_strategy="head",
)
