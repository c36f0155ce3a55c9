"""OLMo-1B [arXiv:2402.00838] — dense, non-parametric LayerNorm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    source="arXiv:2402.00838",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=8192,
    vocab_size=50304,
    norm_kind="nonparam_ln",   # OLMo uses LayerNorm without scale/bias
    act="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    tie_embeddings=True,       # OLMo-1B ties input/output embeddings
    tp_strategy="head",
)
