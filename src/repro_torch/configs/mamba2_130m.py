"""Mamba2-130M [arXiv:2405.21060] — attention-free SSD (state-space duality).

vocab 50280 is padded to 50304 for even tp=16 sharding (logits masked).
The model is tiny (130M), so mixer weights are replicated and only the
vocab-sharded embedding/logits use the model axis (DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    n_layers=24,
    d_model=768,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_head=0,
    d_ff=0,                    # no FFN — the mamba block is the whole layer
    vocab_size=50280,
    norm_kind="rmsnorm",
    tie_embeddings=True,
    layer_pattern=("rec",),
    recurrent=RecurrentConfig(kind="mamba2", width=1536, conv_width=4,
                              d_state=128, head_dim=64, n_groups=1,
                              chunk_size=256),
    tp_strategy="replicated",
)
