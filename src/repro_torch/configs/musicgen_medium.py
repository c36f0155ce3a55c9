"""MusicGen-medium [arXiv:2306.05284] — decoder-only LM over EnCodec tokens.

The EnCodec tokenizer and the T5 text encoder are stubbed, as in the JAX
package: the ids are audio tokens (vocab 2048) and the caller supplies
precomputed conditioning embeddings (``extra_emb``) consumed as a prefix
(cross-attention replaced by prefix conditioning).  Its 24 heads do not
divide by tp = 16, so the config names the seq-TP strategy; the port runs
at tp = 1.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab_size=2048,
    norm_kind="layernorm",
    act="gelu",
    gated_mlp=False,           # MusicGen uses a plain (non-gated) MLP
    rope_theta=10_000.0,       # deviation: sinusoidal absolute -> RoPE
    frontend=FrontendConfig(kind="audio", n_embeds=64, embed_dim=1536),
    tp_strategy="seq",
)
