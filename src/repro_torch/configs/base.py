"""Configuration dataclasses of the model zoo (the port's copy).

The same frozen dataclasses as the JAX package's ``configs/base.py``, so a
configuration prints and compares the same in both packages, ``TrainConfig``
included.  ``ConsistencySpec`` is the one of :mod:`repro_torch.core.policies`
(``TrainConfig.consistency`` takes it), re-exported here.
The registry in :mod:`repro_torch.configs.registry` maps ``--arch`` ids onto
the configurations the port serves.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.core.policies import ConsistencySpec


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts feed-forward configuration."""

    n_experts: int
    top_k: int
    d_expert: int                     # hidden width of each routed expert
    n_shared_experts: int = 0         # DeepSeek-style always-on experts
    d_shared: int = 0                 # hidden width of the shared expert block
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01     # load-balance loss coefficient
    first_dense_layers: int = 0       # leading layers that use a dense FFN
    d_ff_dense: int = 0               # hidden width of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RecurrentConfig:
    """Recurrent mixer configuration (RG-LRU or Mamba-2 SSD)."""

    kind: str = "rglru"               # "rglru" | "mamba2"
    width: int = 0                    # recurrence width (d_inner)
    conv_width: int = 4
    # mamba2-only:
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    # rglru-only:
    block_width: int = 0              # rglru gate block-diagonal width (0 = dense)


@dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend (VLM patches / audio conditioning).

    Per the brief, the conv/ViT encoder itself is NOT implemented; the
    frontend contributes precomputed embeddings via ``input_specs``.
    """

    kind: str                         # "vision" | "audio"
    n_embeds: int                     # patches (vision) / conditioning frames (audio)
    embed_dim: int                    # dimension of provided embeddings


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense|moe|vlm|audio|hybrid|ssm
    source: str                       # citation for the assignment table
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention flavour ---------------------------------------------------
    attn_kind: str = "full"           # "full" | "swa" | "alternating" (local/global)
    # int8-compress the sequence-parallel all-gathers (lossy ~0.4% activation
    # error; halves the dominant collective volume — EXPERIMENTS §Perf pair 2)
    compress_gathers: bool = False
    window: int = 4096                # sliding-window size where applicable
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0

    # --- block flavour -------------------------------------------------------
    norm_kind: str = "rmsnorm"        # "rmsnorm" | "gemma_rmsnorm" | "layernorm" | "nonparam_ln"
    post_norm: bool = False           # gemma2-style post-sublayer norms
    act: str = "silu"                 # "silu" | "gelu"
    gated_mlp: bool = True            # SwiGLU/GeGLU vs plain MLP
    tie_embeddings: bool = False
    layer_pattern: Tuple[str, ...] = ("attn",)   # cycled over layers

    # --- optional subsystems -------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    frontend: Optional[FrontendConfig] = None

    # --- distribution --------------------------------------------------------
    tp_strategy: str = "head"         # "head" | "seq" | "replicated"  (see DESIGN §6)
    # long-context mode: attention archs fall back to sliding-window caches so
    # that the 500k decode shape has bounded memory (DESIGN §6).
    long_context_window: int = 4096

    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"           # activation/param compute dtype
    param_dtype: str = "float32"      # master/optimizer dtype

    # -------------------------------------------------------------------------
    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # Padded vocab so the output head shards evenly over the model axis.
    def padded_vocab(self, tp: int) -> int:
        v = self.vocab_size
        return ((v + tp - 1) // tp) * tp

    @property
    def has_attention(self) -> bool:
        return "attn" in self.layer_pattern

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind list of length n_layers."""
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        d = self.d_model
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * self.n_heads * qd                       # q proj
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)   # kv down
                    total += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d             # out
                else:
                    total += d * self.n_heads * self.d_head              # q
                    total += 2 * d * self.n_kv_heads * self.d_head       # k,v
                    total += self.n_heads * self.d_head * d              # out
            elif kind == "rec":
                r = self.recurrent
                if r.kind == "rglru":
                    w = r.width
                    total += 2 * d * w            # in projections (x, gate)
                    total += w * d                # out projection
                    total += r.conv_width * w     # causal conv
                    total += 3 * w                # lru gates/params (approx)
                else:  # mamba2
                    w = r.width
                    nh = w // r.head_dim
                    total += d * (2 * w + 2 * r.n_groups * r.d_state + nh)
                    total += r.conv_width * (w + 2 * r.n_groups * r.d_state)
                    total += w * d
                    total += 2 * nh
            if kind in ("attn", "rec"):
                total += self._ffn_params_for_layer()
        return total

    def _ffn_params_for_layer(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            p = m.n_experts * (3 if self.gated_mlp else 2) * d * m.d_expert
            p += d * m.n_experts                                         # router
            if m.n_shared_experts:
                p += (3 if self.gated_mlp else 2) * d * m.d_shared
            return p
        mult = 3 if self.gated_mlp else 2
        return mult * d * self.d_ff

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k only) — for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        # subtract inactive routed experts
        per_expert = (3 if self.gated_mlp else 2) * d * m.d_expert
        n_moe_layers = sum(
            1 for i, k in enumerate(self.layer_kinds())
            if k == "attn" and i >= m.first_dense_layers
        )
        total -= n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return total


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                         # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class TrainConfig:
    arch: str = "olmo-1b"
    shape: str = "train_4k"
    steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.0
    optimizer: str = "adam"           # "sgd" | "momentum" | "adam"
    seed: int = 0
    consistency: ConsistencySpec = field(default_factory=ConsistencySpec)
    remat: bool = True
    microbatch: int = 0               # 0 = no microbatching
    log_every: int = 10
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    # beyond-paper options
    quantize_sync: bool = False       # bf16 delta all-reduce (error feedback)
    hierarchical_sync: int = 0        # sync across pods every k-th sync
    state_dtype: str = "float32"      # delta + Adam moments storage dtype


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
