"""Config system: architecture descriptions for the model zoo.

The port's own copy of ``repro.configs.base`` (plain dataclasses; the port
imports nothing of the JAX package).  Every architecture has one module in
``repro_torch/configs/`` exporting ``CONFIG`` (the full-scale
configuration); :func:`reduced_config` gives the CPU smoke-test variant (2
layers, d_model <= 256, <= 4 experts).  ``repro_torch.configs.get(name)``
resolves either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # always-on shared experts (DeepSeek-V3)
    every: int = 1                # MoE every Nth layer (Jamba: 2)
    first_k_dense: int = 0        # leading dense layers (DeepSeek-V3: 3)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (arXiv:2405.21060)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    attn_kind: str = "gqa"                  # gqa | mla | none
    window: Optional[int] = None            # sliding-window size (SWA)
    local_global: bool = False              # gemma2 alternating local/global
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_period: int = 0    # Jamba: 1 attention layer per 8 (1:7)
    hybrid_attn_offset: int = 3    # position of the attn layer in the period
    encoder_only: bool = False     # HuBERT: bidirectional, no decode
    frontend: Optional[str] = None  # None | "audio" | "vision" (stubbed)
    n_patches: int = 0             # VLM: image patch-embedding prefix length
    tie_embeddings: bool = False
    post_norm: bool = False        # gemma2: extra norm after mixer/FFN
    norm_eps: float = 1e-6
    act: str = "silu"
    # serving variants (beyond-paper; see DESIGN.md §6)
    serve_window: Optional[int] = None      # SWA window used only for long-
    #                                         context serving of dense archs
    source: str = ""               # citation for the configuration

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.attn_kind == "none" and self.hybrid_attn_period == 0

    def layer_kind(self, idx: int) -> str:
        """'attn' | 'ssm' for layer idx (hybrid interleave)."""
        if self.arch_type == "ssm":
            return "ssm"
        if self.hybrid_attn_period:
            return "attn" if idx % self.hybrid_attn_period == self.hybrid_attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, idx: int) -> bool:
        if self.moe is None:
            return False
        if idx < self.moe.first_k_dense:
            return False
        return (idx - self.moe.first_k_dense) % self.moe.every == 0

    def layer_window(self, idx: int) -> Optional[int]:
        """Effective sliding window for layer idx (None = full attention)."""
        if self.local_global:
            return self.window if idx % 2 == 0 else None    # even layers local
        return self.window

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.attn_kind != "gqa"
        if self.arch_type == "moe":
            assert self.moe is not None
        if self.arch_type == "ssm":
            assert self.ssm is not None and self.attn_kind == "none"
        if self.arch_type == "hybrid":
            assert self.ssm is not None and self.hybrid_attn_period > 0
        if self.attn_kind == "mla":
            assert self.mla is not None


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family, 2 layers, d_model <= 512, <= 4 experts."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads) or 1
    updates = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=max(1, n_kv if n_heads % max(n_kv, 1) == 0 else 1),
        d_ff=min(cfg.d_ff, 512) or 0,
        vocab=min(cfg.vocab, 512),
        head_dim=64 if cfg.head_dim is not None else None,
        window=min(cfg.window, 64) if cfg.window else None,
        serve_window=min(cfg.serve_window, 64) if cfg.serve_window else None,
        n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0,
    )
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert, 256),
            n_shared=min(cfg.moe.n_shared, 1),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    if cfg.mla is not None:
        updates["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16,
            nope_head_dim=32, v_head_dim=32,
        )
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(cfg.ssm, d_state=32, head_dim=32)
    if cfg.hybrid_attn_period:
        updates["n_layers"] = 2
        updates["hybrid_attn_period"] = 2     # 1 attn + 1 ssm in the pair
        updates["hybrid_attn_offset"] = 1
    if cfg.local_global:
        updates["n_layers"] = 2               # one local + one global pair
    out = dataclasses.replace(cfg, **updates)
    out.validate()
    return out
