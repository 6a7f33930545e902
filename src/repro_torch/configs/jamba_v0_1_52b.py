"""Jamba v0.1 52B — hybrid Mamba + attention 1:7 interleave, MoE 16e top-2.

Assignment: [hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16e top-2  [arXiv:2403.19887]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    attn_kind="gqa",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, every=2),
    hybrid_attn_period=8,       # 1 attention layer per 8 (1:7 ratio)
    hybrid_attn_offset=3,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    source="arXiv:2403.19887",
)
