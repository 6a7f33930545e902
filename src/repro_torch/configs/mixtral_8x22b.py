"""Mixtral 8x22B — 8 experts top-2, sliding-window attention.

Assignment: [moe] 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8e top-2  [arXiv:2401.04088]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    attn_kind="gqa",
    window=4096,                # SWA (Mistral lineage)
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
    source="arXiv:2401.04088",
)
