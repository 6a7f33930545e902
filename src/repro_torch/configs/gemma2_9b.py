"""Gemma 2 9B — local/global alternating attention, logit soft-capping.

Assignment: [dense] 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000
[arXiv:2408.00118]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    attn_kind="gqa",
    window=4096,                # even layers local (SWA-4096), odd global
    local_global=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    post_norm=True,
    tie_embeddings=True,
    act="gelu",
    source="arXiv:2408.00118",
)
