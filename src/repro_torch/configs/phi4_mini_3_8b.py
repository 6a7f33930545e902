"""Phi-4-mini 3.8B — dense, RoPE + SwiGLU + GQA.

Assignment: [dense] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064
[arXiv:2412.08905]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    attn_kind="gqa",
    rope_theta=10_000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    serve_window=8192,          # long_500k serving variant only (DESIGN.md §6)
    source="arXiv:2412.08905",
)
