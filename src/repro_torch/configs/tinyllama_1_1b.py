"""TinyLlama 1.1B — llama2-architecture small model.

Assignment: [dense] 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000
[arXiv:2401.02385]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    attn_kind="gqa",
    rope_theta=10_000.0,
    norm_eps=1e-5,
    serve_window=8192,          # long_500k serving variant only (DESIGN.md §6)
    source="arXiv:2401.02385",
)
