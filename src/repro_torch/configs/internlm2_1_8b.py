"""InternLM2 1.8B — dense GQA.

Assignment: [dense] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544
[arXiv:2403.17297]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    attn_kind="gqa",
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
    serve_window=8192,          # long_500k serving variant only (DESIGN.md §6)
    source="arXiv:2403.17297",
)
