"""LLaVA-NeXT 34B — VLM with anyres tiling; language backbone only.

Assignment: [vlm] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf].  The vision tower + projector are a
stub: input_specs supplies projected patch embeddings (anyres 2x2 tiles +
base image = 5 x 576 = 2880 patches) interleaved before the text tokens
(DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    attn_kind="gqa",
    frontend="vision",
    n_patches=2880,             # anyres: (2x2 + 1 base) tiles x (336/14)^2
    rope_theta=5_000_000.0,
    norm_eps=1e-5,
    serve_window=8192,          # long_500k serving variant only (DESIGN.md §6)
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
