"""HuBERT X-Large — encoder-only audio transformer (wav2vec2 architecture).

Assignment: [audio] 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504
[arXiv:2106.07447].  The conv/mel frontend is a stub: input_specs supplies
precomputed frame embeddings (DESIGN.md §5); training is masked cluster
prediction over a 504-unit codebook.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,                  # k-means cluster codebook
    attn_kind="gqa",
    encoder_only=True,
    frontend="audio",
    act="gelu",
    norm_eps=1e-5,
    source="arXiv:2106.07447",
)
