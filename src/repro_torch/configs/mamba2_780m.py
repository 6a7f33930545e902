"""Mamba-2 780M — attention-free SSM with SSD (state-space duality).

Assignment: [ssm] 48L d_model=1536 (attn-free) d_ff=0 vocab=50280,
ssm_state=128  [arXiv:2405.21060]
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,                  # attention-free
    n_kv_heads=0,
    d_ff=0,                     # no FFN: the mamba mixer is the whole block
    vocab=50280,
    attn_kind="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    norm_eps=1e-5,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
