"""DeepSeek-V3 671B — MLA, 1 shared + 256 routed experts top-8, MTP.

Assignment: [moe] 61L d_model=7168 128H (GQA kv=128) d_ff=2048 vocab=129280,
MoE 256e top-8  [arXiv:2412.19437]
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                 # dense-FFN size of the first_k_dense layers
    vocab=129280,
    head_dim=128,
    attn_kind="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_expert=2048,          # assignment d_ff=2048 = routed expert hidden
        n_shared=1,
        first_k_dense=3,
        capacity_factor=1.25,
    ),
    rope_theta=10_000.0,
    norm_eps=1e-6,
    source="arXiv:2412.19437",
)
