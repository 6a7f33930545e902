"""Analytic FLOP / parameter / byte models for every architecture.

The port's copy of ``repro.models.flops`` (pure Python, no tensors).

Used by ``core/chain.py`` for the packet sizes and workloads of
DNN-vertical-split service chains, and by the parity tests (bit-equal to
the reference for all ten architectures).

Conventions: per-TOKEN forward FLOPs unless stated; a matmul of (m,k)x(k,n)
counts 2*m*k*n.  Causal attention averages sequence interaction to S/2.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def embed_bits_per_token(cfg: ModelConfig) -> float:
    """Bits entering the network per token (stage-0 packets of the chain)."""
    if cfg.frontend in ("audio", "vision"):
        return cfg.d_model * 16.0          # precomputed bf16 embeddings (stub)
    return 32.0                            # int32 token ids


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qk = m.nope_head_dim + m.rope_head_dim
        p = d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk        # W_DQ, W_UQ
        p += d * (m.kv_lora_rank + m.rope_head_dim)                     # W_DKV
        p += m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
        p += cfg.n_heads * m.v_head_dim * d                             # W_O
        p += m.q_lora_rank + m.kv_lora_rank                             # norms
        return p
    return d * (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd) + cfg.n_heads * hd * d


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff          # SwiGLU: gate, up, down


def _moe_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) MoE-FFN params per MoE layer."""
    m = cfg.moe
    router = cfg.d_model * m.n_experts
    per_exp = 3 * cfg.d_model * m.d_expert
    total = router + (m.n_experts + m.n_shared) * per_exp
    active = router + (m.top_k + m.n_shared) * per_exp
    return total, active


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d, di = cfg.d_model, s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    p = d * (2 * di + 2 * s.n_groups * s.d_state + nh)   # in_proj (z,x,B,C,dt)
    p += conv_dim * s.d_conv                             # depthwise conv
    p += nh * 2 + nh                                     # A_log, D, dt_bias
    p += di * d                                          # out_proj
    return p


def param_count(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts for the full model."""
    total = active = cfg.vocab * cfg.d_model             # embedding
    if not cfg.tie_embeddings and not cfg.encoder_only:
        total += cfg.d_model * cfg.vocab
        active += cfg.d_model * cfg.vocab
    if cfg.encoder_only:
        total += cfg.d_model * cfg.vocab                 # prediction head
        active += cfg.d_model * cfg.vocab
    for idx in range(cfg.n_layers):
        lp = la = 2 * cfg.d_model                        # pre-norms
        if cfg.layer_kind(idx) == "attn":
            a = _attn_params(cfg)
            lp += a
            la += a
        else:
            s = _ssm_params(cfg)
            lp += s
            la += s
        if cfg.layer_kind(idx) == "attn" or cfg.d_ff or cfg.moe:
            if cfg.layer_is_moe(idx):
                t, a = _moe_params(cfg)
                lp += t
                la += a
            elif cfg.d_ff:
                f = _ffn_params(cfg, cfg.d_ff)
                lp += f
                la += f
        total += lp
        active += la
    return total, active


# ---------------------------------------------------------------------------
# per-token forward FLOPs
# ---------------------------------------------------------------------------

def _attn_flops(cfg: ModelConfig, ctx: float) -> float:
    """Per-token attention FLOPs with average context length ctx."""
    d, hd = cfg.d_model, cfg.hd
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qk = m.nope_head_dim + m.rope_head_dim
        f = 2 * d * m.q_lora_rank + 2 * m.q_lora_rank * cfg.n_heads * qk
        f += 2 * d * (m.kv_lora_rank + m.rope_head_dim)
        f += 2 * m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
        f += 2 * ctx * cfg.n_heads * (qk + m.v_head_dim)     # scores + AV
        f += 2 * cfg.n_heads * m.v_head_dim * d
        return f
    f = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd      # qkv proj
    f += 2 * ctx * cfg.n_heads * hd * 2                      # scores + AV
    f += 2 * cfg.n_heads * hd * d                            # out proj
    return f


def _ssm_flops(cfg: ModelConfig, chunk: int = 256) -> float:
    s = cfg.ssm
    d, di = cfg.d_model, s.d_inner(cfg.d_model)
    N = s.d_state
    f = 2 * d * (2 * di + 2 * s.n_groups * N + s.n_heads(cfg.d_model))
    f += 2 * di * N * 2                                      # state update + output
    f += 2 * chunk * di                                      # intra-chunk quadratic
    f += 2 * di * d                                          # out proj
    return f


def _ffn_flops(cfg: ModelConfig, idx: int) -> float:
    if cfg.layer_is_moe(idx):
        m = cfg.moe
        f = 2 * cfg.d_model * m.n_experts                    # router
        f += (m.top_k + m.n_shared) * 3 * 2 * cfg.d_model * m.d_expert
        return f
    if cfg.d_ff:
        return 3 * 2 * cfg.d_model * cfg.d_ff
    return 0.0


def layer_flops(cfg: ModelConfig, seq_len: int, decode: bool = False,
                cache_len: int = 0) -> float:
    """Average per-token forward FLOPs of one *average* layer.

    decode=True: one new token attending to cache_len context.
    """
    total = 0.0
    for idx in range(cfg.n_layers):
        if cfg.layer_kind(idx) == "attn":
            win = cfg.layer_window(idx)
            if decode:
                ctx = min(cache_len, win) if win else cache_len
            else:
                ctx = min(seq_len, win) if win else seq_len
                ctx = ctx / 2 if not cfg.encoder_only else ctx
            total += _attn_flops(cfg, ctx)
        else:
            total += _ssm_flops(cfg)
        total += _ffn_flops(cfg, idx)
    return total / cfg.n_layers


def model_flops_per_token(cfg: ModelConfig, seq_len: int, decode: bool = False,
                          cache_len: int = 0) -> float:
    """Forward FLOPs per token for the whole model incl. embeddings/head."""
    f = cfg.n_layers * layer_flops(cfg, seq_len, decode, cache_len)
    f += 2 * cfg.d_model * cfg.vocab                         # lm/prediction head
    return f


def training_flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """fwd + bwd ~ 3x fwd."""
    return 3.0 * model_flops_per_token(cfg, seq_len)


def model_flops_6nd(cfg: ModelConfig, tokens: float) -> float:
    """The roofline reference: 6*N*D with N = active params (MoE-aware)."""
    _, active = param_count(cfg)
    return 6.0 * active * tokens
