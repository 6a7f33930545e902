"""GQA attention with causal / sliding-window masks and RoPE, cache-less.

Port of the prefill path of ``repro.models.attention``.  :func:`sdpa`
takes the flash kernel exactly where the reference's ``use_kernel=True``
does (``Sq > 1``, no soft-cap; the cache-less path has no ``kv_len``),
through ``ops.flash_attention``: the CUDA kernel for CUDA tensors, its
plain version for CPU tensors.  There it assumes self-attention over
positions ``0..S-1``, as the reference's kernel call does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers


def param_shapes(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd), "wo": (H, hd, d)}


def init(params, gen: torch.Generator) -> None:
    """Fill ``params`` (name -> tensor of :func:`param_shapes`) in place."""
    for name in ("wq", "wk", "wv"):
        layers.dense_init_(params[name], gen)
    layers.dense_init_(params["wo"], gen, in_axis=1)


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """(..., sq, skv) bool mask, True = attend."""
    dq = q_pos[..., :, None]
    dk = kv_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape), dtype=torch.bool,
                   device=dq.device)
    if causal:
        m = m & (dk <= dq)
    if window is not None:
        m = m & (dk > dq - window)
    return m


def sdpa(q, k, v, *, q_pos, kv_pos, causal=True, window=None, softcap_val=None):
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> (B, Sq, H, hd); GQA: H a
    multiple of KV, KV heads broadcast."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV

    if Sq > 1 and softcap_val is None:
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    qh = q.reshape(B, Sq, KV, rep, hd)
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qh.float() * hd ** -0.5, k.float())
    logits = layers.softcap(logits, softcap_val)
    mask = _mask(q_pos, kv_pos, causal, window)
    mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def apply(params, cfg: ModelConfig, x: torch.Tensor, *, positions: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """Attention block body (no residual/norm: the caller owns those)."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params["wq"].reshape(d, H * hd)).reshape(B, S, H, hd)
    k = (x @ params["wk"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    v = (x @ params["wv"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = sdpa(q, k, v, q_pos=positions, kv_pos=positions,
               causal=not cfg.encoder_only, window=window,
               softcap_val=cfg.attn_softcap)
    return out.reshape(B, S, H * hd) @ params["wo"].reshape(H * hd, d)
