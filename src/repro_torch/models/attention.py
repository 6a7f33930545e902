"""GQA attention with causal / sliding-window masks, soft-capping and RoPE;
cache-less prefill, cached prefill and single-token decode.

Port of ``repro.models.attention``.  :func:`sdpa` takes the flash kernel
exactly where the reference's ``use_kernel=True`` does (``Sq > 1``, no
soft-cap, no ``kv_len``), through ``ops.flash_attention``: the CUDA kernel
for CUDA tensors, its plain version for CPU tensors.  There it assumes
self-attention over positions ``0..S-1``, as the reference's kernel call
does; a cached call attends over a cache of ``S_max`` rows masked by
``kv_len`` and stays on the plain path.  :func:`sdpa_blockwise` is the
reference's online-softmax loop over KV blocks, in plain PyTorch (the
reference has no kernel for it either).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.network import Device, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers

# Position given to the padded keys of sdpa_blockwise's last block, and the
# bound below which a key position is a real one.
_PAD_POS = (2 ** 31 - 1) // 2
_PAD_LIMIT = (2 ** 31 - 1) // 4


def param_shapes(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd), "wo": (H, hd, d)}


def init(params, gen: torch.Generator) -> None:
    """Fill ``params`` (name -> tensor of :func:`param_shapes`) in place."""
    for name in ("wq", "wk", "wv"):
        layers.dense_init_(params[name], gen)
    layers.dense_init_(params["wo"], gen, in_axis=1)


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int],
          kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., sq, skv) bool mask, True = attend; ``kv_len`` (B,) masks the
    cache rows at or past each row's valid prefix."""
    dq = q_pos[..., :, None]
    dk = kv_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape), dtype=torch.bool,
                   device=dq.device)
    if causal:
        m = m & (dk <= dq)
    if window is not None:
        m = m & (dk > dq - window)
    if kv_len is not None:
        m = m & (dk < kv_len[..., None, None])
    return m


def sdpa(q, k, v, *, q_pos, kv_pos, causal=True, window=None, softcap_val=None,
         kv_len=None, mask=None):
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> (B, Sq, H, hd); GQA: H a
    multiple of KV, KV heads broadcast.  ``mask``: :func:`_mask` of the
    other arguments, where the caller has it already."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV

    if Sq > 1 and softcap_val is None and kv_len is None:
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    qh = q.reshape(B, Sq, KV, rep, hd)
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qh.float() * hd ** -0.5, k.float())
    logits = layers.softcap(logits, softcap_val)
    if mask is None:
        mask = _mask(q_pos, kv_pos, causal, window, kv_len)
    mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def sdpa_blockwise(q, k, v, *, q_pos, kv_pos, causal=True, window=None,
                   softcap_val=None, kv_len=None, block=512):
    """:func:`sdpa` by online softmax over KV blocks of ``block`` rows: no
    (Sq, Skv) score matrix.  The last block is padded with zero keys at
    position ``(2**31 - 1) // 2``, which the mask drops.  ``q_pos`` (B, Sq)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    nb = -(-Skv // block)
    pad = nb * block - Skv
    if kv_pos.ndim == 1:
        kv_pos = kv_pos[None]
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=_PAD_POS)
    qf = (q.float() * hd ** -0.5).reshape(B, Sq, KV, rep, hd)
    pos = kv_pos.expand(B, nb * block)
    dq = q_pos[:, None, None, :, None]

    m = torch.full((B, KV, rep, Sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, rep, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, rep, Sq, hd), dtype=torch.float32, device=q.device)
    for i in range(nb):
        rows = slice(i * block, (i + 1) * block)
        s = torch.einsum("bqgrh,bkgh->bgrqk", qf, k[:, rows].float())
        s = layers.softcap(s, softcap_val)
        dk = pos[:, None, None, None, rows]
        mask = dk < _PAD_LIMIT                                 # the padding
        if causal:
            mask = mask & (dk <= dq)
        if window is not None:
            mask = mask & (dk > dq - window)
        if kv_len is not None:
            mask = mask & (dk < kv_len[:, None, None, None, None])
        s = torch.where(mask, s, -1e30)
        m_cur = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_cur)
        p = torch.where(mask, torch.exp(s - m_cur[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgh->bgrqh", p,
                                                    v[:, rows].float())
        m = m_cur
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


class CacheView(NamedTuple):
    """What every attention layer of one cached call shares: the cache rows'
    positions ``kv_pos`` (1, S_max), each row's valid prefix ``kv_len``
    (B,), and the :func:`_mask` of each layer window (None for
    ``sdpa_blockwise``, which masks block by block)."""
    kv_pos: torch.Tensor
    kv_len: torch.Tensor
    masks: Optional[dict]


def cache_view(cfg: ModelConfig, positions: torch.Tensor, S_max: int, cache_index: int,
               windows=(None,), impl: str = "naive") -> CacheView:
    """The :class:`CacheView` of a call of S = ``positions.shape[1]`` tokens
    at ``cache_index`` into caches of ``S_max`` rows, with a mask for each
    window in ``windows``."""
    B, S = positions.shape
    kv_pos = torch.arange(S_max, device=positions.device)[None].to(positions.dtype)
    kv_len = torch.full((B,), cache_index + S, dtype=positions.dtype,
                        device=positions.device)
    masks = None if impl == "blockwise" else {
        w: _mask(positions, kv_pos, not cfg.encoder_only, w, kv_len) for w in set(windows)}
    return CacheView(kv_pos, kv_len, masks)


def apply(params, cfg: ModelConfig, x: torch.Tensor, *, positions: torch.Tensor,
          window: Optional[int], cache: Optional[tuple] = None, cache_index: int = 0,
          impl: str = "naive", view: Optional[CacheView] = None):
    """Attention block body (no residual/norm: the caller owns those) ->
    (out, new_cache).

    ``cache`` (k_cache, v_cache), each (B, S_max, KV, hd): the new K and V
    are written into it in place at ``cache_index`` (in the cache's dtype)
    and attention runs against the first ``cache_index + S`` rows; the
    cache is returned as ``new_cache`` (None without a cache).  ``view``:
    the call's :func:`cache_view`, formed here if not given.
    """
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params["wq"].reshape(d, H * hd)).reshape(B, S, H, hd)
    k = (x @ params["wk"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    v = (x @ params["wv"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)

    attn = sdpa_blockwise if impl == "blockwise" else sdpa
    kw = dict(causal=not cfg.encoder_only, window=window, softcap_val=cfg.attn_softcap)
    if cache is None:
        out = attn(q, k, v, q_pos=positions, kv_pos=positions, **kw)
    else:
        kc, vc = cache
        S_max = kc.shape[1]
        # dynamic_update_slice's start: clamped so the S rows fit the cache
        at = min(max(cache_index, 0), S_max - S)
        kc[:, at:at + S] = k.to(kc.dtype)
        vc[:, at:at + S] = v.to(vc.dtype)
        if view is None:
            view = cache_view(cfg, positions, S_max, cache_index, (window,), impl)
        if view.masks is not None:
            kw["mask"] = view.masks[window]
        out = attn(q, kc, vc, q_pos=positions, kv_pos=view.kv_pos, kv_len=view.kv_len,
                   **kw)
    out = out.reshape(B, S, H * hd) @ params["wo"].reshape(H * hd, d)
    return out, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: Device = "cuda") -> tuple:
    """Zero (k_cache, v_cache), each (batch, max_len, KV, hd)."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))
