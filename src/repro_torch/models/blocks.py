"""Transformer blocks: one residual block = norm -> mixer -> norm -> FFN.

Port of ``repro.models.blocks`` for a GQA attention (with Gemma-2's
soft-capping and local/global windows) or Mamba-2 SSD mixer, and a dense
SwiGLU/GeGLU FFN, an MoE FFN (``models.moe``) or none (pure-SSM archs),
with Gemma-2's post-norms after the mixer and the FFN.  A layer's kinds
come from the config (:func:`layer_meta`), so Jamba's hybrid stack mixes
them: an attention layer every ``hybrid_attn_period`` at
``hybrid_attn_offset``, Mamba-2 elsewhere, an MoE FFN every ``moe.every``
layers and a dense one between (an SSM layer of a hybrid has an FFN; a
pure-SSM arch's has none).  One :class:`Block` module per layer; its
parameters carry the reference's names and shapes (``ln1``, ``mixer.wq``
..., ``ln1_post``, ``ln2``, ``ffn.w_gate`` or ``ffn.router`` ...,
``ln2_post``).  A block runs with or without its layer's cache
(:func:`init_block_cache`).  MLA and the audio/vision frontends are not
ported (:func:`check_supported`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.network import Device
from repro_torch.models import attention, layers, moe, ssm

# Where the parts of the model substrate that are not ported yet are queued:
# MLA (item 6b) and the audio/vision frontends (item 6c).
TODO = "ROADMAP Queue 1, Transformer substrate, the rest"


@dataclasses.dataclass(frozen=True)
class LayerMeta:
    idx: int                 # absolute layer index
    kind: str                # 'attn' | 'ssm'
    is_moe: bool
    window: Optional[int]


def layer_meta(cfg: ModelConfig, idx: int) -> LayerMeta:
    return LayerMeta(
        idx=idx,
        kind=cfg.layer_kind(idx),
        is_moe=cfg.layer_is_moe(idx),
        window=cfg.layer_window(idx),
    )


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    missing = []
    if cfg.attn_kind == "mla":
        missing.append("MLA attention (item 6b)")
    if cfg.frontend is not None or cfg.encoder_only:
        missing.append(f"the {cfg.frontend or 'encoder'} frontend (item 6c)")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not ported "
                                  f"yet ({TODO})")


def _params(shapes: dict, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                           requires_grad=False)
        for name, shape in shapes.items()})


def _ffn_shapes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def _norm(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(d, device=device), requires_grad=False)


class Block(nn.Module):
    """One layer: ``ln1``, ``mixer`` and, where the layer has one, ``ln2``
    and ``ffn`` (dense, or MoE where ``meta.is_moe``); with ``post_norm``,
    ``ln1_post`` (and ``ln2_post`` with an FFN).  Parameters allocated (uninitialised) on ``device``.  For configs
    that pass :func:`check_supported` (``Model`` checks)."""

    def __init__(self, cfg: ModelConfig, meta: LayerMeta, device):
        super().__init__()
        self.cfg, self.meta = cfg, meta
        d = cfg.d_model
        self.ln1 = _norm(d, device)
        mixer = attention if meta.kind == "attn" else ssm
        self.mixer = _params(mixer.param_shapes(cfg), device)
        if cfg.post_norm:
            self.ln1_post = _norm(d, device)
        self.has_ffn = meta.is_moe or (cfg.d_ff > 0 and cfg.arch_type != "ssm")
        if self.has_ffn:
            self.ln2 = _norm(d, device)
            shapes = moe.param_shapes(cfg) if meta.is_moe else _ffn_shapes(cfg)
            self.ffn = _params(shapes, device)
            if cfg.post_norm:
                self.ln2_post = _norm(d, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cache=None,
                cache_index: int = 0, impl: str = "naive",
                view: Optional[attention.CacheView] = None):
        return apply_block(self, x, positions=positions, cache=cache,
                           cache_index=cache_index, impl=impl, view=view)


def init_block(block: Block, gen: torch.Generator) -> None:
    """Fill a block's parameters in place: norms 0, the mixer's and FFN's
    initialisers."""
    with torch.no_grad():
        block.ln1.zero_()
        (attention if block.meta.kind == "attn" else ssm).init(block.mixer, gen)
        if block.cfg.post_norm:
            block.ln1_post.zero_()
        if block.has_ffn:
            block.ln2.zero_()
            if block.meta.is_moe:
                moe.init(block.ffn, gen)
            else:
                layers.dense_init_(block.ffn["w_gate"], gen)
                layers.dense_init_(block.ffn["w_up"], gen)
                layers.dense_init_(block.ffn["w_down"], gen)
            if block.cfg.post_norm:
                block.ln2_post.zero_()


def init_block_cache(cfg: ModelConfig, meta: LayerMeta, batch: int, max_len: int,
                     dtype=torch.bfloat16, device: Device = "cuda") -> tuple:
    """The layer's empty cache: (k, v) for attention, (conv, ssm state) for
    an SSM layer."""
    if meta.kind == "ssm":
        return ssm.init_cache(cfg, batch, dtype, device)
    return attention.init_cache(cfg, batch, max_len, dtype, device)


def apply_block(block: Block, x: torch.Tensor, *, positions: torch.Tensor, cache=None,
                cache_index: int = 0, impl: str = "naive",
                view: Optional[attention.CacheView] = None):
    """x (B, S, d) -> (x + mixer(norm(x)) [+ ffn(norm(.))], new_cache, aux);
    with ``post_norm`` the mixer's and FFN's outputs are normed before their
    residual adds.  ``new_cache`` is None without a ``cache``.  ``aux`` is
    an MoE layer's load-balance loss (a float32 scalar), None for a layer
    without one (the reference's zero).  ``impl`` and ``view`` go to
    :func:`attention.apply`."""
    cfg, meta = block.cfg, block.meta
    h = layers.rms_norm(x, block.ln1, cfg.norm_eps)
    if meta.kind == "attn":
        mix, new_cache = attention.apply(block.mixer, cfg, h, positions=positions,
                                         window=meta.window, cache=cache,
                                         cache_index=cache_index, impl=impl, view=view)
    else:
        mix, new_cache = ssm.apply(block.mixer, cfg, h, cache=cache)
    if cfg.post_norm:
        mix = layers.rms_norm(mix, block.ln1_post, cfg.norm_eps)
    x = x + mix
    aux = None
    if block.has_ffn:
        h = layers.rms_norm(x, block.ln2, cfg.norm_eps)
        f = block.ffn
        if meta.is_moe:
            f, aux = moe.apply(f, cfg, h)
        else:
            f = layers.swiglu(h, f["w_gate"], f["w_up"], f["w_down"], cfg.act)
        if cfg.post_norm:
            f = layers.rms_norm(f, block.ln2_post, cfg.norm_eps)
        x = x + f
    return x, new_cache, aux
