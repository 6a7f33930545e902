"""Transformer blocks: one residual block = norm -> mixer -> norm -> FFN.

Port of ``repro.models.blocks`` for the layers the edge-serving chains run:
a GQA attention or Mamba-2 SSD mixer, and a dense SwiGLU FFN or none
(pure-SSM archs).  One :class:`Block` module per layer; its parameters
carry the reference's names and shapes (``ln1``, ``mixer.wq`` ...,
``ln2``, ``ffn.w_gate`` ...).  MoE, MLA, soft-capping and post-norms, and
the audio/vision frontends are not ported (:func:`check_supported`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, ssm

# Where the parts of the model substrate that are not ported yet are queued.
TODO = "ROADMAP Queue 1 item 13"


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
    if cfg.moe is not None:
        missing.append("MoE FFN layers")
    if cfg.attn_kind == "mla":
        missing.append("MLA attention")
    if cfg.hybrid_attn_period:
        missing.append("the Jamba attention/SSM hybrid")
    if cfg.attn_softcap is not None or cfg.final_softcap is not None \
            or cfg.local_global or cfg.post_norm:
        missing.append("Gemma-2 soft-capping, local/global layers and post-norms")
    if cfg.frontend is not None or cfg.encoder_only:
        missing.append(f"the {cfg.frontend or 'encoder'} frontend")
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


class Block(nn.Module):
    """One layer: ``ln1``, ``mixer`` and, where the config has one, ``ln2``
    and ``ffn``; parameters allocated (uninitialised) on ``device``.  For
    configs that pass :func:`check_supported` (``Model`` checks)."""

    def __init__(self, cfg: ModelConfig, meta: LayerMeta, device):
        super().__init__()
        self.cfg, self.meta = cfg, meta
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.empty(d, device=device), requires_grad=False)
        mixer = attention if meta.kind == "attn" else ssm
        self.mixer = _params(mixer.param_shapes(cfg), device)
        self.has_ffn = cfg.d_ff > 0 and cfg.arch_type != "ssm"
        if self.has_ffn:
            self.ln2 = nn.Parameter(torch.empty(d, device=device), requires_grad=False)
            self.ffn = _params(_ffn_shapes(cfg), device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return apply_block(self, x, positions=positions)


def init_block(block: Block, gen: torch.Generator) -> None:
    """Fill a block's parameters in place: norms 0, the mixer's and FFN's
    initialisers."""
    with torch.no_grad():
        block.ln1.zero_()
        (attention if block.meta.kind == "attn" else ssm).init(block.mixer, gen)
        if block.has_ffn:
            block.ln2.zero_()
            layers.dense_init_(block.ffn["w_gate"], gen)
            layers.dense_init_(block.ffn["w_up"], gen)
            layers.dense_init_(block.ffn["w_down"], gen)


def apply_block(block: Block, x: torch.Tensor, *, positions: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> x + mixer(norm(x)) [+ ffn(norm(.))]."""
    cfg, meta = block.cfg, block.meta
    h = layers.rms_norm(x, block.ln1, cfg.norm_eps)
    if meta.kind == "attn":
        mix = attention.apply(block.mixer, cfg, h, positions=positions,
                              window=meta.window)
    else:
        mix = ssm.apply(block.mixer, cfg, h)
    x = x + mix
    if block.has_ffn:
        h = layers.rms_norm(x, block.ln2, cfg.norm_eps)
        f = block.ffn
        x = x + layers.swiglu(h, f["w_gate"], f["w_up"], f["w_down"], cfg.act)
    return x
