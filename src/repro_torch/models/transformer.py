"""Config-driven model: embedding -> block stack -> final norm -> head.

Port of ``repro.models.transformer``: the cache-less forward (score /
prefill without a cache), the cached prefill and the single-token decode
(``Model.apply`` with a cache from ``Model.init_cache``).  One
:class:`~repro_torch.models.blocks.Block` module per layer, in order, and
one cache entry per layer; the reference's scan over layer periods is
gone (``convert.model_params_from_numpy`` and ``convert.cache_from_numpy``
unstack its period axis).

``Model.apply(..., return_aux=True)`` also returns the summed load-balance
aux loss of the MoE layers, as the reference's ``apply`` does (zero for a
model without MoE layers).

``Model`` allocates its parameters on the device (CUDA unless the caller
asks for the CPU) and :meth:`Model.init` fills them from a seeded
``torch.Generator`` on that device with the reference's distributions.
A vertical split is the same forward cut in two:
``head(apply_layers(apply_layers(embed(batch), 0, b), b, n))``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.network import Device, resolve_device
from repro_torch.models import attention, blocks, layers


class Model(nn.Module):
    """Parameters: ``embedding`` (vocab, d), ``final_norm`` (d), ``lm_head``
    (d, vocab) unless tied, ``layers.<i>.*`` per block."""

    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "naive",
                 device: Device = "cuda"):
        super().__init__()
        cfg.validate()
        blocks.check_supported(cfg)
        if attn_impl not in ("naive", "blockwise"):
            raise ValueError(f"attn_impl {attn_impl!r}: 'naive' or 'blockwise'")
        dev = resolve_device(device)
        self.cfg = cfg
        # "blockwise": attention.sdpa_blockwise, online softmax over KV blocks;
        # passed to the blocks at each call
        self.attn_impl = attn_impl

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=dev), requires_grad=False)

        self.embedding = param(cfg.vocab, cfg.d_model)
        self.final_norm = param(cfg.d_model)
        if not cfg.tie_embeddings:
            self.lm_head = param(cfg.d_model, cfg.vocab)
        self.layers = nn.ModuleList(
            blocks.Block(cfg, blocks.layer_meta(cfg, i), dev)
            for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def init(self, seed: int | torch.Generator = 0) -> "Model":
        """Fill every parameter in place from ``seed`` (an int, or a
        generator on the model's device); returns the model."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.no_grad():
            layers.embed_init_(self.embedding, gen)
            self.final_norm.zero_()
            if not self.cfg.tie_embeddings:
                layers.dense_init_(self.lm_head, gen)
            for block in self.layers:
                blocks.init_block(block, gen)
        return self

    def positions(self, batch: int, seq: int) -> torch.Tensor:
        return torch.arange(seq, device=self.device)[None].expand(batch, seq)

    def embed(self, batch: dict) -> torch.Tensor:
        """{"tokens": (B, S) int} -> x (B, S, d)."""
        return self.embedding[batch["tokens"]]

    def apply_layers(self, x: torch.Tensor, start: int = 0, stop: int | None = None,
                     positions: torch.Tensor | None = None) -> torch.Tensor:
        """Run layers ``start:stop`` on the residual stream x (B, S, d)."""
        if positions is None:
            positions = self.positions(x.shape[0], x.shape[1])
        for block in self.layers[start:stop]:
            x, _, _ = block(x, positions, impl=self.attn_impl)
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = layers.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embedding.T if self.cfg.tie_embeddings else self.lm_head
        return layers.softcap((x @ w).float(), self.cfg.final_softcap)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> list:
        """One empty cache entry per layer, in layer order, on the model's
        device: (k, v) of (batch, max_len, KV, hd) for attention layers,
        (conv state, float32 SSM state) for SSM layers."""
        return [blocks.init_block_cache(self.cfg, block.meta, batch, max_len, dtype,
                                        self.device)
                for block in self.layers]

    @torch.no_grad()
    def apply(self, batch: dict, cache: list | None = None,
              cache_index: int | None = None, *, return_aux: bool = False):
        """{"tokens": (B, S)} -> logits (B, S, vocab), float32.

        With a ``cache`` (:meth:`init_cache`), the S tokens sit at positions
        ``cache_index .. cache_index + S - 1`` (0 if None) and attend to the
        cache's first ``cache_index + S`` rows; returns ``(logits,
        new_cache)``.  Attention caches are written in place; SSM layers'
        entries are new tensors, so use the returned list.  With
        ``return_aux`` the summed aux loss of the MoE layers (a float32
        scalar, summed in layer order from zero) comes last: ``(logits,
        aux)`` or ``(logits, new_cache, aux)``.
        """
        x = self.embed(batch)
        B, S = x.shape[:2]
        ci = 0 if cache_index is None else int(cache_index)
        positions = self.positions(B, S)
        if ci:
            positions = positions + ci
        aux = torch.zeros((), dtype=torch.float32, device=x.device) if return_aux else None
        view = None
        attn = [i for i, b in enumerate(self.layers) if b.meta.kind == "attn"]
        if cache is not None and attn:
            # the cache rows' positions, valid prefixes and masks, once a call
            view = attention.cache_view(
                self.cfg, positions, cache[attn[0]][0].shape[1], ci,
                [self.layers[i].meta.window for i in attn], self.attn_impl)
        new_cache = []
        entries = [None] * len(self.layers) if cache is None else cache
        for block, c in zip(self.layers, entries, strict=True):
            x, c, a = block(x, positions, cache=c, cache_index=ci, impl=self.attn_impl,
                            view=view)
            new_cache.append(c)
            if return_aux and a is not None:
                aux = aux + a
        out = (self.head(x),) if cache is None else (self.head(x), new_cache)
        if return_aux:
            out += (aux,)
        return out[0] if len(out) == 1 else out


def make_model(cfg_or_name, *, reduced: bool = False, attn_impl: str = "naive",
               device: Device = "cuda") -> Model:
    if isinstance(cfg_or_name, str):
        from repro_torch import configs
        cfg = configs.get(cfg_or_name, reduced=reduced)
    else:
        cfg = cfg_or_name
    return Model(cfg, attn_impl=attn_impl, device=device)
