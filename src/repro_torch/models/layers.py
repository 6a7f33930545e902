"""Shared neural-net building blocks: port of ``repro.models.layers``.

Parameters are plain tensors; the initialisers draw from an explicit
``torch.Generator`` on the parameter's device, with the reference's
distributions (``jax.random`` and ``torch`` give different numbers from
one seed, so the parity tests carry weights across as numpy arrays).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = act_fn(act)(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: (..., S) -> rotated x (same dtype)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., :, None].float() * freqs             # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# initialisers: fill a tensor in place from ``gen`` on its device
# ---------------------------------------------------------------------------

def dense_init_(t: torch.Tensor, gen: torch.Generator, in_axis: int = 0) -> torch.Tensor:
    """Normal with std ``fan_in ** -0.5``, fan_in = ``t.shape[in_axis]``."""
    fan_in = max(t.shape[in_axis], 1)          # zero-width params
    return t.normal_(0.0, fan_in ** -0.5, generator=gen)


def embed_init_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Standard normal."""
    return t.normal_(0.0, 1.0, generator=gen)
