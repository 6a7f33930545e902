"""Mamba-2 SSD mixer (arXiv:2405.21060), cache-less.

Port of the prefill path of ``repro.models.ssm``.  The sequence is cut
into chunks of Q = 128 tokens; the intra-chunk core (``C Bᵀ`` weighted by
the decay, times X, and each chunk's state) is ``ops.ssd_chunk``: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors.  The
inter-chunk recurrence over the chunk states is a plain loop over the
chunks.  B and C are read by group (``H // G`` heads per group), not
repeated per head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

CHUNK = 128


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return s, di, nh, conv_dim


def param_shapes(cfg: ModelConfig) -> dict:
    s, di, nh, conv_dim = _dims(cfg)
    in_dim = 2 * di + 2 * s.n_groups * s.d_state + nh
    return {"w_in": (cfg.d_model, in_dim), "conv_w": (conv_dim, s.d_conv),
            "conv_b": (conv_dim,), "a_log": (nh,), "d_skip": (nh,),
            "dt_bias": (nh,), "norm": (di,), "w_out": (di, cfg.d_model)}


def init(params, gen: torch.Generator) -> None:
    """Fill ``params`` (name -> tensor of :func:`param_shapes`) in place, with
    the reference's values: dense projections, a conv kernel of std
    1/d_conv, A = -(1..nh), D = 1, zero biases and norm."""
    layers.dense_init_(params["w_in"], gen)
    conv_w = params["conv_w"]
    conv_w.normal_(0.0, 1.0, generator=gen).div_(conv_w.shape[1])
    params["conv_b"].zero_()
    a_log = params["a_log"]
    a_log.copy_(torch.log(torch.arange(1, a_log.numel() + 1, dtype=torch.float32,
                                       device=a_log.device)))
    params["d_skip"].fill_(1.0)
    params["dt_bias"].zero_()
    params["norm"].zero_()
    layers.dense_init_(params["w_out"], gen)


def _split(cfg: ModelConfig, proj: torch.Tensor):
    """in-projection -> (z, x, B, C, dt) along the last axis."""
    s, di, nh, _ = _dims(cfg)
    gN = s.n_groups * s.d_state
    return torch.split(proj, [di, di, gN, gN, nh], dim=-1)


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d from a zero history: seq (B, S, Cd), w (Cd, K)
    -> (B, S, Cd)."""
    S, K = seq.shape[1], w.shape[1]
    full = F.pad(seq, (0, 0, K - 1, 0))                       # (B, S+K-1, Cd)
    out = full[:, 0:S] * w[:, 0]
    for j in range(1, K):
        out = out + full[:, j:j + S] * w[:, j]
    return out + b


def ssd_chunked(xh, dt, A, Bc, Cc):
    """SSD forward in chunked matmul form.

    xh (B, S, H, P), dt (B, S, H), A (H,) (negative), Bc/Cc (B, S, G, N)
    -> (y (B, S, H, P), h_last (B, H, P, N)), float32.
    """
    Bsz, S, H, P = xh.shape
    G, N = Bc.shape[2], Bc.shape[3]
    rep = H // G
    Q = min(CHUNK, S)
    nc = S // Q
    if nc * Q != S:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD chunk {Q}")

    xh = xh.float().reshape(Bsz, nc, Q, H, P)
    dt = dt.float().reshape(Bsz, nc, Q, H)
    Bc = Bc.float().reshape(Bsz, nc, Q, G, N)
    Cc = Cc.float().reshape(Bsz, nc, Q, G, N)
    dtA = dt * A[None, None, None, :]
    cum = torch.cumsum(dtA, dim=2)                            # within-chunk
    seg_total = cum[:, :, -1, :]                              # (B, nc, H)

    y_intra, state_c = ops.ssd_chunk(xh, dt, cum, Bc, Cc)

    # inter-chunk recurrence over chunk states; h at each chunk's start
    gamma = torch.exp(seg_total)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * gamma[:, c, :, None, None] + state_c[:, c]
    h_starts = torch.stack(starts, dim=1)                     # (B, nc, H, P, N)

    # inter contribution: exp(cum_i) * (C_i . h_start), C by group
    ch = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cc,
                      h_starts.reshape(Bsz, nc, G, rep, P, N))
    y_inter = ch.reshape(Bsz, nc, Q, H, P) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(Bsz, S, H, P), h


def apply(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Mamba-2 block body (no residual/norm around it)."""
    s, di, nh, _ = _dims(cfg)
    B, S, _ = x.shape
    z, xs, Bc, Cc, dt = _split(cfg, x @ params["w_in"])

    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"], params["conv_b"]))
    gN = s.n_groups * s.d_state
    xs = conv_out[..., :di]
    Bc = conv_out[..., di:di + gN]
    Cc = conv_out[..., di + gN:]

    xh = xs.reshape(B, S, nh, s.head_dim)
    Bc = Bc.reshape(B, S, s.n_groups, s.d_state)
    Cc = Cc.reshape(B, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])

    y, _ = ssd_chunked(xh, dt, A, Bc, Cc)
    y = y + xh.float() * params["d_skip"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = layers.rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["w_out"]

