"""Mamba-2 SSD mixer (arXiv:2405.21060): prefill, cached prefill and
single-token decode.

Port of ``repro.models.ssm``.  The sequence is cut into chunks of Q = 128
tokens; the intra-chunk core (``C Bᵀ`` weighted by the decay, times X, and
each chunk's state) is ``ops.ssd_chunk``: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.  The inter-chunk recurrence
over the chunk states is a plain loop over the chunks, from a zero state
or from a cache's ``h0``.  B and C are read by group (``H // G`` heads per
group), not repeated per head.  A cached call with S = 1 is the O(1)
recurrent update of the (B, H, P, N) state instead.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.network import Device, resolve_device
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


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d: seq (B, S, Cd), w (Cd, K), from ``state``
    (B, K-1, Cd), the last K-1 inputs before ``seq`` (zero without one) ->
    (out (B, S, Cd), new_state (B, K-1, Cd) in seq's dtype)."""
    S, K = seq.shape[1], w.shape[1]
    if state is None:
        full = F.pad(seq, (0, 0, K - 1, 0))                   # (B, S+K-1, Cd)
    else:
        full = torch.cat([state.to(seq.dtype), seq], dim=1)
    out = full[:, 0:S] * w[:, 0]
    for j in range(1, K):
        out = out + full[:, j:j + S] * w[:, j]
    # the last K-1 rows, which reach back into the old state when S < K-1
    return out + b, full[:, S:]


def ssd_chunked(xh, dt, A, Bc, Cc, h0=None):
    """SSD forward in chunked matmul form.

    xh (B, S, H, P), dt (B, S, H), A (H,) (negative), Bc/Cc (B, S, G, N),
    h0 (B, H, P, N) the state before the first token (zero if None) ->
    (y (B, S, H, P), h_last (B, H, P, N)), float32.
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
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
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


def apply(params, cfg: ModelConfig, x: torch.Tensor, *,
          cache: Optional[tuple] = None):
    """Mamba-2 block body (no residual/norm around it) -> (out, new_cache).

    ``cache`` (conv_state (B, K-1, conv_dim), ssm_state (B, H, P, N)): the
    sequence continues from it, by the chunked form for S > 1 and by the
    recurrent step for S = 1; ``new_cache`` holds new tensors (the conv
    state in x's dtype, the SSM state in float32), None without a cache.
    """
    s, di, nh, _ = _dims(cfg)
    B, S, _ = x.shape
    z, xs, Bc, Cc, dt = _split(cfg, x @ params["w_in"])

    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"], params["conv_b"],
                                        None if cache is None else cache[0])
    conv_out = F.silu(conv_out)
    gN = s.n_groups * s.d_state
    xs = conv_out[..., :di]
    Bc = conv_out[..., di:di + gN]
    Cc = conv_out[..., di + gN:]

    xh = xs.reshape(B, S, nh, s.head_dim)
    Bc = Bc.reshape(B, S, s.n_groups, s.d_state)
    Cc = Cc.reshape(B, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])

    if cache is None or S > 1:
        y, h_last = ssd_chunked(xh, dt, A, Bc, Cc,
                                h0=None if cache is None else cache[1])
    else:
        # one token: h = h * exp(dt A) + dt * B (x) x, y = C . h
        rep = nh // s.n_groups
        BH = Bc.repeat_interleave(rep, dim=2)[:, 0].float()  # (B, H, N)
        CH = Cc.repeat_interleave(rep, dim=2)[:, 0].float()
        dt1 = dt[:, 0]                                        # (B, H)
        decay = torch.exp(dt1 * A[None, :])
        upd = torch.einsum("bh,bhn,bhp->bhpn", dt1, BH, xh[:, 0].float())
        h_last = cache[1].float() * decay[..., None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", CH, h_last)[:, None]   # (B, 1, H, P)

    y = y + xh.float() * params["d_skip"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = layers.rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["w_out"], (None if cache is None else (conv_state, h_last))


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device: Device = "cuda") -> tuple:
    """Zero (conv_state (batch, K-1, conv_dim) in ``dtype``, ssm_state
    (batch, H, P, N) in float32 whatever ``dtype``)."""
    dev = resolve_device(device)
    s, _, nh, conv_dim = _dims(cfg)
    return (torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=dev),
            torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32,
                        device=dev))
