"""Mixture-of-Experts FFN with capacity-based token dropping.

Port of ``repro.models.moe``.  Top-k routing over a float32 softmax gate,
the gate weights renormalised, and the reference's load-balance aux loss;
dispatch by each choice's running position in its expert over the
flattened ``(T, top_k)`` choices, a choice at position C or past it
dropped; the experts' gated FFN over a fixed ``(E, C, d)`` buffer as three
batched products; the gate-weighted combine and the optional always-on
shared experts (DeepSeek-V3).

The reference's ``expert_axis`` (a GSPMD sharding pin of the buffer's
expert dim) has no meaning on one card and is not ported; the
expert-parallel variant (``repro.models.moe_ep``) belongs to the
multi-device item of the ROADMAP.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's ``MoEParams`` names and shapes; with no shared
    expert the three ``shared_*`` tensors are zero-width."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_expert
    sf = m.n_shared * f
    return {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
            "w_down": (E, f, d), "shared_gate": (d, sf), "shared_up": (d, sf),
            "shared_down": (sf, d)}


def init(params, gen: torch.Generator) -> None:
    """Fill ``params`` (name -> tensor of :func:`param_shapes`) in place with
    the reference's distributions: N(0, 1/fan_in), the experts' fan-in
    their middle axis."""
    for name in ("router", "shared_gate", "shared_up", "shared_down"):
        layers.dense_init_(params[name], gen)
    for name in ("w_gate", "w_up", "w_down"):
        layers.dense_init_(params[name], gen, in_axis=1)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` of non-negative float32 ``probs`` (T, E): the k
    largest, in descending order, the lower index first among equal values.
    ``torch.topk`` runs on an int64 key, the value's bits (monotone for
    non-negative floats) times E plus the reversed index, which no two
    entries share."""
    E = probs.shape[-1]
    rev = E - 1 - torch.arange(E, device=probs.device)
    key = probs.contiguous().view(torch.int32).to(torch.int64) * E + rev
    ids = torch.topk(key, k, dim=-1).indices
    return probs.gather(-1, ids), ids


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """x (T, d) -> (gate weights (T, k), expert ids (T, k), aux loss, probs
    (T, E)).  The aux loss is the reference's as written:
    ``E * mean(onehot(ids[:, 0]).mean(0) * probs.mean(0)) * E``."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gw, ids = _top_k(probs, top_k)
    gw = gw / torch.clamp_min(gw.sum(-1, keepdim=True), 1e-9)
    E = probs.shape[-1]
    hard = (ids[:, :1] == torch.arange(E, device=ids.device)).float()
    aux = E * torch.mean(hard.mean(0) * probs.mean(0)) * E
    return gw.to(x.dtype), ids, aux, probs


def capacity(T: int, cfg: ModelConfig) -> int:
    """Rows per expert: T * top_k * capacity_factor / E truncated, rounded
    up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(T * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)


def slots(flat_ids: torch.Tensor, E: int, C: int):
    """Each choice's row in its expert's buffer: flat_ids (T*k,) in the
    flattened (T, k) order -> (row (T*k,), 0 where dropped; keep (T*k,)
    bool).  A choice's position is the running count of earlier choices of
    its expert; positions C and past are dropped."""
    hit = flat_ids[:, None] == torch.arange(E, device=flat_ids.device)
    pos = torch.cumsum(hit, dim=0, dtype=torch.int64) - 1
    pos = pos.gather(1, flat_ids[:, None])[:, 0]
    keep = pos < C
    return torch.where(keep, pos, 0), keep


def apply(params, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d), aux loss, a float32 scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    T, k = B * S, m.top_k
    xt = x.reshape(T, d)
    gw, ids, aux, _ = route(params["router"], xt, k)

    E, C = m.n_experts, capacity(T, cfg)
    flat = ids.reshape(-1)
    row, keep = slots(flat, E, C)
    keep_f = keep[:, None].to(xt.dtype)
    # a dropped choice adds a zero row at its expert's row 0, as the
    # reference's scatter-add does
    src = xt.repeat_interleave(k, dim=0) * keep_f
    buf = xt.new_zeros((E, C, d)).index_put_((flat, row), src, accumulate=True)

    act = layers.act_fn(cfg.act)
    g = act(torch.bmm(buf, params["w_gate"]))
    u = torch.bmm(buf, params["w_up"])
    eo = torch.bmm(g * u, params["w_down"])

    out_tk = eo[flat, row] * keep_f                                    # (T*k, d)
    out = (out_tk.reshape(T, k, d) * gw[..., None]).sum(1)
    if m.n_shared:
        out = out + layers.swiglu(xt, params["shared_gate"], params["shared_up"],
                                  params["shared_down"], cfg.act)
    return out.reshape(B, S, d), aux
