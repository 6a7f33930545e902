"""The MoE FFN's yardsticks, shared by the CPU tests, the card tests and
``chip_smoke.py`` (no JAX here: the card's machine has none).

* :func:`per_expert_route` computes an MoE layer's output one expert at a
  time, independently of ``models.moe``'s dispatch buffer: per expert, the
  kept choices (the first C of that expert in the flattened ``(T, top_k)``
  order), their rows gathered, the gated FFN on them, scaled by the gate
  weight and ``index_add``-ed back.  Its arithmetic runs in the dtype
  asked for (float64: the float32 layer's yardstick).
* :func:`recorded_routes` and :func:`forced_routes` let two forwards of
  one model that differ only by float32 rounding (through the kernels and
  through the plain versions; cached and cache-less) take the same
  routing: the second takes the first's expert choices where its own
  differ, provided every such choice is a tie, within ``tie`` of its own
  in probability.  The forced tokens are reported.
* :func:`capacity_factor` runs a model with its MoE capacity factor
  replaced, the weights shared.
"""

import contextlib
import dataclasses

import torch

from repro_torch.models import layers, moe


def per_expert_route(params, cfg, x, dtype=torch.float32):
    """x (B, S, d) -> (out (B, S, d) in ``dtype``, aux loss (float64), kept
    (T*k,) bool in the flattened (T, k) order).  The routing decisions (the
    experts, their order) are the float32 router's, ties to the lower
    expert; the gate weights, the FFN and the sums are in ``dtype``."""
    m = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    xt = x.reshape(T, d)
    probs32 = torch.softmax(xt.float() @ params["router"].float(), dim=-1)
    # a stable descending sort keeps the lower index first among equals
    ids = torch.sort(probs32, dim=-1, descending=True, stable=True).indices[:, :k]
    probs = torch.softmax(xt.to(dtype) @ params["router"].to(dtype), dim=-1)
    gw = probs.gather(1, ids)
    gw = gw / gw.sum(-1, keepdim=True).clamp_min(1e-9)
    frac = torch.bincount(ids[:, 0], minlength=E).double() / T
    aux = E * float((frac * probs32.double().mean(0)).sum())

    c = int(T * k * m.capacity_factor / E)
    C = max(8, (c + 7) // 8 * 8)
    flat = ids.reshape(-1)
    kept = torch.zeros(T * k, dtype=torch.bool, device=x.device)
    out = torch.zeros((T, d), dtype=dtype, device=x.device)
    act = layers.act_fn(cfg.act)
    xd = xt.to(dtype)
    for e in range(E):
        choice = torch.nonzero(flat == e)[:, 0][:C]
        kept[choice] = True
        tok, slot = choice // k, choice % k
        rows = xd[tok]
        h = act(rows @ params["w_gate"][e].to(dtype)) * (rows @ params["w_up"][e].to(dtype))
        y = h @ params["w_down"][e].to(dtype)
        out.index_add_(0, tok, y * gw[tok, slot][:, None])
    if m.n_shared:
        out = out + layers.swiglu(xd, params["shared_gate"].to(dtype),
                                  params["shared_up"].to(dtype),
                                  params["shared_down"].to(dtype), cfg.act)
    return out.reshape(B, S, d), aux, kept


def first_choices(flat_ids, E: int, C: int):
    """The kept mask the dispatch rule gives: each expert's first C choices
    in the flattened order, by a loop over the experts."""
    kept = torch.zeros(flat_ids.shape, dtype=torch.bool, device=flat_ids.device)
    for e in range(E):
        kept[torch.nonzero(flat_ids == e)[:, 0][:C]] = True
    return kept


@contextlib.contextmanager
def recorded_routes():
    """Within the block every ``moe.route`` call appends its expert ids
    (T, k) to the yielded list, in call order."""
    calls, real = [], moe.route

    def record(router_w, x, top_k):
        out = real(router_w, x, top_k)
        calls.append(out[1])
        return out

    moe.route = record
    try:
        yield calls
    finally:
        moe.route = real


@contextlib.contextmanager
def forced_routes(want: list, tie: float):
    """Within the block the i-th ``moe.route`` call takes ``want[i]`` (T, k)
    as its expert ids wherever its own differ, its gate weights and aux
    loss formed from its own probabilities at those ids; a row of -1 in
    ``want[i]`` (a token the recorded run did not see) keeps the call's
    own choices.  Yields a list of
    (call, token, gap) for every forced token, gap the largest difference
    of its own probability between its own and the wanted choices; a gap
    above ``tie`` raises ``AssertionError``."""
    forced, seen, real = [], [], moe.route

    def force(router_w, x, top_k):
        gw, ids, aux, probs = real(router_w, x, top_k)
        call = len(seen)
        seen.append(call)
        target = want[call].to(ids.device)
        target = torch.where(target < 0, ids, target)
        differ = (ids != target).any(-1)
        if not bool(differ.any()):
            return gw, ids, aux, probs
        gaps = (probs.gather(1, ids) - probs.gather(1, target)).abs().amax(-1)
        for t in torch.nonzero(differ)[:, 0].tolist():
            forced.append((call, t, float(gaps[t])))
            if float(gaps[t]) > tie:
                raise AssertionError(f"route call {call}, token {t}: choices "
                                     f"{ids[t].tolist()} against {target[t].tolist()} "
                                     f"differ by {float(gaps[t])} in probability, "
                                     f"above the tie {tie}")
        ids = torch.where(differ[:, None], target, ids)
        gw = probs.gather(1, ids)
        gw = gw / torch.clamp_min(gw.sum(-1, keepdim=True), 1e-9)
        E = probs.shape[-1]
        hard = (ids[:, :1] == torch.arange(E, device=ids.device)).float()
        aux = E * torch.mean(hard.mean(0) * probs.mean(0)) * E
        return gw.to(x.dtype), ids, aux, probs

    moe.route = force
    try:
        yield forced
    finally:
        moe.route = real


def join_calls(calls: list, n_layers: int, batch: int) -> list:
    """Recorded ids of a cached prefill and the decode steps after it (one
    call per MoE layer each, in call order) as the ids of one cache-less
    forward over the same tokens: per layer, the calls' (B, S_i, k) joined
    along the sequence."""
    per_call = [calls[i:i + n_layers] for i in range(0, len(calls), n_layers)]
    out = []
    for layer in range(n_layers):
        parts = [c[layer].reshape(batch, -1, c[layer].shape[-1]) for c in per_call]
        out.append(torch.cat(parts, dim=1).reshape(-1, parts[0].shape[-1]))
    return out


@contextlib.contextmanager
def capacity_factor(model, factor: float):
    """Within the block ``model`` (a ``transformer.Model``) runs with its MoE
    capacity factor set to ``factor``, nothing else of its config changed
    and its weights shared."""
    saved = model.cfg
    cfg = dataclasses.replace(saved, moe=dataclasses.replace(saved.moe,
                                                             capacity_factor=factor))
    model.cfg = cfg
    for block in model.layers:
        block.cfg = cfg
    try:
        yield cfg
    finally:
        model.cfg = saved
        for block in model.layers:
            block.cfg = saved
