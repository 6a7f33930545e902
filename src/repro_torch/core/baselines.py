"""Baselines of Section V: SPOC, LCOF, LPR-SC.

Port of ``repro.core.baselines``.  Each baseline is a restriction of the GP
machinery (direction masks):

  * SPOC  — forwarding fixed to the zero-flow shortest path toward d_a per
            stage; only the offloading split (CPU vs. next hop) is optimized.
  * LCOF  — all tasks computed at the data sources (phi_c forced for k<K);
            only the final-result forwarding (stage K) is optimized.
  * LPR-SC — the joint uncongested routing+offloading solution on the
            stage-expanded graph (zero-flow marginals), evaluated as is.

The mask constructors take a stacked family (``batch.pad_instances``) as
they take one instance: every tensor gains the member dim in front, and on
a padded member the real (node, app, stage) block is bit for bit the
unpadded computation.
"""

from __future__ import annotations

import torch

from repro_torch.core import costs, gp
from repro_torch.core.network import Instance
from repro_torch.core.traffic import Phi, renormalize, total_cost


def _sp_next_hop_mask(inst: Instance) -> torch.Tensor:
    """(..., A, K1, V, V) bool: the single shortest-path next hop toward d_a
    for each stage, measured with zero-flow marginals L_k * D'(0) (SPOC's
    'shortest path measured with marginal cost at F_ij = 0')."""
    Dp0 = torch.where(
        inst.adj,
        costs.marginal(inst.link_kind, torch.zeros_like(inst.link_param),
                       inst.link_param),
        torch.inf,
    )
    V = inst.V
    dev = inst.device
    base = torch.where(torch.arange(V, device=dev) == inst.dst[..., None],
                       0.0, torch.tensor(1e18, dtype=torch.float32, device=dev))
    dist = base[..., None, :].expand(inst.L.shape + (V,))          # (...,A,K1,V)
    # hop tie-break, as in gp.expanded_shortest_path
    wmat = inst.L[..., None, None] * Dp0[..., None, None, :, :] + 1e-5
    for _ in range(V):
        dist = torch.minimum(dist, (wmat + dist[..., None, :]).amin(dim=-1))
    nxt = torch.argmin(wmat + dist[..., None, :], dim=-1)           # (...,A,K1,V)
    return torch.arange(V, device=dev) == nxt[..., None]


def spoc_masks(inst: Instance) -> tuple[torch.Tensor, torch.Tensor, Phi]:
    """SPOC as a direction-mask restriction: (allowed_e, allowed_c, phi0).

    phi0 forwards half of every row along the shortest path and offloads
    the other half where offloading is allowed, so every stage carries
    finite traffic.  Offloading is unrestricted: ``allowed_c`` is all True
    (an array, not None, so that it batches).
    """
    allowed_e = _sp_next_hop_mask(inst)
    zero_c = torch.zeros(inst.L.shape + (inst.V,), dtype=torch.float32,
                         device=inst.device)
    phi0 = renormalize(inst, Phi(e=allowed_e.to(torch.float32), c=zero_c))
    phi0 = renormalize(inst, Phi(
        e=phi0.e * 0.5,
        c=torch.where(inst.cpu_allowed()[..., None], 0.5, 0.0)))
    allowed_c = torch.ones_like(zero_c, dtype=torch.bool)
    return allowed_e, allowed_c, phi0


def spoc(inst: Instance, **solve_kwargs) -> gp.GPResult:
    """Shortest Path Optimal Computation placement."""
    allowed_e, allowed_c, phi0 = spoc_masks(inst)
    return gp.solve(inst, phi0, allowed_e=allowed_e, allowed_c=allowed_c,
                    **solve_kwargs)


def lcof_masks(inst: Instance) -> tuple[torch.Tensor, torch.Tensor, Phi]:
    """LCOF as a direction-mask restriction (see :func:`spoc_masks`)."""
    V = inst.V
    last = torch.arange(inst.K1, device=inst.device) == inst.n_tasks[..., None]  # (...,A,K1)
    allowed_e = (last[..., None, None] & inst.adj[..., None, None, :, :]
                 ).expand(inst.L.shape + (V, V))
    allowed_c = (~last)[..., None].expand(inst.L.shape + (V,))
    phi_c0 = torch.where(inst.cpu_allowed()[..., None], 1.0, 0.0)
    _, sp_phi = gp.expanded_shortest_path(inst)
    phi0 = renormalize(inst, Phi(e=torch.where(last[..., None, None], sp_phi.e, 0.0),
                                 c=phi_c0))
    return allowed_e, allowed_c, phi0


def lcof(inst: Instance, **solve_kwargs) -> gp.GPResult:
    """Local Computation placement, Optimal Forwarding."""
    allowed_e, allowed_c, phi0 = lcof_masks(inst)
    return gp.solve(inst, phi0, allowed_e=allowed_e, allowed_c=allowed_c,
                    **solve_kwargs)


def lpr_sc(inst: Instance) -> gp.GPResult:
    """Linear-Program-Rounded for Service Chains (congestion-oblivious)."""
    _, phi = gp.expanded_shortest_path(inst)
    cost = total_cost(inst, phi)
    return gp.GPResult(phi=phi, cost_history=cost[None],
                       residual_history=cost.new_zeros((0,)), iterations=0)


def fallback_strategy(inst: Instance, order: tuple = ("SPOC", "LCOF")):
    """The first baseline whose seed strategy has a finite cost on ``inst``:
    ``(name, allowed_e, allowed_c, phi0, cost)``, or None when none has
    (the degradation ladder's floor, the reference's DESIGN.md §17)."""
    for name in order:
        allowed_e, allowed_c, phi0 = BASELINE_MASKS[name](inst)
        cost = total_cost(inst, phi0)
        if bool(torch.isfinite(cost)):
            return name, allowed_e, allowed_c, phi0, float(cost)
    return None


# Mask constructors for the batched sweeps: an Instance (or a stacked
# family) -> (allowed_e, allowed_c, phi0); see scenarios.run_sweep(masks_fn=).
BASELINE_MASKS = {"SPOC": spoc_masks, "LCOF": lcof_masks}
