"""Algorithm 1: Gradient Projection (GP) for problem (2), single device.

Port of the single-instance drivers of ``repro.core.gp``: the loop-free
initial strategy (LPR-SC stage-expanded shortest paths), the host-side
:class:`GPResult`, and :func:`solve`, which runs the engine's chunk loop and
reads the ``done`` latch back to the host once per 32-iteration chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import costs
from repro_torch.core import engine
from repro_torch.core.network import Device, Instance, resolve_device
from repro_torch.core.traffic import Phi, renormalize

gp_step = engine.gp_step


@dataclasses.dataclass
class GPResult:
    """Solve summary.

    ``cost_history[0]`` is the initial cost and entry ``i`` the cost after
    iteration ``i``; results of :func:`solve` are trimmed to the committed
    prefix.  Histories are tensors on the solve's device.
    """

    phi: Phi
    cost_history: torch.Tensor
    residual_history: torch.Tensor
    iterations: int

    def trim(self) -> "GPResult":
        """Cut the histories back to the committed iteration prefix."""
        n = int(self.iterations)
        return dataclasses.replace(
            self,
            cost_history=self.cost_history[: n + 1],
            residual_history=self.residual_history[:n],
        )

    @property
    def final_cost(self) -> float:
        return float(self.cost_history[-1])


# ---------------------------------------------------------------------------
# Initial strategies (loop-free, finite cost)
# ---------------------------------------------------------------------------

def _zero_flow_weights(inst: Instance) -> tuple[torch.Tensor, torch.Tensor]:
    """Link and CPU marginals at zero flow (the 'uncongested' metrics)."""
    Dp0 = torch.where(
        inst.adj,
        costs.marginal(inst.link_kind, torch.zeros_like(inst.link_param),
                       inst.link_param),
        torch.inf,
    )
    Cp0 = costs.marginal(inst.comp_kind, torch.zeros_like(inst.comp_param),
                         inst.comp_param)
    return Dp0, Cp0


def expanded_shortest_path(inst: Instance) -> tuple[torch.Tensor, Phi]:
    """Stage-expanded single-destination shortest paths at zero flow.

    Returns (dist, phi): dist[a,k,i] is the min uncongested cost-to-go from
    (i, stage k) to (d_a, stage K_a), and phi routes integrally along the
    argmin successors (first index on ties).  This is the LPR-SC baseline
    and the default loop-free initialization for GP.  The float32 constants
    (1e18 for "unreachable", the 1e-5 per-hop tie breaker on top of inf
    off-graph weights) and the V-round relaxation are the reference's, so
    ties break identically.
    """
    Dp0, Cp0 = _zero_flow_weights(inst)
    V, K1, A = inst.V, inst.K1, inst.A
    dev = inst.device
    INF = torch.tensor(1e18, dtype=torch.float32, device=dev)
    at_dst = torch.arange(V, device=dev)[None, :] == inst.dst[:, None]    # (A,V)

    dist_next = INF.expand(A, V)
    dists = [None] * K1
    for k in range(K1 - 1, -1, -1):
        is_last = (inst.n_tasks == k)[:, None]                             # (A,1)
        # absorbing cost: at the last stage, reaching dst ends the chain
        comp = torch.where(is_last, INF,
                           inst.w[:, k, None] * inst.wnode * Cp0 + dist_next)
        dist = torch.where(is_last & at_dst, 0.0, comp)
        # tiny per-hop epsilon: ties break toward fewer hops, so the argmin
        # successor graph is acyclic even at zero packet size
        wmat = inst.L[:, k, None, None] * Dp0 + 1e-5                       # (A,V,V)
        for _ in range(V):
            via = (wmat + dist[:, None, :]).amin(dim=2)
            dist = torch.minimum(dist, via)
        dists[k] = dist
        dist_next = dist
    dist = torch.stack(dists, dim=1)                                       # (A,K1,V)

    # successor choice: CPU (cost w*C'0 + dist[k+1,i]) vs each link
    dist_next = torch.cat([dist[:, 1:], torch.full_like(dist[:, :1], 1e18)], dim=1)
    cand_c = torch.where(
        inst.cpu_allowed()[:, :, None],
        inst.w[:, :, None] * inst.wnode[None, None] * Cp0[None, None] + dist_next,
        INF,
    )
    cand_e = torch.where(
        inst.adj[None, None],
        inst.L[:, :, None, None] * Dp0[None, None] + 1e-5 + dist[:, :, None, :],
        INF,
    )
    all_cand = torch.cat([cand_c[..., None], cand_e], dim=-1)              # (A,K1,V,1+V)
    best = torch.argmin(all_cand, dim=-1)
    phi_c = (best == 0).to(torch.float32)
    phi_e = (torch.arange(V, device=dev) == (best - 1)[..., None]).to(torch.float32)
    return dist, renormalize(inst, Phi(e=phi_e, c=phi_c))


def init_phi(inst: Instance) -> Phi:
    """Default loop-free initial strategy with finite cost."""
    _, phi = expanded_shortest_path(inst)
    return phi


# ---------------------------------------------------------------------------
# Solver driver
# ---------------------------------------------------------------------------

_SOLVE_CHUNK = 32    # the host reads the early-stop latch once per chunk


def solve(
    inst: Instance,
    phi0: Optional[Phi] = None,
    *,
    alpha: float = 0.02,
    max_iters: int = 400,
    tol: float = 1e-4,
    allowed_e: Optional[torch.Tensor] = None,
    allowed_c: Optional[torch.Tensor] = None,
    patience: int = 40,
    scaled: bool = False,
    device: Device = "cuda",
) -> GPResult:
    """Run Algorithm 1 until the sufficiency residual falls below tol.

    The loop body never syncs to the host; only the ``done`` latch is read
    back, once every ``_SOLVE_CHUNK`` iterations, so a converged run stops
    early.  ``inst`` must lie on ``device`` (CUDA unless the caller passes
    ``device="cpu"``).
    """
    dev = resolve_device(device)
    if inst.device.type != dev.type:
        raise ValueError(f"instance is on {inst.device}, solve asked for {dev}")
    phi = phi0 if phi0 is not None else init_phi(inst)
    carry = engine.init_carry(inst, phi)
    cost0 = carry.cost
    alpha_ = torch.tensor(alpha, dtype=torch.float32, device=inst.device)
    cost_chunks, res_chunks = [], []
    steps = 0
    while steps < max_iters:
        carry, cs, rs = engine.scan_chunk(
            inst, carry, alpha_, tol, patience, max_iters, allowed_e, allowed_c,
            length=min(_SOLVE_CHUNK, max_iters - steps), scaled=scaled)
        cost_chunks.append(cs)
        res_chunks.append(rs)
        steps += len(cs)
        if bool(carry.done):
            break
    empty = cost0.new_zeros((0,))
    return GPResult(
        phi=carry.phi,
        cost_history=torch.cat([cost0[None], *cost_chunks]),
        residual_history=torch.cat(res_chunks) if res_chunks else empty,
        iterations=int(carry.iters),
    ).trim()
