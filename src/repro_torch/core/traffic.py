"""Stage traffic, link flows and computation workloads (Section II).

Port of ``repro.core.traffic``.  Given a strategy ``phi`` the stage traffics
satisfy the linear fixed points

    t(a,0) = Phi_0^T t(a,0) + r(a)
    t(a,k) = Phi_k^T t(a,k) + g(a,k-1),       g(a,k) = t(a,k) * phi_c(a,k).

``solver="batched_lu"`` factors every stage system ``I - Phi_k`` in one
batched LU (:func:`stage_factors`) and walks every chain in one fused
chain-solve launch; the same factors serve the marginal recursion, which
solves the untransposed system.  ``solver="sparse"`` (the metro path) runs
the factorization-free blocked fixed-point sweeps of
``ops.sparse_chain_solve`` on the instance's sparse topology.  ``"auto"``
picks ``"sparse"`` for an instance that carries a sparse topology at
V >= :data:`SPARSE_MIN_V`, else ``"batched_lu"``.  ``solver="dense"`` keeps
the seed's per-stage ``torch.linalg.solve`` as the differential reference.

Every function here accepts extra leading dims in front of ``(A, K1, ...)``
on the strategy, and the instance may carry member dims of its own (a
stacked family, ``batch.pad_instances``): instance fields broadcast against
the strategy from the right.  The stepsize ladder evaluates its 12
candidates as one more leading dim (the instance ``lifted`` by one), in one
factor launch and one chain launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import costs
from repro_torch.core.network import Instance
from repro_torch.kernels import ops

SOLVERS = ("batched_lu", "sparse", "dense")

# Minimum node count for "auto" to take the sparse route when the instance
# carries a sparse topology (the reference's threshold; the metro instances
# sit well above it, the Table II ones below).
SPARSE_MIN_V = 128


class Phi(NamedTuple):
    """Forwarding/offloading strategy (the optimization variable).

    e: (..., A, K1, V, V)  phi_{ij}(a,k) link-forwarding fractions
    c: (..., A, K1, V)     phi_{i0}(a,k) local-CPU offloading fractions
    """

    e: torch.Tensor
    c: torch.Tensor


class Flows(NamedTuple):
    t: torch.Tensor   # (..., A, K1, V)    stage traffic t_i(a,k)
    g: torch.Tensor   # (..., A, K1, V)    CPU rates g_i(a,k)
    f: torch.Tensor   # (..., A, K1, V, V) link rates f_ij(a,k)
    F: torch.Tensor   # (..., V, V)        total link bit-rates
    G: torch.Tensor   # (..., V)           total computation workloads


def _eye(V: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(V, dtype=like.dtype, device=like.device)


def _solve_stage(phi_e_k: torch.Tensor, inject: torch.Tensor) -> torch.Tensor:
    """Solve t = Phi_k^T t + inject for a batch of (application, stage)."""
    V = phi_e_k.shape[-1]
    mat = _eye(V, phi_e_k) - phi_e_k.transpose(-1, -2)
    return torch.linalg.solve(mat, inject.unsqueeze(-1)).squeeze(-1)


def resolve_solver(solver: str, inst: Instance) -> str:
    """Resolve ``"auto"``: ``"sparse"`` when ``inst`` carries a sparse
    topology and ``inst.V >= SPARSE_MIN_V``, else ``"batched_lu"``.

    Both are kernel paths: on CUDA tensors they launch the hand-written
    kernels, on CPU tensors their plain versions.  (The reference's dense
    crossover ``AUTO_MIN_V`` was measured on a CPU and says nothing about
    this card.)  ``"sparse"`` on an instance without a topology raises.
    """
    if solver == "auto":
        return "sparse" if inst.has_sparse and inst.V >= SPARSE_MIN_V else "batched_lu"
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; want 'auto' or one of {SOLVERS}")
    if solver == "sparse" and not inst.has_sparse:
        raise ValueError("instance carries no sparse topology; attach one with "
                         "network.with_sparse(inst) before solver='sparse'")
    return solver


def stage_factors(phi_e: torch.Tensor) -> ops.BatchedLU:
    """Batched LU of every stage system ``I - Phi_k`` in one launch.

    phi_e (..., A, K1, V, V) -> BatchedLU with the same leading dims.  The
    factors serve both sweeps: the traffic fixed point solves the
    transposed system (trans=1), the marginal recursion the plain one.
    """
    return ops.batched_factor(_eye(phi_e.shape[-1], phi_e) - phi_e)


def chain_inputs(inst: Instance, phi: Phi) -> tuple[torch.Tensor, torch.Tensor]:
    """(base, mult) of the traffic chain, each (..., A, K1, V).

    t_k = (I - Phi_k)^-T (base_k + mult_k * t_{k-1}) with base_0 = r,
    base_{k>0} = 0 and mult_k = phi_c_{k-1}: each computed packet of stage
    k-1 injects one next-stage packet.
    """
    r = inst.r.expand(phi.c[..., 0, :].shape)
    base = torch.cat([r.unsqueeze(-2), torch.zeros_like(phi.c[..., 1:, :])], dim=-2)
    mult = torch.cat([torch.zeros_like(phi.c[..., :1, :]), phi.c[..., :-1, :]],
                     dim=-2)
    return base, mult


def stage_traffic(inst: Instance, phi: Phi, fact: Optional[ops.BatchedLU] = None,
                  *, solver: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """t and g, each (..., A, K1, V), by walking every stage chain.

    No clamping: the map phi -> t stays linear; loopy candidates' divergent
    solutions are rejected by :func:`traffic_is_valid` instead.
    """
    solver = resolve_solver(solver, inst)
    if solver == "sparse":
        t = ops.sparse_chain_solve(phi.e, *chain_inputs(inst, phi), inst.blk_nbr,
                                   inst.blk_mask, trans=1)
        return t, t * phi.c
    if solver == "batched_lu":
        if fact is None:
            fact = stage_factors(phi.e)
        t = ops.fused_chain_solve(fact, *chain_inputs(inst, phi), trans=1)
        return t, t * phi.c

    ts, gs = [], []
    inject = inst.r.expand(phi.c[..., 0, :].shape)
    for k in range(phi.c.shape[-2]):
        t_k = _solve_stage(phi.e[..., k, :, :], inject)
        inject = t_k * phi.c[..., k, :]
        ts.append(t_k)
        gs.append(inject)
    return torch.stack(ts, dim=-2), torch.stack(gs, dim=-2)


def flows(inst: Instance, phi: Phi, fact: Optional[ops.BatchedLU] = None, *,
          solver: str = "auto") -> Flows:
    """All flow quantities induced by strategy phi (Table I)."""
    t, g = stage_traffic(inst, phi, fact, solver=solver)
    f = t[..., None] * phi.e                                  # (...,A,K1,V,V)
    F = torch.einsum("...ak,...akij->...ij", inst.L, f)
    G = torch.einsum("...ak,...aki->...i", inst.w, g) * inst.wnode
    return Flows(t=t, g=g, f=f, F=F, G=G)


def traffic_is_valid(inst: Instance, t: torch.Tensor) -> torch.Tensor:
    """(...,) bool: t (..., A, K1, V) is a physical (loop-free) solution.

    Flow conservation bounds every stage traffic of a loop-free strategy by
    the total injected rate; a routing loop makes the solve return values
    far outside that bound, or non-finite ones.
    """
    rmax = inst.r.sum(dim=-2).amax(dim=-1)
    bound = 4.0 * rmax + 1.0
    tt = t.flatten(-3)
    return (torch.isfinite(tt).all(dim=-1) & (tt > -1e-3).all(dim=-1)
            & (tt < bound[..., None]).all(dim=-1))


def cost_of_flows(inst: Instance, F: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """sum D_ij(F_ij) over links + sum C_i(G_i), over any leading dims."""
    D_links = torch.where(inst.adj, costs.cost(inst.link_kind, F, inst.link_param),
                          0.0)
    C_nodes = costs.cost(inst.comp_kind, G, inst.comp_param)
    return D_links.sum(dim=(-2, -1)) + C_nodes.sum(dim=-1)


def total_cost(inst: Instance, phi: Phi, *, solver: str = "auto") -> torch.Tensor:
    """Objective of problem (2): D(phi) = sum D_ij(F_ij) + sum C_i(G_i)."""
    fl = flows(inst, phi, solver=solver)
    return cost_of_flows(inst, fl.F, fl.G)


def feasibility_violation(inst: Instance, phi: Phi) -> torch.Tensor:
    """(...,) max violation of constraint (1) per strategy: the largest
    |row sum - 1| (|row sum| on degenerate rows)."""
    tot = phi.e.sum(-1) + phi.c
    want = torch.where(inst.degenerate_mask(), 0.0, 1.0)
    return (tot - want).abs().flatten(-3).amax(dim=-1)


def link_marginals(inst: Instance, F: torch.Tensor) -> torch.Tensor:
    """D'_ij(F_ij), zero on non-links."""
    m = costs.marginal(inst.link_kind, F, inst.link_param)
    return torch.where(inst.adj, m, 0.0)


def comp_marginals(inst: Instance, G: torch.Tensor) -> torch.Tensor:
    """C'_i(G_i)."""
    return costs.marginal(inst.comp_kind, G, inst.comp_param)


def renormalize(inst: Instance, phi: Phi) -> Phi:
    """Project phi back onto the simplex constraints (1), fixing drift.

    Non-negative clip, then rescale each (a,k,i) row to sum 1, except the
    degenerate rows (stage K_a at the destination, invalid stages), which
    are forced to zero; CPU fractions at the final stage are forced to zero.
    """
    zero = phi.e.new_zeros(())
    e = torch.where(inst.adj[..., None, None, :, :], torch.maximum(phi.e, zero), zero)
    c = torch.maximum(phi.c, zero) * inst.cpu_allowed()[..., None]
    tot = e.sum(-1) + c                                       # (...,A,K1,V)
    degen = inst.degenerate_mask()
    scale = torch.where(degen | (tot <= 0), zero,
                        1.0 / torch.clamp_min(tot, 1e-30))
    return Phi(e=e * scale[..., None], c=c * scale)
