"""Closed-form marginal costs and modified marginals (eqs. (3), (4), (7)).

Port of ``repro.core.marginals``.  ``pdt[a,k,i] = dD/dt_i(a,k)`` satisfies
the backward recursion (4):

    pdt_k(i) = sum_j phi_ij(k) (L_k D'_ij + pdt_k(j))
             + phi_i0(k) (w(a,k) C'_i + pdt_{k+1}(i))

whose per-stage matrix is ``I - Phi_k`` (not transposed), solved exactly,
walking the stages in reverse and clamping at 0.  The modified marginals
(7) are

    delta_ij(a,k) = L_k D'_ij + pdt[a,k,j]                     (j != 0)
    delta_i0(a,k) = w(a,k) C'_i + pdt[a,k+1,i]                 (j == 0)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.network import Instance
from repro_torch.core.traffic import (
    Flows, Phi, comp_marginals, flows, link_marginals, resolve_solver,
    stage_factors,
)
from repro_torch.kernels import ops

# Marginal assigned to non-existent directions ((i,j) not in E, or CPU at
# the final stage): the paper's "infinity" (footnote 4).
BIG = 1e9


class Marginals(NamedTuple):
    pdt: torch.Tensor       # (..., A, K1, V)     dD/dt_i(a,k)
    delta_e: torch.Tensor   # (..., A, K1, V, V)  delta_ij(a,k); BIG on non-links
    delta_c: torch.Tensor   # (..., A, K1, V)     delta_i0(a,k); BIG when k == K_a
    Dp: torch.Tensor        # (..., V, V)         D'_ij(F_ij)
    Cp: torch.Tensor        # (..., V)            C'_i(G_i)


def pdt_base(inst: Instance, phi: Phi, Dp: torch.Tensor,
             Cp: torch.Tensor) -> torch.Tensor:
    """(..., A, K1, V) right-hand side of recursion (4) without the chain term:
    sum_j phi_ij L_k D'_ij + phi_i0 w_k wnode_i C'_i."""
    link_term = torch.einsum(
        "...akij,...akij->...aki", phi.e,
        inst.L[..., None, None] * Dp[..., None, None, :, :])
    return link_term + phi.c * (
        inst.w[..., None] * inst.wnode[..., None, None, :] * Cp[..., None, None, :])


def pdt_recursion(inst: Instance, phi: Phi, Dp: torch.Tensor, Cp: torch.Tensor,
                  fact: Optional[ops.BatchedLU] = None, *,
                  solver: str = "auto") -> torch.Tensor:
    """Solve recursion (4) for all stages of all applications.

    ``batched_lu``: one fused reverse chain-solve launch over the (shared)
    stage factors, pdt_k = (I - Phi_k)^-1 (base_k + phi_c_k * pdt_{k+1}),
    clamped at 0.  ``sparse``: the same chain by blocked fixed-point sweeps,
    one launch, no factors.
    """
    solver = resolve_solver(solver, inst)
    if solver == "dense":
        return _per_app_dense(inst, Dp, Cp, phi.e, phi.c)
    if solver == "sparse":
        return ops.sparse_chain_solve(phi.e, pdt_base(inst, phi, Dp, Cp), phi.c,
                                      inst.blk_nbr, inst.blk_mask,
                                      trans=0, reverse=True, clamp=True)
    if fact is None:
        fact = stage_factors(phi.e)
    return ops.fused_chain_solve(fact, pdt_base(inst, phi, Dp, Cp), phi.c,
                                 trans=0, reverse=True, clamp=True)


def _per_app_dense(inst, Dp, Cp, phi_e, phi_c):
    """The seed's recursion with per-stage dense solves, every application
    at once: the differential reference of the ``batched_lu`` path."""
    link_term = torch.einsum(
        "akij,akij->aki", phi_e, inst.L[:, :, None, None] * Dp[None, None])
    V = inst.V
    eye = torch.eye(V, dtype=phi_e.dtype, device=phi_e.device)
    pdt_next = torch.zeros_like(phi_c[:, 0])
    out = []
    for k in range(inst.K1 - 1, -1, -1):
        b = link_term[:, k] + phi_c[:, k] * (
            inst.w[:, k, None] * inst.wnode * Cp + pdt_next)
        pdt_k = torch.linalg.solve(eye - phi_e[:, k], b.unsqueeze(-1)).squeeze(-1)
        pdt_next = torch.maximum(pdt_k, pdt_k.new_zeros(()))
        out.append(pdt_next)
    return torch.stack(out[::-1], dim=1)


def marginals(inst: Instance, phi: Phi, fl: Optional[Flows] = None,
              fact: Optional[ops.BatchedLU] = None, *,
              solver: str = "auto") -> Marginals:
    """All marginal quantities for strategy phi."""
    if fl is None:
        fl = flows(inst, phi, fact, solver=solver)
    Dp = link_marginals(inst, fl.F)
    Cp = comp_marginals(inst, fl.G)
    pdt = pdt_recursion(inst, phi, Dp, Cp, fact, solver=solver)

    delta_e = (inst.L[..., None, None] * Dp[..., None, None, :, :]
               + pdt[..., None, :])
    delta_e = torch.where(inst.adj[..., None, None, :, :], delta_e, BIG)

    pdt_next = torch.cat([pdt[..., 1:, :], torch.zeros_like(pdt[..., :1, :])],
                         dim=-2)
    delta_c = (inst.w[..., None] * inst.wnode[..., None, None, :]
               * Cp[..., None, None, :] + pdt_next)
    delta_c = torch.where(inst.cpu_allowed()[..., None], delta_c, BIG)
    return Marginals(pdt=pdt, delta_e=delta_e, delta_c=delta_c, Dp=Dp, Cp=Cp)


def dD_dphi(inst: Instance, phi: Phi) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form dD/dphi_ij(a,k) of eq. (3): t_i(a,k) * delta_ij(a,k).

    Returns (grad_e (..., A, K1, V, V), grad_c (..., A, K1, V)), zero on
    the directions that do not exist.
    """
    fl = flows(inst, phi)
    m = marginals(inst, phi, fl)
    zero = phi.e.new_zeros(())
    grad_e = fl.t[..., None] * torch.where(inst.adj[..., None, None, :, :], m.delta_e, zero)
    grad_c = fl.t * torch.where(inst.cpu_allowed()[..., None], m.delta_c, zero)
    return grad_e, grad_c
