"""One GP step: the fused Algorithm-1 iteration, and the chunk loop body.

Port of ``repro.core.engine`` for one device, without the acceleration
layer (``accel=None``), application masks or telemetry.  The stage solver
follows the instance (``traffic.resolve_solver("auto", inst)``).  Per
iteration, on the dense route (``batched_lu``):

  * one batched LU of every (app, stage) system, shared by the traffic
    sweep (trans=1) and the marginal recursion (trans=0);
  * the blocked node sets, whose tagged-node fixed point is one launch of
    the tagged kernel;
  * the projection (eqs. 8-10) over the 12-rung stepsize ladder, whose
    candidates form ONE leading batch dim: one factor launch over
    12·A·K1 matrices and one chain launch over 12·A chains measure every
    candidate's flows at once.

On the sparse route (an instance with a sparse topology at V >= 128, the
metro path) nothing is factored: the traffic, marginal and ladder chains
are one ``bsr_chain`` launch each, and the tagged nodes one ``tagged_nbr``
launch on the out-neighbor lists.

:func:`scan_chunk` advances a :class:`SolveCarry` by a fixed number of
iterations without reading anything back to the host: the early stop is a
``done`` latch that freezes the carry, as in the reference's scan body.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import traffic as traffic_mod
from repro_torch.core.marginals import BIG, marginals
from repro_torch.core.network import Instance
from repro_torch.core.traffic import (
    Phi, flows, renormalize, total_cost, traffic_is_valid,
)
from repro_torch.kernels import blocked_sets as blocked_sets_mod
from repro_torch.kernels import ops

TIE_EPS = 1e-6      # directions within this of the min-delta receive mass
BLOCK_EPS = 1e-7    # strictness slack for pdt comparisons

# Multipliers of alpha tried each iteration; the best candidate wins, and
# multiplier 0 keeps the cost from ever increasing (monotone descent).
ALPHA_LADDER = tuple(4.0 ** (1 - k) for k in range(11)) + (0.0,)


class GPState(NamedTuple):
    phi: Phi
    cost: torch.Tensor       # () float32
    residual: torch.Tensor   # () float32 sufficiency residual (0 => optimal)
    alpha: torch.Tensor      # () float32 stepsize of the winning rung
    rung: torch.Tensor       # () int64 winning ladder-rung index


class SolveCarry(NamedTuple):
    """State of the solve loop, all device tensors (no host reads)."""

    phi: Phi
    best_cost: torch.Tensor  # float32, monotone-descent tracker
    stall: torch.Tensor      # int64, iterations without improvement
    done: torch.Tensor       # bool, early-stop latch
    iters: torch.Tensor      # int64, iterations committed so far
    cost: torch.Tensor       # float32, last committed cost
    residual: torch.Tensor   # float32, last committed residual


# ---------------------------------------------------------------------------
# Blocked node sets
# ---------------------------------------------------------------------------

def blocked_sets(inst: Instance, phi: Phi, pdt: torch.Tensor,
                 method: str = "bitset") -> torch.Tensor:
    """(A,K1,V,V) bool: j in B_i(a,k).

    j is blocked for i at stage (a,k) if (Section IV "Blocked node set"):
      1) (i,j) not in E, or
      2) dD/dt_j(a,k) > dD/dt_i(a,k), or
      3) j's routing subtree for (a,k) contains an improper link (p,q)
         with dD/dt_q > dD/dt_p ("tagged" nodes).

    ``method="bitset"`` runs category 3 through the tagged kernel
    (``ops.blocked_tagged``), and upgrades to ``"nbr"`` (bit-equal, O(E)
    work per round instead of O(V^2 / 32)) where the instance takes the
    sparse route (``traffic.resolve_solver``);
    ``"nbr"`` runs it on the padded out-neighbor lists
    (``ops.blocked_tagged_nbr``); ``"scan"`` is the dense V-round
    reference.  All give the same least fixed point, bit for bit.
    """
    route = phi.e > 0.0
    worse = pdt[:, :, None, :] > pdt[:, :, :, None] + BLOCK_EPS   # pdt_q > pdt_p
    improper = route & worse
    if method == "bitset" and traffic_mod.resolve_solver("auto", inst) == "sparse":
        method = "nbr"
    if method == "nbr":
        tagged = ops.blocked_tagged_nbr(route, improper, inst.out_nbr,
                                        inst.out_mask)
    elif method == "bitset":
        tagged = ops.blocked_tagged(route, improper)
    elif method == "scan":
        tagged = blocked_sets_mod.tagged_scan_dense(route, improper)
    else:
        raise ValueError(f"unknown blocked-set method {method!r}")
    return (~inst.adj[None, None]) | improper | worse | tagged[:, :, None, :]


# ---------------------------------------------------------------------------
# One GP iteration (eqs. 8-10)
# ---------------------------------------------------------------------------

def _strategy_cost(inst: Instance, phi: Phi) -> torch.Tensor:
    """Objective of (a stack of) candidate strategies; inf where invalid."""
    fl = flows(inst, phi)
    cost = traffic_mod.cost_of_flows(inst, fl.F, fl.G)
    return torch.where(traffic_is_valid(inst, fl.t), cost, torch.inf)


def ladder_candidates(inst: Instance, phi: Phi, alpha,
                      allowed_e: Optional[torch.Tensor] = None,
                      allowed_c: Optional[torch.Tensor] = None,
                      scaled: bool = False):
    """The projection step's candidates at every ladder rung.

    Returns ``(cands, ladder, residual)``: ``cands`` is a :class:`Phi` with
    a leading ladder dim of ``len(ALPHA_LADDER)``, ``ladder`` the (12,)
    stepsizes, ``residual`` the sufficiency residual of ``phi`` against the
    blocked-masked minimum marginals.
    """
    solver = traffic_mod.resolve_solver("auto", inst)
    fact = traffic_mod.stage_factors(phi.e) if solver == "batched_lu" else None
    fl = flows(inst, phi, fact)
    m = marginals(inst, phi, fl, fact)
    bset = blocked_sets(inst, phi, m.pdt)

    adj_e = inst.adj[None, None]
    if allowed_e is not None:
        adj_e = adj_e & allowed_e
    cpu_c = inst.cpu_allowed()[:, :, None]
    if allowed_c is not None:
        cpu_c = cpu_c & allowed_c
    delta_e = torch.where(adj_e & ~bset, m.delta_e, BIG)
    delta_c = torch.where(cpu_c, m.delta_c, BIG)
    min_delta = torch.minimum(delta_e.amin(-1), delta_c)       # (A,K1,V)

    # Fallback guard: if blocking removed every direction of a row that must
    # forward (transiently, on congested iterates), fall back to the
    # topology's direction set for that row.
    stuck = min_delta >= BIG / 2
    delta_e = torch.where(stuck[..., None], torch.where(adj_e, m.delta_e, BIG),
                          delta_e)
    delta_c = torch.where(stuck, torch.where(cpu_c, m.delta_c, BIG), delta_c)
    min_delta = torch.minimum(delta_e.amin(-1), delta_c)

    e_e = delta_e - min_delta[..., None]                        # e_ij >= 0
    e_c = delta_c - min_delta
    if scaled:
        # quasi-Newton diagonal scaling by the per-row marginal magnitude
        scale_row = torch.clamp_min(min_delta.abs(), 1e-6)
        e_e = e_e / scale_row[..., None]
        e_c = e_c / scale_row

    is_min_e = (e_e <= TIE_EPS) & (delta_e < BIG / 2)
    is_min_c = (e_c <= TIE_EPS) & (delta_c < BIG / 2)
    N = is_min_e.sum(-1) + is_min_c                             # (A,K1,V)

    ladder = (torch.as_tensor(alpha, dtype=torch.float32, device=phi.c.device)
              * torch.tensor(ALPHA_LADDER, dtype=torch.float32,
                             device=phi.c.device))
    a = ladder.view(-1, 1, 1, 1)
    # reductions: blocked directions surrender everything; positive-e
    # directions surrender min(phi, alpha * e)   (eq. 9)
    zero = phi.c.new_zeros(())
    red_e = torch.where(delta_e >= BIG / 2, phi.e,
                        torch.where(is_min_e, zero,
                                    torch.minimum(phi.e, a[..., None] * e_e)))
    red_c = torch.where(delta_c >= BIG / 2, phi.c,
                        torch.where(is_min_c, zero, torch.minimum(phi.c, a * e_c)))
    share = (red_e.sum(-1) + red_c) / torch.clamp_min(N, 1)     # (12,A,K1,V)
    cands = renormalize(inst, Phi(
        e=phi.e - red_e + share[..., None] * is_min_e,
        c=phi.c - red_c + share * is_min_c,
    ))

    exc_e = torch.where(phi.e > 1e-6, m.delta_e - min_delta[..., None], zero)
    exc_c = torch.where(phi.c > 1e-6, m.delta_c - min_delta, zero)
    residual = torch.maximum(exc_e.max(), exc_c.max())
    return cands, ladder, residual


def gp_step(inst: Instance, phi: Phi, alpha,
            allowed_e: Optional[torch.Tensor] = None,
            allowed_c: Optional[torch.Tensor] = None,
            scaled: bool = False) -> GPState:
    """One fused GP iteration: project at every ladder rung, keep the best.

    A too-aggressive candidate can form a routing loop, whose divergent
    traffic gives an inf/NaN cost; NaN becomes inf before the argmin so
    such candidates lose it (``torch.argmin`` would return the NaN's index).
    Ties go to the first rung, as in the reference.
    """
    cands, ladder, residual = ladder_candidates(
        inst, phi, alpha, allowed_e, allowed_c, scaled)
    cand_costs = _strategy_cost(inst, cands)
    cand_costs = torch.where(torch.isnan(cand_costs), torch.inf, cand_costs)
    best = torch.argmin(cand_costs).reshape(1)
    new_phi = Phi(e=cands.e.index_select(0, best)[0],
                  c=cands.c.index_select(0, best)[0])
    return GPState(phi=new_phi, cost=cand_costs.index_select(0, best)[0],
                   residual=residual, alpha=ladder.index_select(0, best)[0],
                   rung=best[0])


# ---------------------------------------------------------------------------
# Chunked loop body (the single-device part of the reference's scan body)
# ---------------------------------------------------------------------------

def init_carry(inst: Instance, phi: Phi) -> SolveCarry:
    dev = phi.c.device
    cost0 = total_cost(inst, phi).to(torch.float32)
    return SolveCarry(
        phi=phi,
        best_cost=cost0,
        stall=torch.zeros((), dtype=torch.int64, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        iters=torch.zeros((), dtype=torch.int64, device=dev),
        cost=cost0,
        residual=torch.full((), torch.inf, dtype=torch.float32, device=dev),
    )


def scan_chunk(inst: Instance, carry: SolveCarry, alpha, tol, patience: int,
               max_iters: int, allowed_e: Optional[torch.Tensor] = None,
               allowed_c: Optional[torch.Tensor] = None, *, length: int,
               scaled: bool = False):
    """Advance the solve by ``length`` iterations, entirely on the device.

    Once ``done`` latches (residual below tol, no improvement for
    ``patience`` iterations, or the ``max_iters`` budget spent) the carry is
    frozen and later steps re-emit the converged (cost, residual).  Returns
    ``(carry, costs (length,), residuals (length,))``.
    """
    costs_out, res_out = [], []
    c = carry
    for _ in range(length):
        state = gp_step(inst, c.phi, alpha, allowed_e, allowed_c, scaled)
        frz = c.done
        phi = Phi(e=torch.where(frz, c.phi.e, state.phi.e),
                  c=torch.where(frz, c.phi.c, state.phi.c))
        cost = torch.where(frz, c.cost, state.cost)
        residual = torch.where(frz, c.residual, state.residual)
        improved = state.cost < c.best_cost * (1 - 1e-6)
        best = torch.where(frz | ~improved, c.best_cost, state.cost)
        stall = torch.where(frz, c.stall,
                            torch.where(improved, 0, c.stall + 1))
        iters = c.iters + (~frz).to(torch.int64)
        done = frz | (residual <= tol) | (stall >= patience) | (iters >= max_iters)
        c = SolveCarry(phi=phi, best_cost=best, stall=stall, done=done,
                       iters=iters, cost=cost, residual=residual)
        costs_out.append(cost)
        res_out.append(residual)
    return c, torch.stack(costs_out), torch.stack(res_out)
