"""One GP step: the fused Algorithm-1 iteration, the acceleration layer and
the chunk loop body.

Port of ``repro.core.engine`` for one device, without telemetry.  The
stage solver follows the instance (``traffic.resolve_solver("auto",
inst)``).  Per iteration, on the dense
route (``batched_lu``):

  * one batched LU of every (app, stage) system, shared by the traffic
    sweep (trans=1) and the marginal recursion (trans=0);
  * the blocked node sets, the whole mask in one launch of the dense
    blocked-set kernel;
  * the projection (eqs. 8-10) over the 12-rung stepsize ladder, whose
    candidates form ONE leading batch dim: one factor launch over
    12·A·K1 matrices and one chain launch over 12·A chains measure every
    candidate's flows at once.

On the sparse route (an instance with a sparse topology at V >= 128, the
metro path) nothing is factored: the traffic, marginal and ladder chains
are one ``bsr_chain`` launch each, and the blocked sets one launch of the
neighbor-list kernel.

**Members.**  The instance may carry a leading member dim (a stacked
family, ``batch.pad_instances``).  Every tensor of the step and of the
carry then has it in front, the ladder's candidates are
``(B, 12, A, K1, V, V)`` and go through the same single launches, and each
member takes its own rung, stepsize, latches and Anderson window: no loop
over members.

**The acceleration layer** (the reference's DESIGN.md §15), switched on by
an :class:`AccelConfig`:

  * Anderson mixing over phi: an (m, N) window of evaluated iterates and
    plain-step displacements in the carry, a regularized least-squares
    combination, accepted only if the mixed strategy is feasible and no
    costlier than the plain step (else the plain step commits);
  * an opt-in adaptive stepsize: a 4-rung ladder (grow, 1, shrink, 0)
    around a per-member carry alpha that follows the winning rung;
  * sufficiency-residual stopping: the residual latch uses the exact
    ``conditions.sufficiency_residual`` form, and a committed move at a
    positive stepsize of at most ``phi_tol`` latches the stop too.

:func:`scan_chunk` advances a :class:`SolveCarry` by a fixed number of
iterations without reading anything back to the host: the early stop is a
``done`` latch that freezes the carry, as in the reference's scan body.
:func:`reset_carry` re-arms a carry for the next re-convergence after an
online event.

**Frozen applications.**  ``app_mask`` ((..., A) bool) freezes the
applications where it is False: every ladder candidate (and the Anderson
mix) keeps their incoming rows before its flows are measured, so each rung
costs exactly what it would commit, and the residual ignores their
directions.  Frozen applications still load the shared F/G measurement.
This is the residual skip gate of the online re-solve.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import traffic as traffic_mod
from repro_torch.core.marginals import BIG, marginals
from repro_torch.core.network import Instance
from repro_torch.core.traffic import (
    Phi, feasibility_violation, flows, renormalize, total_cost, traffic_is_valid,
)
from repro_torch.kernels import blocked_sets as blocked_sets_mod
from repro_torch.kernels import ops

TIE_EPS = 1e-6      # directions within this of the min-delta receive mass
BLOCK_EPS = 1e-7    # strictness slack for pdt comparisons

# Multipliers of alpha tried each iteration; the best candidate wins, and
# multiplier 0 keeps the cost from ever increasing (monotone descent).
ALPHA_LADDER = tuple(4.0 ** (1 - k) for k in range(11)) + (0.0,)


class AccelConfig(NamedTuple):
    """Toggles of the acceleration layer (the reference's defaults).

      anderson_m     history window of the Anderson mixer (0 disables it)
      adaptive_alpha per-member adaptive stepsize replacing the fixed ladder
      residual_stop  exact sufficiency residual + phi-delta fixed-point stop
      phi_tol        phi-delta latch: a committed positive-stepsize move of
                     max|dphi| <= phi_tol stops the solve (< 0 disables it)
      anderson_reg   relative Tikhonov regularization of the Gram matrix
      alpha_grow / alpha_shrink / alpha_min / alpha_max
                     the adaptive ladder's multipliers (grow, 1, shrink, 0)
                     on the carry alpha, and the winner's clip range
    """

    anderson_m: int = 5
    adaptive_alpha: bool = False
    residual_stop: bool = True
    phi_tol: float = 1e-6
    anderson_reg: float = 1e-8
    alpha_grow: float = 2.0
    alpha_shrink: float = 0.25
    alpha_min: float = 1e-6
    alpha_max: float = 64.0


# The default config callers opt into with accel=True/"default".
DEFAULT_ACCEL = AccelConfig()


def resolve_accel(accel) -> Optional[AccelConfig]:
    """None/False -> None (the plain iteration); True/"default"/"on" ->
    :data:`DEFAULT_ACCEL`; an :class:`AccelConfig` passes through."""
    if accel is None or accel is False:
        return None
    if accel is True or accel in ("default", "on"):
        return DEFAULT_ACCEL
    if isinstance(accel, AccelConfig):
        return accel
    raise TypeError(f"accel must be None/bool/'default'/AccelConfig, got {accel!r}")


class GPState(NamedTuple):
    """One step's outcome; every field has the member dims (or none)."""

    phi: Phi
    cost: torch.Tensor       # float32 committed cost of the winning rung
    residual: torch.Tensor   # float32 sufficiency residual (0 => optimal)
    alpha: torch.Tensor      # float32 stepsize of the winning rung
    rung: torch.Tensor       # int64 winning ladder-rung index
    ladder_costs: torch.Tensor  # (..., R) float32 every rung's cost (inf: invalid)


class SolveCarry(NamedTuple):
    """State of the solve loop, all device tensors (no host reads); each
    field has the member dims in front.  The accel fields are placeholders
    when their mechanism is off."""

    phi: Phi
    best_cost: torch.Tensor  # float32, monotone-descent tracker
    stall: torch.Tensor      # int64, iterations without improvement
    done: torch.Tensor       # bool, early-stop latch
    iters: torch.Tensor      # int64, iterations committed so far
    cost: torch.Tensor       # float32, last committed cost
    residual: torch.Tensor   # float32, last committed residual
    alpha: torch.Tensor      # float32, adaptive stepsize (0 = unseeded)
    ax: torch.Tensor         # (..., m, N) Anderson iterate window, newest last
    af: torch.Tensor         # (..., m, N) Anderson displacement window
    ak: torch.Tensor         # int64, pairs pushed so far (at most m)


def _member(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-member ``mask`` viewed to broadcast against ``x``."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def _choose(mask: torch.Tensor, a, b):
    """Per member: ``a`` where ``mask``, else ``b`` (tensors or Phi)."""
    if isinstance(a, Phi):
        return Phi(e=_choose(mask, a.e, b.e), c=_choose(mask, a.c, b.c))
    return torch.where(_member(mask, a), a, b)


def _freeze(app_mask: Optional[torch.Tensor], cand: Phi, phi: Phi,
            lead: int = 0) -> Phi:
    """``cand`` with the rows of the applications frozen by ``app_mask``
    ((..., A) bool, False = frozen) taken from ``phi``; ``lead`` counts the
    dims ``cand`` has between the member dims and (A, K1, ...) (the
    ladder's), which ``phi`` lacks."""
    if app_mask is None:
        return cand
    live = app_mask.reshape(app_mask.shape[:-1] + (1,) * lead + app_mask.shape[-1:])
    pe = phi.e.reshape(phi.e.shape[:-4] + (1,) * lead + phi.e.shape[-4:])
    pc = phi.c.reshape(phi.c.shape[:-3] + (1,) * lead + phi.c.shape[-3:])
    return Phi(e=torch.where(live[..., None, None, None], cand.e, pe),
               c=torch.where(live[..., None, None], cand.c, pc))


# ---------------------------------------------------------------------------
# Blocked node sets
# ---------------------------------------------------------------------------

def blocked_sets(inst: Instance, phi: Phi, pdt: torch.Tensor,
                 method: str = "bitset") -> torch.Tensor:
    """(..., A, K1, V, V) bool: j in B_i(a,k).

    j is blocked for i at stage (a,k) if (Section IV "Blocked node set"):
      1) (i,j) not in E, or
      2) dD/dt_j(a,k) > dD/dt_i(a,k), or
      3) j's routing subtree for (a,k) contains an improper link (p,q)
         with dD/dt_q > dD/dt_p ("tagged" nodes).

    ``method="bitset"`` computes the whole mask in one launch of the dense
    blocked-set kernel (``ops.blocked_set``), and upgrades to ``"nbr"``
    (bit-equal, O(E) work per round instead of O(V^2 / 32)) where the
    instance takes the sparse route (``traffic.resolve_solver``); ``"nbr"``
    is one launch of the neighbor-list kernel (``ops.blocked_set_nbr``);
    ``"scan"`` is the dense V-round reference in PyTorch.  All give the same
    mask, bit for bit.
    """
    if method == "bitset" and traffic_mod.resolve_solver("auto", inst) == "sparse":
        method = "nbr"
    if method == "nbr":
        return ops.blocked_set_nbr(inst.adj, phi.e, pdt, inst.out_nbr, inst.out_mask,
                                   eps=BLOCK_EPS)
    if method == "bitset":
        return ops.blocked_set(inst.adj, phi.e, pdt, eps=BLOCK_EPS)
    if method != "scan":
        raise ValueError(f"unknown blocked-set method {method!r}")
    route = phi.e > 0.0
    worse = pdt[..., None, :] > pdt[..., :, None] + BLOCK_EPS     # pdt_q > pdt_p
    improper = route & worse
    tagged = blocked_sets_mod.tagged_scan_dense(route, improper)
    return ((~inst.adj[..., None, None, :, :]) | improper | worse
            | tagged[..., None, :])


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
                      scaled: bool = False,
                      accel: Optional[AccelConfig] = None,
                      app_mask: Optional[torch.Tensor] = None):
    """The projection step's candidates at every ladder rung.

    Returns ``(cands, ladder, residual)``: ``cands`` is a :class:`Phi` with
    a ladder dim after the member dims (``(..., R, A, K1, V, V)``),
    ``ladder`` the (..., R) stepsizes (``alpha`` is a scalar or one per
    member), ``residual`` the sufficiency residual of ``phi`` per member.
    R is 12 (:data:`ALPHA_LADDER`), or 4 with ``accel.adaptive_alpha``.
    With ``app_mask`` the frozen applications' rows of every candidate are
    ``phi``'s and their directions leave the residual.
    """
    solver = traffic_mod.resolve_solver("auto", inst)
    fact = traffic_mod.stage_factors(phi.e) if solver == "batched_lu" else None
    fl = flows(inst, phi, fact)
    m = marginals(inst, phi, fl, fact)
    bset = blocked_sets(inst, phi, m.pdt)

    adj_e = inst.adj[..., None, None, :, :]
    if allowed_e is not None:
        adj_e = adj_e & allowed_e
    cpu_c = inst.cpu_allowed()[..., None]
    if allowed_c is not None:
        cpu_c = cpu_c & allowed_c
    delta_e = torch.where(adj_e & ~bset, m.delta_e, BIG)
    delta_c = torch.where(cpu_c, m.delta_c, BIG)
    min_delta = torch.minimum(delta_e.amin(-1), delta_c)       # (...,A,K1,V)

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
    N = is_min_e.sum(-1) + is_min_c                             # (...,A,K1,V)

    if accel is not None and accel.adaptive_alpha:
        # short ladder around the carry alpha: grow, keep, shrink, and 0
        mults = (accel.alpha_grow, 1.0, accel.alpha_shrink, 0.0)
    else:
        mults = ALPHA_LADDER
    dev = phi.c.device
    ladder = (torch.as_tensor(alpha, dtype=torch.float32, device=dev)[..., None]
              * torch.tensor(mults, dtype=torch.float32, device=dev))   # (..., R)
    a = ladder[..., None, None, None]                           # (..., R, 1, 1, 1)
    # the ladder dim goes in front of (A, K1, ...)
    pe, de, me, ee = (x.unsqueeze(-5) for x in (phi.e, delta_e, is_min_e, e_e))
    pc, dc, mc, ec, n = (x.unsqueeze(-4)
                         for x in (phi.c, delta_c, is_min_c, e_c, N))
    # reductions: blocked directions surrender everything; positive-e
    # directions surrender min(phi, alpha * e)   (eq. 9)
    zero = phi.c.new_zeros(())
    red_e = torch.where(de >= BIG / 2, pe,
                        torch.where(me, zero, torch.minimum(pe, a[..., None] * ee)))
    red_c = torch.where(dc >= BIG / 2, pc,
                        torch.where(mc, zero, torch.minimum(pc, a * ec)))
    share = (red_e.sum(-1) + red_c) / torch.clamp_min(n, 1)     # (...,R,A,K1,V)
    cands = renormalize(inst.lifted, Phi(
        e=pe - red_e + share[..., None] * me,
        c=pc - red_c + share * mc,
    ))
    # frozen apps keep their incoming rows, before any flow is measured
    cands = _freeze(app_mask, cands, phi, lead=1)

    if accel is not None and accel.residual_stop:
        # the exact conditions.sufficiency_residual form: the minimum over
        # all directions, not the blocked-masked set
        min_margin = torch.minimum(m.delta_e.amin(-1), m.delta_c)
    else:
        min_margin = min_delta
    exc_e = torch.where(phi.e > 1e-6, m.delta_e - min_margin[..., None], zero)
    exc_c = torch.where(phi.c > 1e-6, m.delta_c - min_margin, zero)
    if app_mask is not None:
        # the stop latch does not wait on frozen apps
        exc_e = torch.where(app_mask[..., None, None, None], exc_e, zero)
        exc_c = torch.where(app_mask[..., None, None], exc_c, zero)
    residual = torch.maximum(exc_e.flatten(-4).amax(-1), exc_c.flatten(-3).amax(-1))
    return cands, ladder, residual


def _take_rung(x: torch.Tensor, best: torch.Tensor, core: int) -> torch.Tensor:
    """Each member's ``best`` rung of ``x`` (..., R, *core dims)."""
    idx = best.reshape(best.shape + (1,) * (core + 1))
    return torch.take_along_dim(x, idx, dim=-core - 1).squeeze(-core - 1)


def gp_step(inst: Instance, phi: Phi, alpha,
            allowed_e: Optional[torch.Tensor] = None,
            allowed_c: Optional[torch.Tensor] = None,
            scaled: bool = False,
            accel: Optional[AccelConfig] = None,
            app_mask: Optional[torch.Tensor] = None) -> GPState:
    """One fused GP iteration: project at every ladder rung, keep the best.

    A too-aggressive candidate can form a routing loop, whose divergent
    traffic gives an inf/NaN cost; NaN becomes inf before the argmin so
    such candidates lose it (``torch.argmin`` would return the NaN's index).
    Ties go to the first rung, as in the reference.  Each member picks its
    own rung.  ``app_mask`` ((..., A) bool) freezes the applications where
    it is False (module docstring).
    """
    cands, ladder, residual = ladder_candidates(
        inst, phi, alpha, allowed_e, allowed_c, scaled, accel, app_mask)
    cand_costs = _strategy_cost(inst.lifted, cands)         # (..., R)
    cand_costs = torch.where(torch.isnan(cand_costs), torch.inf, cand_costs)
    best = torch.argmin(cand_costs, dim=-1)
    return GPState(phi=Phi(e=_take_rung(cands.e, best, 4),
                           c=_take_rung(cands.c, best, 3)),
                   cost=_take_rung(cand_costs, best, 0), residual=residual,
                   alpha=_take_rung(ladder.expand(cand_costs.shape), best, 0),
                   rung=best, ladder_costs=cand_costs)


# ---------------------------------------------------------------------------
# Anderson mixing
# ---------------------------------------------------------------------------

def _flat_phi(phi: Phi) -> torch.Tensor:
    """Each member's strategy as one float32 vector (e, then c)."""
    return torch.cat([phi.e.flatten(-4), phi.c.flatten(-3)], dim=-1).to(torch.float32)


def _unflat_phi(vec: torch.Tensor, like: Phi) -> Phi:
    ne = math.prod(like.e.shape[-4:])
    return Phi(e=vec[..., :ne].reshape(like.e.shape).to(like.e.dtype),
               c=vec[..., ne:].reshape(like.c.shape).to(like.c.dtype))


def _anderson_mix(ax, af, ak, x_k, f_k, reg: float) -> torch.Tensor:
    """Type-II windowed Anderson combination of the fixed-point map g.

    Given the evaluated pair ``(x_k, f_k)`` (``f = g(x) - x``, the plain GP
    step's displacement) and windows of the last m pairs, solve the
    regularized least-squares problem

        min_gamma || f_k - sum_j gamma_j (f_k - f_j) ||

    by its (m, m) normal equations and return the mixed iterate

        x_mix = g_k - sum_j gamma_j (g_k - g_j),  g = x + f.

    Slots never written (``j < m - ak``) contribute zero rows; the Tikhonov
    term keeps the Gram matrix invertible, and their gamma is exactly 0.

    The three products over N run member by member, each as in a
    one-member solve; the rest runs on the whole batch: elementwise, and
    the (m, m) systems in one batched solve, which gives each member its
    one-member solve's bits (LAPACK solves each matrix alone on the CPU;
    on the card the two agreed bit for bit on random and nearly collinear
    windows).  A batched float32 product rounds a member's sums by the
    blocking it picks for the whole batch, which changes with the batch
    size: one member's ``dF @ f_k`` alone and among 31 others differ in the
    last bit (on the CPU), and in the 32-seed ensemble that flipped an
    Anderson acceptance the member did not take alone or in the reference.
    Sums in a batch-independent order of their own round differently from
    the one-member products and flipped other members' Anderson decisions
    against the reference's.
    """
    m = ax.shape[-2]
    valid = (torch.arange(m, device=ax.device)
             >= (m - torch.clamp_max(ak, m))[..., None])           # (..., m)
    zero = f_k.new_zeros(())
    dF = torch.where(valid[..., None], f_k[..., None, :] - af, zero)  # (..., m, N)
    g_k = x_k + f_k
    dG = g_k[..., None, :] - (ax + af)                             # (..., m, N)
    lead = f_k.shape[:-1]
    n = math.prod(lead)
    dF_n, dG_n, f_n = dF.reshape(n, m, -1), dG.reshape(n, m, -1), f_k.reshape(n, -1, 1)
    gram = torch.stack([dF_n[i] @ dF_n[i].transpose(0, 1) for i in range(n)])
    b = torch.stack([dF_n[i] @ f_n[i] for i in range(n)]).squeeze(-1)
    lam = reg * (torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) / m) + 1e-12
    eye = torch.eye(m, dtype=gram.dtype, device=gram.device)
    # solve_ex: the solve's own error check would wait on the card
    gamma = torch.linalg.solve_ex(gram + lam[..., None, None] * eye, b)[0]
    gamma = torch.where(valid.reshape(n, m), gamma, zero)
    comb = torch.stack([gamma[i, None, :] @ dG_n[i] for i in range(n)]).squeeze(-2)
    return g_k - comb.reshape(f_k.shape)


def _push_history(buf: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Drop the oldest window row and append ``row`` (newest last)."""
    return torch.cat([buf[..., 1:, :], row[..., None, :]], dim=-2)


# ---------------------------------------------------------------------------
# Chunked loop body (the single-device part of the reference's scan body)
# ---------------------------------------------------------------------------

def init_carry(inst: Instance, phi: Phi,
               accel: Optional[AccelConfig] = None) -> SolveCarry:
    """A fresh carry at ``phi``, with the member dims of ``inst``."""
    dev = phi.c.device
    cost0 = total_cost(inst, phi).to(torch.float32)
    bs = cost0.shape
    m = accel.anderson_m if accel is not None else 0
    n = math.prod(phi.e.shape[-4:]) + math.prod(phi.c.shape[-3:]) if m > 0 else 0
    int0 = torch.zeros(bs, dtype=torch.int64, device=dev)
    return SolveCarry(
        phi=phi,
        best_cost=cost0,
        stall=int0,
        done=torch.zeros(bs, dtype=torch.bool, device=dev),
        iters=int0,
        cost=cost0,
        residual=torch.full(bs, torch.inf, dtype=torch.float32, device=dev),
        alpha=torch.zeros(bs, dtype=torch.float32, device=dev),
        ax=torch.zeros(bs + (m, n), dtype=torch.float32, device=dev),
        af=torch.zeros(bs + (m, n), dtype=torch.float32, device=dev),
        ak=int0,
    )


def reset_carry(inst: Instance, phi: Phi, carry: SolveCarry, *,
                keep_window: bool = False) -> SolveCarry:
    """Re-arm a carry for a new re-convergence (after an online event).

    Rebuilds the bookkeeping around the (possibly repaired) strategy
    ``phi``: cost and best cost at the current instance, the stall, done
    and iteration latches cleared.  ``keep_window=True`` keeps the
    Anderson window and the adaptive stepsize (a small rate change: the
    stale pairs only feed a mix that the safeguard, costed under the new
    instance, may reject); ``keep_window=False`` clears them (a topology
    event, where the fixed-point map itself changed).
    """
    cost0 = total_cost(inst, phi).to(torch.float32)
    int0 = torch.zeros_like(carry.iters)
    return carry._replace(
        phi=phi,
        best_cost=cost0,
        stall=int0,
        done=torch.zeros_like(carry.done),
        iters=int0,
        cost=cost0,
        residual=torch.full_like(carry.residual, torch.inf),
        alpha=carry.alpha if keep_window else torch.zeros_like(carry.alpha),
        ax=carry.ax if keep_window else torch.zeros_like(carry.ax),
        af=carry.af if keep_window else torch.zeros_like(carry.af),
        ak=carry.ak if keep_window else int0,
    )


# Per-step records of scan_chunk(record=True): the decisions of each step,
# from which a trajectory that leaves another one can be traced to the step
# and the decision where it left (a rung tie, an Anderson acceptance, a
# stop latch).
RECORDS = ("rung", "alpha", "ladder_costs", "anderson", "mix_cost", "phi_delta")


def scan_chunk(inst: Instance, carry: SolveCarry, alpha, tol, patience: int,
               max_iters: int, allowed_e: Optional[torch.Tensor] = None,
               allowed_c: Optional[torch.Tensor] = None, *, length: int,
               scaled: bool = False, accel: Optional[AccelConfig] = None,
               app_mask: Optional[torch.Tensor] = None, record: bool = False):
    """Advance the solve by ``length`` iterations, entirely on the device.

    Once ``done`` latches (residual below tol, no improvement for
    ``patience`` iterations, the ``max_iters`` budget spent, or, with
    ``accel.residual_stop``, a committed positive-stepsize move of at most
    ``accel.phi_tol``) the carry is frozen and later steps re-emit the
    converged (cost, residual).  With ``accel`` the step runs the
    acceleration layer (module docstring).  Returns ``(carry, costs
    (length, ...), residuals (length, ...))``, and with ``record=True`` a
    fourth item, {name: (length, ...) tensor} for each of :data:`RECORDS`:
    the winning rung, its stepsize, every rung's cost, the Anderson
    decision (1 accepted, 0 rejected, -1 mixer off), the mixed candidate's
    cost (inf with the mixer off) and the committed move max|dphi|.
    Records of frozen steps are not meaningful.  ``app_mask`` freezes
    applications (module docstring), in the Anderson mix too.
    """
    use_anderson = accel is not None and accel.anderson_m > 0
    use_adaptive = accel is not None and accel.adaptive_alpha
    use_phistop = (accel is not None and accel.residual_stop
                   and accel.phi_tol >= 0)
    costs_out, res_out = [], []
    recs = {k: [] for k in RECORDS} if record else None
    c = carry
    for _ in range(length):
        # carry alpha 0 = unseeded: the first iteration takes the caller's
        alpha_eff = torch.where(c.alpha > 0, c.alpha, alpha) if use_adaptive else alpha
        state = gp_step(inst, c.phi, alpha_eff, allowed_e, allowed_c, scaled, accel,
                        app_mask)
        new_phi, new_cost = state.phi, state.cost
        ax, af, ak = c.ax, c.af, c.ak
        accept, cost_mix = None, None
        if use_anderson:
            x_k = _flat_phi(c.phi)
            f_k = _flat_phi(state.phi) - x_k
            mix = _anderson_mix(ax, af, ak, x_k, f_k, accel.anderson_reg)
            # the mixer extrapolates over the whole flattened phi: frozen
            # apps are put back before the mix is costed
            phi_mix = _freeze(app_mask, renormalize(inst, _unflat_phi(mix, c.phi)), c.phi)
            cost_mix = _strategy_cost(inst, phi_mix)
            cost_mix = torch.where(torch.isnan(cost_mix), torch.inf, cost_mix)
            feas = feasibility_violation(inst, phi_mix)
            # safeguard: accept only a feasible, no-worse mixed iterate
            accept = (ak >= 1) & (cost_mix <= state.cost) & (feas <= 1e-5)
            new_phi = _choose(accept, phi_mix, state.phi)
            new_cost = torch.where(accept, cost_mix, state.cost)
            # the window holds evaluated pairs of the plain map
            ax = _push_history(ax, x_k)
            af = _push_history(af, f_k)
            ak = torch.clamp_max(ak + 1, accel.anderson_m)

        frz = c.done
        phi = _choose(frz, c.phi, new_phi)
        cost = torch.where(frz, c.cost, new_cost)
        residual = torch.where(frz, c.residual, state.residual)
        improved = new_cost < c.best_cost * (1 - 1e-6)
        best = torch.where(frz | ~improved, c.best_cost, new_cost)
        stall = torch.where(frz, c.stall,
                            torch.where(improved, 0, c.stall + 1))
        iters = c.iters + (~frz).to(torch.int64)
        done = frz | (residual <= tol) | (stall >= patience) | (iters >= max_iters)

        new_alpha = c.alpha
        if use_adaptive:
            chosen = state.alpha
            grown = torch.clamp(chosen, accel.alpha_min, accel.alpha_max)
            shrunk = torch.clamp_min(alpha_eff * accel.alpha_shrink, accel.alpha_min)
            new_alpha = torch.where(frz, c.alpha,
                                    torch.where(chosen > 0, grown, shrunk))
        if use_anderson:
            ax = _choose(frz, c.ax, ax)
            af = _choose(frz, c.af, af)
            ak = torch.where(frz, c.ak, ak)
        if use_phistop or record:
            moved = torch.maximum((new_phi.e - c.phi.e).abs().flatten(-4).amax(-1),
                                  (new_phi.c - c.phi.c).abs().flatten(-3).amax(-1))
        if use_phistop:
            # phi-delta fixed point: a committed move at a positive stepsize
            # that left phi (numerically) unchanged; a 0-rung win does not
            # latch
            fixed = (state.alpha > 0) & (moved <= accel.phi_tol)
            done = done | (~frz & fixed)
        if record:
            none = torch.full_like(state.cost, -1.0)
            for k, v in (("rung", state.rung), ("alpha", state.alpha),
                         ("ladder_costs", state.ladder_costs),
                         ("anderson", none if accept is None else accept.to(torch.float32)),
                         ("mix_cost", torch.full_like(state.cost, torch.inf)
                          if cost_mix is None else cost_mix),
                         ("phi_delta", moved)):
                recs[k].append(v)

        c = SolveCarry(phi=phi, best_cost=best, stall=stall, done=done,
                       iters=iters, cost=cost, residual=residual,
                       alpha=new_alpha, ax=ax, af=af, ak=ak)
        costs_out.append(cost)
        res_out.append(residual)
    if record:
        return (c, torch.stack(costs_out), torch.stack(res_out),
                {k: torch.stack(v) for k, v in recs.items()})
    return c, torch.stack(costs_out), torch.stack(res_out)
