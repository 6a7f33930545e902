"""Algorithm 1: Gradient Projection (GP) for problem (2), single device.

Port of the solve loops of ``repro.core.gp``: the loop-free initial
strategy (LPR-SC stage-expanded shortest paths), :class:`GPResult`, and
three solvers built on the engine's chunk loop (:func:`engine.scan_chunk`):

  * :func:`solve` — one instance; reads the ``done`` latch back to the
    host once per 32-iteration chunk, so a converged run stops early;
  * :func:`solve_scan` — one instance, the whole budget as one chunk, dense
    histories (:class:`GPScan`);
  * :func:`solve_batched` — a stacked family (``batch.pad_instances``) in
    one member-batched loop, with chunks growing from 8 to 64 iterations
    and converged members compacted away between chunks;
  * :func:`solve_loop` — one instance, the per-iteration host loop (the
    reference's loop for differential testing), bit-equal to :func:`solve`.

Each of the first three takes ``accel=`` (the acceleration layer,
``engine.resolve_accel``); :func:`solve` and :func:`solve_scan` take
``app_mask=`` (frozen applications, the online skip gate).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import costs
from repro_torch.core import engine
from repro_torch.core.network import DENSE_FIELDS, Device, Instance, resolve_device
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
    # per-step decisions ({name: (iterations, ...)}, engine.RECORDS) when
    # the solve ran with record=True
    records: Optional[dict] = None

    def trim(self) -> "GPResult":
        """Cut the histories back to the committed iteration prefix."""
        n = int(self.iterations)
        return dataclasses.replace(
            self,
            cost_history=self.cost_history[: n + 1],
            residual_history=self.residual_history[:n],
            records=(None if self.records is None
                     else {k: v[:n] for k, v in self.records.items()}),
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

    Returns (dist, phi): dist[..., a, k, i] is the min uncongested
    cost-to-go from (i, stage k) to (d_a, stage K_a), and phi routes
    integrally along the argmin successors (first index on ties).  This is
    the LPR-SC baseline and the default loop-free initialization for GP.
    The float32 constants (1e18 for "unreachable", the 1e-5 per-hop tie
    breaker on top of inf off-graph weights) and the V-round relaxation are
    the reference's, so ties break identically.  A stacked family is
    handled member by member in the same tensor ops.
    """
    Dp0, Cp0 = _zero_flow_weights(inst)                  # (...,V,V), (...,V)
    V, K1 = inst.V, inst.K1
    dev = inst.device
    INF = torch.tensor(1e18, dtype=torch.float32, device=dev)
    at_dst = torch.arange(V, device=dev) == inst.dst[..., None]          # (...,A,V)

    dist_next = INF.expand(at_dst.shape)
    dists = [None] * K1
    for k in range(K1 - 1, -1, -1):
        is_last = (inst.n_tasks == k)[..., None]                           # (...,A,1)
        # absorbing cost: at the last stage, reaching dst ends the chain
        comp = torch.where(is_last, INF,
                           inst.w[..., k, None] * inst.wnode[..., None, :]
                           * Cp0[..., None, :] + dist_next)
        dist = torch.where(is_last & at_dst, 0.0, comp)
        # tiny per-hop epsilon: ties break toward fewer hops, so the argmin
        # successor graph is acyclic even at zero packet size
        wmat = inst.L[..., k, None, None] * Dp0[..., None, :, :] + 1e-5   # (...,A,V,V)
        for _ in range(V):
            via = (wmat + dist[..., None, :]).amin(dim=-1)
            dist = torch.minimum(dist, via)
        dists[k] = dist
        dist_next = dist
    dist = torch.stack(dists, dim=-2)                                      # (...,A,K1,V)

    # successor choice: CPU (cost w*C'0 + dist[k+1,i]) vs each link
    dist_next = torch.cat([dist[..., 1:, :], torch.full_like(dist[..., :1, :], 1e18)],
                          dim=-2)
    cand_c = torch.where(
        inst.cpu_allowed()[..., None],
        inst.w[..., None] * inst.wnode[..., None, None, :] * Cp0[..., None, None, :]
        + dist_next,
        INF,
    )
    cand_e = torch.where(
        inst.adj[..., None, None, :, :],
        inst.L[..., None, None] * Dp0[..., None, None, :, :] + 1e-5
        + dist[..., None, :],
        INF,
    )
    all_cand = torch.cat([cand_c[..., None], cand_e], dim=-1)              # (...,A,K1,V,1+V)
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

# Chunk schedule of solve_batched: start short, so early-converging members
# retire (and the batch compacts) after 8 iterations, then double up to 64
# as the long tail sets in; lengths stay powers of two, as the reference's.
_CHUNK_MIN = 8
_CHUNK_MAX = 64


def _prev_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (n.bit_length() - 1)


def _on_device(inst: Instance, device: Device) -> None:
    dev = resolve_device(device)
    if inst.device.type != dev.type:
        raise ValueError(f"instance is on {inst.device}, solve asked for {dev}")


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
    accel=None,
    app_mask: Optional[torch.Tensor] = None,
    record: bool = False,
    device: Device = "cuda",
) -> GPResult:
    """Run Algorithm 1 until the sufficiency residual falls below tol.

    The loop body never syncs to the host; only the ``done`` latch is read
    back, once every ``_SOLVE_CHUNK`` iterations, so a converged run stops
    early.  ``accel=True`` (or an ``engine.AccelConfig``) runs the
    acceleration layer; ``app_mask`` ((A,) bool) freezes the applications
    where it is False: they keep their rows of ``phi0`` and still load the
    shared flows, and the residual stop ignores them; ``record=True`` keeps
    each step's decisions (``GPResult.records``).  ``inst`` must lie on
    ``device`` (CUDA unless the caller passes ``device="cpu"``).
    """
    _on_device(inst, device)
    accel = engine.resolve_accel(accel)
    phi = phi0 if phi0 is not None else init_phi(inst)
    carry = engine.init_carry(inst, phi, accel)
    cost0 = carry.cost
    alpha_ = torch.tensor(alpha, dtype=torch.float32, device=inst.device)
    cost_chunks, res_chunks, rec_chunks = [], [], []
    steps = 0
    while steps < max_iters:
        carry, cs, rs, *rec = engine.scan_chunk(
            inst, carry, alpha_, tol, patience, max_iters, allowed_e, allowed_c,
            length=min(_SOLVE_CHUNK, max_iters - steps), scaled=scaled, accel=accel,
            app_mask=app_mask, record=record)
        cost_chunks.append(cs)
        res_chunks.append(rs)
        rec_chunks += rec
        steps += len(cs)
        if bool(carry.done):
            break
    empty = cost0.new_zeros((0,))
    return GPResult(
        phi=carry.phi,
        cost_history=torch.cat([cost0[None], *cost_chunks]),
        residual_history=torch.cat(res_chunks) if res_chunks else empty,
        iterations=int(carry.iters),
        records=({k: torch.cat([r[k] for r in rec_chunks]) for k in engine.RECORDS}
                 if record and rec_chunks else None),
    ).trim()


class GPScan(NamedTuple):
    """Dense result of :func:`solve_scan` / :func:`solve_batched`.

    Histories are ``(..., max_iters + 1)`` and ``(..., max_iters)``
    tensors; entries past a member's ``iterations`` repeat its converged
    values.  The leading dims are the members' (none for
    :func:`solve_scan`), in the family's original order.
    """

    phi: Phi
    cost: torch.Tensor              # final cost
    residual: torch.Tensor          # final sufficiency residual
    cost_history: torch.Tensor      # (..., max_iters + 1), [0] = initial cost
    residual_history: torch.Tensor  # (..., max_iters)
    iterations: torch.Tensor        # int64, iterations committed
    records: Optional[dict] = None  # {name: (..., max_iters, ...)} with record=True

    def member(self, b: int) -> GPResult:
        """Member ``b`` of a batched scan, trimmed (phi still padded)."""
        return GPResult(phi=Phi(e=self.phi.e[b], c=self.phi.c[b]),
                        cost_history=self.cost_history[b],
                        residual_history=self.residual_history[b],
                        iterations=int(self.iterations[b]),
                        records=(None if self.records is None else
                                 {k: v[b] for k, v in self.records.items()})).trim()


def solve_scan(
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
    accel=None,
    app_mask: Optional[torch.Tensor] = None,
    device: Device = "cuda",
) -> GPScan:
    """Algorithm 1 as one chunk of ``max_iters`` iterations, no early exit
    and no host read inside: dense histories (:class:`GPScan`).
    ``app_mask`` as in :func:`solve`."""
    _on_device(inst, device)
    accel = engine.resolve_accel(accel)
    phi = phi0 if phi0 is not None else init_phi(inst)
    carry0 = engine.init_carry(inst, phi, accel)
    carry, cs, rs = engine.scan_chunk(
        inst, carry0, torch.tensor(alpha, dtype=torch.float32, device=inst.device),
        tol, patience, max_iters, allowed_e, allowed_c, length=max_iters,
        scaled=scaled, accel=accel, app_mask=app_mask)
    return GPScan(phi=carry.phi, cost=carry.cost, residual=carry.residual,
                  cost_history=torch.cat([carry0.cost[None], cs]),
                  residual_history=rs, iterations=carry.iters)


def _members(x, idx: torch.Tensor):
    """Members ``idx`` of a carry, strategy, mask or stacked instance."""
    if x is None:
        return None
    if isinstance(x, Instance):
        return dataclasses.replace(x, **{f: getattr(x, f).index_select(0, idx)
                                         for f in DENSE_FIELDS})
    if isinstance(x, tuple):
        return type(x)(*(_members(v, idx) for v in x))
    return x.index_select(0, idx)


def solve_batched(
    binst: Instance,
    phi0: Optional[Phi] = None,
    *,
    alpha: float = 0.02,
    max_iters: int = 400,
    tol: float = 1e-4,
    allowed_e: Optional[torch.Tensor] = None,
    allowed_c: Optional[torch.Tensor] = None,
    patience: int = 40,
    scaled: bool = False,
    compact: bool = True,
    accel=None,
    record: bool = False,
    device: Device = "cuda",
) -> GPScan:
    """Solve a stacked family (``batch.pad_instances``, leading member dim
    B) in one member-batched loop: each step is one launch of each kernel
    for every member and ladder rung.

    The host reads the members' ``done`` latches at chunk boundaries; the
    chunks run 8, 16, 32, then 64 iterations (powers of two within the
    remaining budget), and the sweep ends when every member has stopped.
    With ``compact=True`` the members that stopped leave the batch at each
    boundary; the port keeps exactly the active members (the reference
    pads them to a power of two for XLA's compile cache), and a member's
    arithmetic is its own either way.  ``allowed_e``/``allowed_c`` and
    ``phi0`` carry the member dim.  ``record=True`` keeps each step's
    decisions (``engine.RECORDS``) as ``(B, max_iters, ...)`` tensors.

    Returns a :class:`GPScan` with ``phi.e (B, A, K1, V, V)``,
    ``cost``/``residual``/``iterations (B,)``, ``cost_history
    (B, max_iters + 1)`` and ``residual_history (B, max_iters)``, in the
    original member order.
    """
    _on_device(binst, device)
    if len(binst.batch_shape) != 1:
        raise ValueError(f"solve_batched wants one member dim, got {binst.batch_shape}")
    B = binst.batch_shape[0]
    dev = binst.device
    accel = engine.resolve_accel(accel)
    if phi0 is None:
        phi0 = init_phi(binst)
    carry = engine.init_carry(binst, phi0, accel)
    alpha_ = torch.tensor(alpha, dtype=torch.float32, device=dev)

    cost_hist = torch.zeros((B, max_iters + 1), dtype=torch.float32, device=dev)
    cost_hist[:, 0] = carry.cost
    res_hist = torch.zeros((B, max_iters), dtype=torch.float32, device=dev)
    out = engine.SolveCarry(*carry)          # rows of retired members
    written = torch.zeros(B, dtype=torch.int64, device=dev)
    recs = None

    ids = np.arange(B)                       # lane -> original member
    inst_p, ae_p, ac_p = binst, allowed_e, allowed_c
    steps, chunk = 0, _CHUNK_MIN
    while steps < max_iters:
        length = min(chunk, _prev_pow2(max_iters - steps))
        chunk = min(chunk * 2, _CHUNK_MAX)
        carry, cs, rs, *rec = engine.scan_chunk(
            inst_p, carry, alpha_, tol, patience, max_iters, ae_p, ac_p,
            length=length, scaled=scaled, accel=accel, record=record)
        lanes = torch.as_tensor(ids, device=dev)
        cost_hist[lanes, steps + 1: steps + 1 + length] = cs.T
        res_hist[lanes, steps: steps + length] = rs.T
        if rec:
            if recs is None:
                recs = {k: torch.zeros((B, max_iters) + v.shape[2:], dtype=v.dtype,
                                       device=dev) for k, v in rec[0].items()}
            for k, v in rec[0].items():
                recs[k][lanes, steps: steps + length] = v.transpose(0, 1)
        steps += length
        written[lanes] = steps

        done = carry.done.cpu().numpy()
        retiring = done | (steps >= max_iters)
        if retiring.any():
            sel = torch.as_tensor(np.flatnonzero(retiring), device=dev)
            rids = torch.as_tensor(ids[retiring], device=dev)
            out = engine.SolveCarry(*(
                Phi(*(o.index_copy(0, rids, n.index_select(0, sel))
                      for o, n in zip(ov, nv))) if isinstance(ov, Phi)
                else ov.index_copy(0, rids, nv.index_select(0, sel))
                for ov, nv in zip(out, carry)))
        active = np.flatnonzero(~done)
        if len(active) == 0:
            break
        if compact and len(active) < len(ids):
            sel = torch.as_tensor(active, device=dev)
            inst_p, carry, ae_p, ac_p = (_members(x, sel)
                                         for x in (inst_p, carry, ae_p, ac_p))
            ids = ids[active]

    # dense histories: repeat each member's values past its last chunk
    t = torch.arange(max_iters + 1, device=dev)
    cost_hist = cost_hist.gather(1, torch.minimum(t, written[:, None]))
    res_hist = res_hist.gather(
        1, torch.minimum(t[:-1], (written - 1).clamp_min(0)[:, None]))
    return GPScan(phi=out.phi, cost=out.cost, residual=out.residual,
                  cost_history=cost_hist, residual_history=res_hist,
                  iterations=out.iters, records=recs)


def solve_loop(
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
    """The per-iteration host loop: one ``engine.gp_step`` a step, its
    residual and cost read back to test the stop after every step.

    The differential check of :func:`solve`: the same steps and the same
    float32 stop test (residual at most ``tol``, or no improvement by
    1e-6 relative in ``patience`` steps), so the same histories, count and
    strategy, bit for bit.
    """
    _on_device(inst, device)
    phi = phi0 if phi0 is not None else init_phi(inst)
    cost0 = engine.total_cost(inst, phi).to(torch.float32)
    alpha_ = torch.tensor(alpha, dtype=torch.float32, device=inst.device)
    best, stall = cost0, 0
    costs, residuals = [cost0], []
    it = 0
    for it in range(1, max_iters + 1):
        state = engine.gp_step(inst, phi, alpha_, allowed_e, allowed_c, scaled)
        phi = state.phi
        costs.append(state.cost)
        residuals.append(state.residual)
        if bool(state.residual <= tol):
            break
        if bool(state.cost < best * (1 - 1e-6)):
            best, stall = state.cost, 0
        else:
            stall += 1
            if stall >= patience:
                break      # ladder-stationary: no stepsize makes progress
    return GPResult(phi=phi, cost_history=torch.stack(costs),
                    residual_history=(torch.stack(residuals) if residuals
                                      else cost0.new_zeros((0,))),
                    iterations=it)
