"""OnlineSolver: the GP solver as a long-running service.

Port of ``repro.serve.online``.  The paper's Section IV closes by noting
that the distributed algorithm "adapts to changes in input rates and
network topology, and can be implemented as an online algorithm".  This
module is that claim as a service: it holds the live forwarding/offloading
strategy of a fleet of problem instances on the device and re-converges
incrementally as typed events (``core/events.py``) stream in.

  * **Fleet state.**  Members are padded to one envelope
    (``events.pad_fleet``) and stacked into one instance with the member
    dim in front; the live solver state is one member-batched
    ``engine.SolveCarry`` whose ``phi`` is the fleet's current strategy.
  * **Event ingestion.**  ``events.apply_event`` rewrites the member out of
    place (no shape changes); the stacked instance gets a copy of the new
    row.
  * **Warm start and repair.**  Re-convergence starts from the live
    strategy; after a topology event ``traffic.repair_phi`` masks dead
    directions and reseeds emptied rows first.
  * **Skip gates.**  Members an event did not touch never run.  Within the
    touched member, ``conditions.per_app_residual`` is the gate: only
    applications whose data changed, whose strategy carried mass on a
    failed link, or whose sufficiency residual exceeds ``gate_tol`` are
    solved (``app_mask``); the others are frozen (their flows still load
    the shared F/G).  After convergence the gate re-checks every
    application and unfreezes those that drifted, for up to
    ``max_unfreeze_rounds`` rounds.
  * **Acceleration carry.**  Across a small rate change (a factor in
    ``events.SMALL_RATE_WINDOW``) the Anderson window and the adaptive
    stepsize survive the event (``engine.reset_carry(keep_window=True)``);
    topology and application churn clear them.

Fault tolerance: the service never serves a strategy worse than its last
known good one.

  * **Last-known-good checkpoints.**  Each member keeps an incumbent (phi,
    cost, residual, certificate), repaired with the live strategy on
    topology events and re-costed under the current instance on every
    event.
  * **Escalation ladder.**  A re-convergence that ends non-finite, worse
    than the incumbent, or at its whole budget without a certificate
    climbs: ``warm`` (window kept), ``warm-clear``, ``cold`` and
    ``baseline:<SPOC|LCOF>`` (``baselines.fallback_strategy``), each on a
    backoff budget.  The best finite candidate is served if it honours the
    incumbent, else the incumbent is (a rollback).
  * **Runtime invariants.**  ``verify_fleet`` measures simplex rows, stray
    mass and capacity slack per member; with ``debug=True`` it runs after
    every event and a corrupt member is quarantined onto the baseline-mask
    strategy.
  * **Fault injection.**  ``fault_injector`` (a ``faults.FaultInjector``)
    corrupts the member's carry before each event.

The fleet's cold start runs member-batched, in a power-of-two bucket; every
event runs its one member without a member dim, through
``engine.scan_chunk``: ``gp.solve``'s arithmetic.  Every solve runs on the
instances' route (``traffic.resolve_solver``; the dense route's
``lu_factor``, ``chain_solve`` and ``tagged`` kernels on the card for the
Table II fleets).

``metrics`` and ``tracer`` are duck-typed hooks (``counter(name, n)`` /
``observe(name, value)``; ``span(name, tid=, **args)`` as a context manager
/ ``instant(name, tid=, **args)``; ``repro_torch.obs.Metrics`` and
``Tracer``), called with the reference's names.  ``telemetry=`` turns on
the on-device iteration ring (``engine.resolve_telemetry``): each solve
segment's rows are drained into ``iter_trace`` at the chunk boundary where
the service reads its latches anyway, before any ``reset_carry`` zeroes
them.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (baselines, batch, conditions, engine, events, gp,
                              traffic)
from repro_torch.core.network import DENSE_FIELDS, Device, Instance, resolve_device
from repro_torch.obs.device import records_to_dicts, ring_overflow, ring_valid
from repro_torch.core.traffic import Phi

# Corrupt-class invariant thresholds: the GP projection and repair_phi keep
# simplex rows normalized to float32 roundoff (~1e-6) and place exactly
# zero mass on dead directions, so anything past these is state
# corruption, not numerical drift.
FEAS_TOL = 1e-3
MASS_TOL = 1e-4


@dataclasses.dataclass(frozen=True)
class EventReport:
    """What one event cost the service.

    ``iterations`` counts GP iterations committed for this event (0 when
    every live app passed the skip gate); ``solved_apps`` / ``skipped_apps``
    split the member's live applications into gate-opened and gate-frozen;
    ``unfroze`` counts apps the post-convergence re-check promoted from
    frozen to solved; ``repaired`` / ``kept_window`` record the repair and
    Anderson-carry decisions; ``converged`` is the convergence certificate
    (residual within tol, or the phi fixed-point latch): False means the
    served strategy is best-effort (budget cap, stall).
    """

    event: events.Event
    member: int
    iterations: int
    cost: float
    residual: float
    solved_apps: int
    skipped_apps: int
    unfroze: int
    repaired: bool
    kept_window: bool
    cold_restart: bool = False
    converged: bool = True


@dataclasses.dataclass(frozen=True)
class HealthReport(EventReport):
    """EventReport plus the guardrail verdict.

    ``status`` is the outcome:

      * ``converged``   — GP result served, residual certificate holds
      * ``capped``      — GP result served best-effort (budget exhausted or
                          stalled above ``gate_tol``), finite and no worse
                          than the incumbent
      * ``degraded``    — a baseline-mask (SPOC/LCOF) strategy is served
                          (ladder floor or quarantine)
      * ``rolled_back`` — the last-known-good incumbent is served because
                          every fresh candidate was worse
      * ``rejected``    — nothing finite exists, not even the incumbent

    ``rungs`` lists the ladder rungs climbed (empty on the healthy path) and
    ``rung_iters`` each rung's iterations; ``incumbent_cost`` is the
    last-known-good cost re-costed under the post-event instance, the bound
    served costs are held to; ``wall_s`` is the event's host wall time.
    """

    status: str = "converged"
    rungs: tuple = ()
    incumbent_cost: float = float("nan")
    rolled_back: bool = False
    quarantined: bool = False
    injected: Optional[str] = None
    shed: tuple = ()
    rung_iters: tuple = ()
    wall_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class FleetHealth:
    """One member's runtime invariant measurements (``verify_fleet``)."""

    member: int
    simplex: float          # max |strategy row sum - expected|
    dead_link_mass: float   # max phi.e mass on absent links
    dead_app_mass: float    # max mass on dead/padded app rows
    cpu_mass: float         # max phi.c where offloading is disallowed
    nonfinite: bool         # any non-finite phi entry
    cost: float             # the cost being served
    capacity_slack: float   # min over links of theta*cap - F (inf: LINEAR)

    @property
    def corrupt(self) -> bool:
        """Invariant violation (state corruption): quarantine-worthy."""
        return bool(self.nonfinite or not np.isfinite(self.cost)
                    or self.simplex > FEAS_TOL
                    or self.dead_link_mass > MASS_TOL
                    or self.dead_app_mass > MASS_TOL
                    or self.cpu_mass > MASS_TOL)

    @property
    def saturated(self) -> bool:
        """Load past the modelled M/M/1 region: reported, not corrupt (the
        quadratic cost extension keeps it finite and recoverable)."""
        return bool(self.capacity_slack < 0)


def _take(x, b: int):
    """Member ``b`` of a batched carry or strategy (views, never written)."""
    if isinstance(x, tuple):
        return type(x)(*(_take(v, b) for v in x))
    return x[b]


def _lead(x):
    """``x`` (a member's carry or strategy) with a leading member dim of 1."""
    if isinstance(x, tuple):
        return type(x)(*(_lead(v) for v in x))
    return x[None]


def _put(full, idx: torch.Tensor, part):
    """``full`` with rows ``idx`` replaced by ``part`` (leading dim), out of
    place: tensors handed out earlier (a strategy, a checkpoint) keep their
    values."""
    if isinstance(full, tuple):
        return type(full)(*(_put(f, idx, p) for f, p in zip(full, part)))
    return full.index_copy(0, idx, part.to(full.dtype))


class OnlineSolver:
    """Device-resident online GP service over a fleet of instances.

    Parameters mirror ``gp.solve`` (alpha / tol / patience / max_iters /
    accel apply to every re-convergence).  The reference's ``solver=`` and
    ``blocked=`` are left out: the port's route follows the instance
    (``traffic.resolve_solver``) and its blocked sets are one kernel launch.
    ``spare_apps`` reserves dead application slots per member for
    ``events.AppArrival``; ``gate_tol`` (default ``tol``) is the per-app
    residual threshold of the skip gate; ``carry_window=False`` disables the
    Anderson-window carry across small rate changes.

    Fault tolerance: ``rollback_margin`` is the relative slack a served cost
    may exceed the incumbent by before the watchdog escalates;
    ``debug=True`` runs ``verify_member`` after every event and quarantines
    a corrupt member; ``fault_injector`` corrupts the member's carry before
    each event.  ``telemetry`` turns on the iteration ring, drained into
    ``iter_trace`` (one dict a committed iteration, tagged with the member,
    the event index, -1 for the cold start, the phase and a segment id);
    ``metrics`` and ``tracer`` are duck-typed hooks (module docstring).

    The instances must lie on ``device`` (CUDA unless the caller passes
    ``device="cpu"``).  Construction cold-solves the fleet member-batched;
    each member's cold iteration count is kept in ``cold_iters``.
    ``process`` ingests one event, ``step`` a list.
    """

    def __init__(
        self,
        insts: Sequence[Instance],
        *,
        spare_apps: int = 0,
        alpha: float = 0.02,
        tol: float = 1e-4,
        gate_tol: Optional[float] = None,
        max_iters: int = 400,
        patience: int = 40,
        accel=True,
        carry_window: bool = True,
        max_unfreeze_rounds: int = 4,
        plateau_res: Optional[float] = None,
        rollback_margin: float = 1e-4,
        debug: bool = False,
        fault_injector=None,
        telemetry=None,
        metrics=None,
        tracer=None,
        device: Device = "cuda",
    ):
        dev = resolve_device(device)
        for inst in insts:
            if inst.device.type != dev.type:
                raise ValueError(f"instance is on {inst.device}, the service asked for {dev}")
        self.device = dev
        self._members = events.pad_fleet(insts, spare_apps=spare_apps)
        self.binst: Instance = dataclasses.replace(self._members[0], **{
            f: torch.stack([getattr(m, f) for m in self._members]) for f in DENSE_FIELDS})
        self.B = len(self._members)
        self.tol = float(tol)
        self.gate_tol = float(tol if gate_tol is None else gate_tol)
        self.max_iters = int(max_iters)
        self.patience = int(patience)
        self.carry_window = bool(carry_window)
        self.max_unfreeze_rounds = int(max_unfreeze_rounds)
        # Warm-start plateau detector (see _chunk_schedule): a repaired
        # strategy can itself be a spurious near-fixed point of the GP map
        # (tiny residual, then hundreds of iterations of micro-improvements;
        # healthy warm starts begin near 1e-1 and drop fast).  If after the
        # first chunk the member is not done and its residual is already
        # below this, restarting cold is faster and lands on the cold
        # baseline's optimum.
        self.plateau_res = float(20 * tol if plateau_res is None else plateau_res)
        self.rollback_margin = float(rollback_margin)
        self.debug = bool(debug)
        self.fault_injector = fault_injector
        self.metrics = metrics
        self.tracer = tracer
        self._telemetry = engine.resolve_telemetry(telemetry)
        self.iter_trace: list[dict] = []
        self._segments = 0                 # drained solve segments
        self._accel = engine.resolve_accel(accel)
        self._alpha = torch.tensor(alpha, dtype=torch.float32, device=dev)

        self.carry: engine.SolveCarry = engine.init_carry(
            self.binst, gp.init_phi(self.binst), self._accel, self._telemetry)
        self.total_iters = 0                       # all committed iterations
        self.reports: list[HealthReport] = []
        self.ladder_hits: dict[str, int] = {}      # escalation-rung counters
        self.quarantines = 0
        self.cold_iters, _ = self._converge(list(range(self.B)), phase="cold-start")
        self.event_iters = 0                       # iterations after cold start
        # Last-known-good checkpoints: the cold solve is the first one.
        self._lkg_phi: list[Phi] = [self.phi(b) for b in range(self.B)]
        self._lkg_cost: list[float] = [float(c) for c in self.costs()]
        self._lkg_residual: list[float] = [float(r) for r in self.residuals()]
        self._lkg_cert: list[bool] = [self._certificate(b) for b in range(self.B)]

    # -- fleet state accessors ------------------------------------------

    def member(self, b: int) -> Instance:
        """Member ``b``'s current (padded) problem instance."""
        return self._members[b]

    def phi(self, b: int) -> Phi:
        """Member ``b``'s live strategy (padded to the fleet envelope)."""
        return _take(self.carry.phi, b)

    def costs(self) -> np.ndarray:
        """(B,) current aggregate delay of every fleet member."""
        return self.carry.cost.cpu().numpy()

    def residuals(self) -> np.ndarray:
        """(B,) per-member sufficiency residual of the live strategies."""
        out = np.zeros(self.B, np.float32)
        for b in range(self.B):
            out[b] = self._residual(self._members[b], self.phi(b)).max(initial=0.0)
        return out

    def incumbent(self, b: int) -> tuple[Phi, float]:
        """Member ``b``'s last-known-good (phi, cost) checkpoint."""
        return self._lkg_phi[b], self._lkg_cost[b]

    # -- runtime invariants ---------------------------------------------

    def verify_member(self, b: int) -> FleetHealth:
        """Measure member ``b``'s strategy against the runtime invariants."""
        inst_b = self._members[b]
        phi_b = self.phi(b)
        sv = traffic.strategy_violations(inst_b, phi_b)
        if bool(sv.nonfinite):
            slack = float("nan")       # flows of a NaN strategy are noise
        else:
            slack = float(traffic.capacity_slack(inst_b, traffic.flows(inst_b, phi_b).F))
        return FleetHealth(
            member=b,
            simplex=float(sv.simplex),
            dead_link_mass=float(sv.dead_link_mass),
            dead_app_mass=float(sv.dead_app_mass),
            cpu_mass=float(sv.cpu_mass),
            nonfinite=bool(sv.nonfinite),
            cost=float(self.carry.cost[b]),
            capacity_slack=slack,
        )

    def verify_fleet(self, members: Optional[Sequence[int]] = None) -> list[FleetHealth]:
        """The runtime invariant checker over the fleet (or the given
        members): simplex rows, stray mass on dead links, apps and CPUs,
        finiteness and capacity slack.  Pure measurement: quarantining is
        the caller's (or ``debug`` mode's) decision via
        :attr:`FleetHealth.corrupt`."""
        return [self.verify_member(b)
                for b in (range(self.B) if members is None else members)]

    # -- event ingestion ------------------------------------------------

    def process(self, ev: events.Event) -> HealthReport:
        """Ingest one event and re-converge its member incrementally."""
        t0 = time.perf_counter()
        with self._span(f"event:{type(ev).__name__}", tid=ev.member,
                        member=ev.member, index=len(self.reports)):
            rep = self._process(ev, t0)
        if self.metrics is not None:
            self.metrics.counter(f"online.event.{type(ev).__name__}")
            self.metrics.observe("online.event.iters", rep.iterations)
            self.metrics.observe("online.event.wall_s", rep.wall_s)
            if rep.rolled_back:
                self.metrics.counter("online.rollback")
            if rep.shed:
                self.metrics.counter("online.shed", len(rep.shed))
        return rep

    def _process(self, ev: events.Event, t0: float) -> HealthReport:
        b = ev.member
        injected = None
        if self.fault_injector is not None:
            carry_b, injected = self.fault_injector.maybe_corrupt(
                _take(self.carry, b), b, len(self.reports))
            if injected is not None:
                self._scatter_carry(b, carry_b)

        inst_b, eff = events.apply_event(self._members[b], ev)
        self._members[b] = inst_b
        idx = self._index([b])
        self.binst = dataclasses.replace(self.binst, **{
            f: _put(getattr(self.binst, f), idx, _lead(getattr(inst_b, f)))
            for f in DENSE_FIELDS})
        seed_phi = gp.init_phi(inst_b)

        phi_b = self.phi(b)
        touched = np.array(eff.touched, dtype=bool)
        repaired = False
        if eff.topology:
            # apps that routed over a now-dead link must re-solve even if
            # repair leaves their residual small (their mass was moved)
            for i, j in eff.dead_links:
                touched |= phi_b.e[:, :, i, j].sum(dim=1).cpu().numpy() > 1e-6
            phi_b = traffic.repair_phi(inst_b, phi_b, seed_phi)
            repaired = True

        # Last-known-good maintenance: repair the incumbent alongside the
        # live strategy and re-cost it under the post-event instance, so the
        # rollback bound is always measured on the current problem.
        lkg_phi = self._lkg_phi[b]
        if eff.topology:
            lkg_phi = traffic.repair_phi(inst_b, lkg_phi, seed_phi)
            self._lkg_phi[b] = lkg_phi
        incumbent = float(traffic.total_cost(inst_b, lkg_phi))
        self._lkg_cost[b] = incumbent

        live = inst_b.stage_mask.any(dim=1).cpu().numpy()
        res = self._residual(inst_b, phi_b)
        # a non-finite residual means the (repaired) strategy drives some
        # link past capacity: nothing about that app is provably stationary
        active = (touched | ~np.isfinite(res) | (res > self.gate_tol)) & live
        keep = (self.carry_window and eff.small and not eff.topology)

        carry_b = engine.reset_carry(inst_b, phi_b, _take(self.carry, b), keep_window=keep)
        cost_now = float(carry_b.cost)
        if not np.isfinite(cost_now):
            active = live.copy()       # over-capacity strategy: solve everyone
        elif np.isfinite(incumbent) and cost_now > incumbent * (1 + self.rollback_margin):
            # serving as-is would break the LKG guarantee: open the gate
            active = live.copy()
        if not active.any():
            # every live app is provably stationary at the new instance:
            # commit the bookkeeping (cost under the new rates), skip the solve
            carry_b = carry_b._replace(
                done=torch.ones_like(carry_b.done),
                residual=torch.full_like(carry_b.residual, res.max(initial=0.0)))
            self._scatter_carry(b, carry_b)
            self._count("online.gate.skip")
            self._instant("gate-skip", tid=b, member=b)
            return self._finish(
                ev, b, inst_b, incumbent, iters=0, solved=0,
                skipped=int(live.sum()), unfroze=0, repaired=repaired,
                keep=keep, cold_restart=False, rungs=(), served="gp",
                converged=True, injected=injected, shed=eff.shed,
                rung_iters=(), t0=t0)

        self._scatter_carry(b, carry_b)
        am = active
        iters_total = 0
        unfroze = 0
        cold_restart = False

        if isinstance(ev, (events.AppArrival, events.LinkUp)):
            # Expansion policy: restart cold, no warm round.  Arrivals and
            # restored links expand the strategy space: the incumbent is
            # stationary for the smaller problem and carries zero mass in
            # the new directions, which the GP map enters one alpha-limited
            # step at a time while gp.init_phi simply redistributes.
            plateaued = True
        else:
            # warm round with the plateau probe
            it, plateaued = self._converge([b], app_mask=am[None, :],
                                           plateau_res=self.plateau_res, phase="warm")
            iters_total += int(it[0])
            if not np.isfinite(float(self.carry.cost[b])):
                # the repaired strategy exceeded some link capacity and the
                # GP map cannot descend from an infinite cost: a cold restart
                # from gp.init_phi (the cold baseline) is the sound recovery
                plateaued = True
            elif eff.topology and int(it[0]) <= gp._CHUNK_MIN:
                # a repaired strategy that latches done within the first
                # chunk is suspect (mass was force-moved off dead links, yet
                # the certificate fired at once): a near-fixed point a hair
                # above the optimum.  Restart cold.
                plateaued = True
        if plateaued:
            cold_restart = True
            self._count("online.cold_restart")
            self._reset_member(b, seed_phi, keep_window=False)
            am = live.copy()          # a cold start moves every live app
            it, _ = self._converge([b], app_mask=am[None, :], phase="cold")
            iters_total += int(it[0])

        res = self._residual(inst_b, self.phi(b))
        for _round in range(self.max_unfreeze_rounds):
            drifted = live & ~am & (~np.isfinite(res) | (res > self.gate_tol))
            if not drifted.any():
                break
            # congestion moved under gate-frozen apps: unfreeze and go again
            unfroze += int(drifted.sum())
            self._count("online.unfreeze", int(drifted.sum()))
            am = am | drifted
            self._reset_member(b, self.phi(b), keep_window=True)
            it, _ = self._converge([b], app_mask=am[None, :], phase="unfreeze")
            iters_total += int(it[0])
            res = self._residual(inst_b, self.phi(b))

        # -- watchdog: escalate on non-finite / worse-than-incumbent / true
        # -- budget exhaustion
        served = "gp"
        rungs: tuple = ()
        rung_iters: tuple = ()
        served_cost = float(self.carry.cost[b])
        converged = self._certificate(b)
        if self._needs_escalation(b, served_cost, incumbent):
            extra, rungs, rung_iters, served, converged = self._escalate(
                b, inst_b, seed_phi, live, incumbent, already_cold=cold_restart)
            iters_total += extra

        self.event_iters += iters_total
        return self._finish(
            ev, b, inst_b, incumbent, iters=iters_total,
            solved=int(am.sum()), skipped=int((live & ~am).sum()),
            unfroze=unfroze, repaired=repaired, keep=keep,
            cold_restart=cold_restart, rungs=rungs, served=served,
            converged=converged, injected=injected, shed=eff.shed,
            rung_iters=rung_iters, t0=t0)

    def step(self, evs: Sequence[events.Event]) -> list[HealthReport]:
        """Ingest a list of events in order (the trace-replay entry point)."""
        return [self.process(ev) for ev in evs]

    # -- guardrails -----------------------------------------------------

    def _certificate(self, b: int) -> bool:
        """True iff member ``b``'s last solve stopped with a convergence
        certificate.  The done latch fires for four reasons: committed
        residual <= tol, the phi fixed-point freeze, stall patience, or the
        budget.  The first two are certificates (the committed residual is
        measured from pre-step marginals, so a fixed-point latch may carry a
        residual a hair above tol); stall and budget stops are best-effort."""
        if not bool(self.carry.done[b]):
            return False
        res = float(self.carry.residual[b])
        if np.isfinite(res) and res <= self.tol:
            return True
        return (int(self.carry.stall[b]) < self.patience
                and int(self.carry.iters[b]) < self.max_iters)

    def _needs_escalation(self, b: int, cost: float, incumbent: float) -> bool:
        if not np.isfinite(cost):
            return True
        if np.isfinite(incumbent) and cost > incumbent * (1 + self.rollback_margin):
            return True
        # true budget exhaustion: the last re-convergence burned the whole
        # budget and left no certificate (a stall stop below max_iters is a
        # plateau, which the plateau probe already handled)
        capped = int(self.carry.iters[b]) >= self.max_iters
        return capped and not self._certificate(b)

    def _escalate(self, b: int, inst_b: Instance, seed_phi: Phi, live: np.ndarray,
                  incumbent: float, *, already_cold: bool
                  ) -> tuple[int, tuple, tuple, str, bool]:
        """Climb the degradation ladder; returns (iterations, rungs,
        rung_iters, served, converged).

        Rungs, each on a backoff budget: ``warm`` (from the live strategy,
        window kept), ``warm-clear`` (window zeroed), ``cold``
        (``gp.init_phi``, whole budget; skipped when the event already
        restarted cold), ``baseline:<SPOC|LCOF>`` (the mask-restricted solve
        from ``baselines.fallback_strategy``, always feasible).  The best
        finite candidate wins iff it honours the incumbent, else the
        incumbent is rolled back in; ``served`` is "gp" / "baseline" /
        "incumbent" / "none".
        """
        extra = 0
        rungs: list[str] = []
        rung_iters: list[int] = []
        am = live[None, :]
        margin = 1 + self.rollback_margin

        def measure(tag: str, is_baseline: bool = False) -> dict:
            # the candidate carries its committed residual and whether its
            # stop was a certificate, so serving it re-installs its verdict
            return dict(rung=tag, phi=self.phi(b), cost=float(self.carry.cost[b]),
                        cert=float(self.carry.residual[b]),
                        cert_ok=self._certificate(b), baseline=is_baseline)

        def run(rung: str, phi0: Phi, keep_w: bool, budget: int, allowed=None,
                is_baseline: bool = False) -> dict:
            nonlocal extra
            self.ladder_hits[rung] = self.ladder_hits.get(rung, 0) + 1
            self._count(f"online.rung.{rung}")
            rungs.append(rung)
            self._reset_member(b, phi0, keep_window=keep_w)
            it, _ = self._converge([b], app_mask=am, max_iters=budget, allowed=allowed,
                                   phase=f"rung:{rung}")
            extra += int(it[0])
            rung_iters.append(int(it[0]))
            c = measure(rung, is_baseline)
            cands.append(c)
            return c

        def acceptable(c: dict) -> bool:
            return (np.isfinite(c["cost"]) and c["cert_ok"]
                    and (not np.isfinite(incumbent) or c["cost"] <= incumbent * margin))

        cands = [measure("event")]
        half = max(1, self.max_iters // 2)
        done = False
        if np.isfinite(cands[0]["cost"]):
            # warm rungs only make sense from a finite live strategy; a
            # NaN-poisoned phi jumps straight to the cold rung
            done = acceptable(run("warm", self.phi(b), True, half))
            if not done:
                done = acceptable(run("warm-clear", self.phi(b), False, half))
        if not done and not already_cold:
            done = acceptable(run("cold", seed_phi, False, self.max_iters))
        if not done:
            fb = baselines.fallback_strategy(inst_b)
            if fb is not None:
                name, allowed_e, allowed_c, phi0, _ = fb
                run(f"baseline:{name}", phi0, False, max(1, self.max_iters // 4),
                    allowed=(allowed_e, allowed_c), is_baseline=True)

        served, converged = self._serve_best(b, inst_b, cands, incumbent)
        return extra, tuple(rungs), tuple(rung_iters), served, converged

    def _serve_best(self, b: int, inst_b: Instance, cands: list[dict],
                    incumbent: float) -> tuple[str, bool]:
        """Commit the winning candidate (or the incumbent) to the carry;
        returns (served, converged)."""
        margin = 1 + self.rollback_margin
        finite = [c for c in cands if np.isfinite(c["cost"])]
        best = min(finite, key=lambda c: c["cost"]) if finite else None
        if best is not None and (not np.isfinite(incumbent)
                                 or best["cost"] <= incumbent * margin):
            self._commit_phi(b, inst_b, best["phi"], best["cert"])
            return ("baseline" if best["baseline"] else "gp"), bool(best["cert_ok"])
        if np.isfinite(incumbent):
            self._commit_phi(b, inst_b, self._lkg_phi[b], self._lkg_residual[b])
            return "incumbent", self._lkg_cert[b]
        if best is not None:
            # the incumbent is not even finite: serve the best-effort candidate
            self._commit_phi(b, inst_b, best["phi"], best["cert"])
            return ("baseline" if best["baseline"] else "gp"), bool(best["cert_ok"])
        # nothing finite anywhere: park on the (repaired) incumbent
        self._commit_phi(b, inst_b, self._lkg_phi[b], float("inf"))
        return "none", False

    def _quarantine(self, b: int, inst_b: Instance) -> int:
        """Replace a corrupt member's strategy with the baseline-mask
        fallback (a short restricted solve); returns the iterations spent."""
        fb = baselines.fallback_strategy(inst_b)
        if fb is None:
            # unservable instance: park on the repaired incumbent
            self._commit_phi(b, inst_b, self._lkg_phi[b], float("inf"))
            return 0
        name, allowed_e, allowed_c, phi0, _ = fb
        key = f"quarantine:{name}"
        self.ladder_hits[key] = self.ladder_hits.get(key, 0) + 1
        self._count("online.quarantine")
        live = inst_b.stage_mask.any(dim=1).cpu().numpy()
        self._reset_member(b, phi0, keep_window=False)
        it, _ = self._converge([b], app_mask=live[None, :],
                               max_iters=max(1, self.max_iters // 4),
                               allowed=(allowed_e, allowed_c), phase="quarantine")
        return int(it[0])

    def _finish(self, ev, b: int, inst_b: Instance, incumbent: float, *,
                iters: int, solved: int, skipped: int, unfroze: int,
                repaired: bool, keep: bool, cold_restart: bool,
                rungs: tuple, served: str, converged: bool,
                injected: Optional[str], shed: tuple,
                rung_iters: tuple = (), t0: float = 0.0) -> HealthReport:
        """Verdict, LKG update and (debug) invariant check: one report."""
        quarantined = False
        if self.debug and served != "none":
            health = self.verify_member(b)
            if health.corrupt:
                quarantined = True
                self.quarantines += 1
                iters += self._quarantine(b, inst_b)
                served = "baseline"
                converged = self._certificate(b)

        served_cost = float(self.carry.cost[b])
        res_max = float(self._residual(inst_b, self.phi(b)).max(initial=0.0))
        converged = bool(converged and np.isfinite(served_cost))
        status = ("rolled_back" if served == "incumbent" else
                  "rejected" if served == "none" else
                  "degraded" if served == "baseline" else
                  "converged" if converged else "capped")

        # the LKG advances on any finite serve that honours the incumbent
        # bound; a rollback re-affirms the incumbent (no-op by value)
        if np.isfinite(served_cost) and (
                not np.isfinite(incumbent)
                or served_cost <= incumbent * (1 + self.rollback_margin)):
            self._lkg_phi[b] = self.phi(b)
            self._lkg_cost[b] = served_cost
            self._lkg_residual[b] = res_max
            self._lkg_cert[b] = converged

        rep = HealthReport(
            event=ev, member=b, iterations=iters, cost=served_cost,
            residual=res_max, solved_apps=solved, skipped_apps=skipped,
            unfroze=unfroze, repaired=repaired, kept_window=keep,
            cold_restart=cold_restart, converged=converged, status=status,
            rungs=tuple(rungs), incumbent_cost=incumbent,
            rolled_back=(served == "incumbent"), quarantined=quarantined,
            injected=injected, shed=tuple(shed), rung_iters=tuple(rung_iters),
            wall_s=(time.perf_counter() - t0) if t0 else 0.0)
        self.reports.append(rep)
        return rep

    # -- observability hooks --------------------------------------------

    def _span(self, name: str, *, tid: int = 0, **args):
        """Nested tracer span, or a no-op when no tracer is attached."""
        if self.tracer is None:
            return nullcontext()
        return self.tracer.span(name, tid=tid, **args)

    def _instant(self, name: str, *, tid: int = 0, **args) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, tid=tid, **args)

    def _count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name, n)

    def _drain_ring(self, b: int, tb, iters: int, phase: str) -> None:
        """Move one solve segment's ring rows into ``iter_trace``.

        Called at the end of every convergence, where the service reads the
        latches back anyway, before any ``reset_carry`` zeroes the ring.
        Each record is tagged with the member, the index of the event being
        processed (-1 during the cold start), the phase and a segment id.
        """
        if self._telemetry is None:
            return
        n = int(iters)
        rows = ring_valid(tb, n)
        dropped = ring_overflow(tb, n)
        if dropped and self.metrics is not None:
            self.metrics.counter("telemetry.ring.dropped", dropped)
        ev_idx = -1 if phase == "cold-start" else len(self.reports)
        seg = self._segments
        self._segments += 1
        for rec in records_to_dicts(rows):
            rec.update(member=b, event=ev_idx, phase=phase, segment=seg)
            self.iter_trace.append(rec)

    # -- internals ------------------------------------------------------

    def _index(self, members: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(members), dtype=torch.int64, device=self.device)

    def _residual(self, inst: Instance, phi: Phi) -> np.ndarray:
        """(A,) float32 per-app sufficiency residual, on the host."""
        return conditions.per_app_residual(inst, phi).cpu().numpy()

    def _scatter_carry(self, b: int, carry_b: engine.SolveCarry) -> None:
        self.carry = _put(self.carry, self._index([b]), _lead(carry_b))

    def _reset_member(self, b: int, phi: Phi, *, keep_window: bool) -> None:
        self._scatter_carry(b, engine.reset_carry(self._members[b], phi,
                                                  _take(self.carry, b),
                                                  keep_window=keep_window))

    def _commit_phi(self, b: int, inst_b: Instance, phi: Phi, res_max: float) -> None:
        """Install ``phi`` as member ``b``'s served strategy (done-latched)."""
        carry_b = engine.reset_carry(inst_b, phi, _take(self.carry, b), keep_window=False)
        # stall=patience marks the commit as certificate-free: the phi was
        # installed, not converged to, so _certificate accepts it only when
        # the recorded residual itself is within tol
        carry_b = carry_b._replace(
            done=torch.ones_like(carry_b.done),
            residual=torch.full_like(carry_b.residual, res_max),
            stall=torch.full_like(carry_b.stall, self.patience))
        self._scatter_carry(b, carry_b)

    def _chunk_schedule(self, advance: Callable[[int], tuple[bool, float]], *,
                        plateau_res: Optional[float] = None,
                        max_iters: Optional[int] = None) -> bool:
        """The power-of-two chunk ladder of every re-convergence.

        ``advance(length)`` runs one chunk and returns ``(all_done,
        probe_residual)``, the probe being the smallest residual among the
        still-running lanes (inf when meaningless).  Chunk lengths double
        from ``gp._CHUNK_MIN`` to ``gp._CHUNK_MAX`` as in
        ``gp.solve_batched``; ``max_iters`` overrides the budget (the
        ladder's per-rung backoff).

        With ``plateau_res`` set, the first chunk arms a suspect latch when
        a running lane's residual is already below it (a spurious near-fixed
        point); if the done latch has not fired one chunk later, the run is
        declared plateaued and the caller restarts cold.  Returns that flag.
        """
        budget = self.max_iters if max_iters is None else int(max_iters)
        steps, chunk = 0, gp._CHUNK_MIN
        suspect = False
        while steps < budget:
            length = min(chunk, gp._prev_pow2(budget - steps))
            chunk = min(chunk * 2, gp._CHUNK_MAX)
            done, probe = advance(length)
            steps += length
            if done:
                break
            if suspect:
                # the grace chunk expired without the done latch: a crawl,
                # not a fixed point about to latch
                return True
            if plateau_res is not None:
                suspect = probe <= plateau_res
                plateau_res = None     # probe only the first chunk
        return False

    def _converge(self, members: Sequence[int], app_mask: Optional[np.ndarray] = None,
                  plateau_res: Optional[float] = None, max_iters: Optional[int] = None,
                  allowed=None, phase: str = "solve") -> tuple[np.ndarray, bool]:
        """Run the given members to convergence; returns (per-member
        committed iteration counts, plateau flag).

        A single member (every event: events touch one member) runs without
        a member dim (:meth:`_converge_one`, ``gp.solve``'s arithmetic).
        Several (the fleet's cold start) run member-batched in a
        power-of-two bucket whose pad lanes duplicate the first member and
        start ``done``.
        """
        if len(members) == 1:
            return self._converge_one(members[0], app_mask, plateau_res,
                                      max_iters=max_iters, allowed=allowed, phase=phase)
        assert allowed is None, "direction masks are single-member only"
        n = len(members)
        bucket = batch.next_pow2(n)
        sel = self._index(list(members) + [members[0]] * (bucket - n))
        inst_s = gp._members(self.binst, sel)
        carry_s = gp._members(self.carry, sel)
        if bucket > n:
            pad = torch.arange(bucket, device=self.device) >= n
            carry_s = carry_s._replace(done=carry_s.done | pad)
        am = None
        if app_mask is not None:
            am_np = np.asarray(app_mask, dtype=bool)
            am = torch.as_tensor(np.concatenate(
                [am_np, np.repeat(am_np[:1], bucket - n, axis=0)], axis=0), device=self.device)

        state = {"carry": carry_s}

        def advance(length: int) -> tuple[bool, float]:
            state["carry"], *_ = engine.scan_chunk(
                inst_s, state["carry"], self._alpha, self.tol, self.patience,
                self.max_iters, length=length, accel=self._accel, app_mask=am,
                telemetry=self._telemetry)
            done = state["carry"].done.cpu().numpy()
            if bool(done.all()):
                return True, float("inf")
            running = ~done[:n]
            res = state["carry"].residual.cpu().numpy()[:n]
            probe = float(res[running].min()) if running.any() else float("inf")
            return False, probe

        with self._span(phase, members=list(members)):
            plateaued = self._chunk_schedule(advance, plateau_res=plateau_res,
                                             max_iters=max_iters)
        carry_s = state["carry"]
        self.carry = _put(self.carry, self._index(members),
                          gp._members(carry_s, self._index(range(n))))
        iters = carry_s.iters[:n].cpu().numpy().copy()
        if self._telemetry is not None:
            tb_h = carry_s.tb.cpu().numpy()        # (bucket, R, 8) in one transfer
            for i, m in enumerate(members):
                self._drain_ring(m, tb_h[i], int(iters[i]), phase)
        self.total_iters += int(iters.sum())
        return iters, plateaued

    def _converge_one(self, b: int, app_mask: Optional[np.ndarray],
                      plateau_res: Optional[float], max_iters: Optional[int] = None,
                      allowed=None, phase: str = "solve") -> tuple[np.ndarray, bool]:
        """Single-member convergence without a member dim (``gp.solve``'s
        arithmetic).  ``allowed`` carries optional (allowed_e, allowed_c)
        direction masks: the baseline-restricted rung."""
        inst_b = self._members[b]
        am = None if app_mask is None else torch.as_tensor(
            np.asarray(app_mask, dtype=bool)[0], device=self.device)
        ae, ac = (None, None) if allowed is None else allowed

        state = {"carry": _take(self.carry, b)}

        def advance(length: int) -> tuple[bool, float]:
            state["carry"], *_ = engine.scan_chunk(
                inst_b, state["carry"], self._alpha, self.tol, self.patience,
                self.max_iters, ae, ac, length=length, accel=self._accel, app_mask=am,
                telemetry=self._telemetry)
            return bool(state["carry"].done), float(state["carry"].residual)

        with self._span(phase, tid=b, member=b):
            plateaued = self._chunk_schedule(advance, plateau_res=plateau_res,
                                             max_iters=max_iters)
        carry_b = state["carry"]
        self._scatter_carry(b, carry_b)
        iters = np.asarray([int(carry_b.iters)], np.int64)
        self._drain_ring(b, carry_b.tb, int(iters[0]), phase)
        self.total_iters += int(iters.sum())
        return iters, plateaued
