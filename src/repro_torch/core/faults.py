"""Chaos traces and fault injection for the online service.

Port of ``repro.core.faults``.  Two sources of adversarial input for
``serve.online.OnlineSolver``'s guardrail layer:

  * :func:`chaos_trace` — a seeded generator of hostile event streams:
    link flapping (down/up bursts on one edge), correlated node failures
    near destinations (possibly shedding chains), rate surges past the
    modelled capacity (each with its inverse recovery scheduled, so the
    trace ends in the stable region), and event storms hitting many fleet
    members inside one ``step()`` batch.  It returns step batches
    (``list[list[Event]]``): a storm is a storm only inside one batch.
  * :class:`FaultInjector` — corrupts the solver state itself at the solve
    boundary (non-finite carry entries, de-normalized strategy rows), the
    partial writes and bad device math no event stream can produce.
    ``OnlineSolver(fault_injector=...)`` calls :meth:`FaultInjector.
    maybe_corrupt` on the event's member before each re-convergence, and
    every injection is logged.

Both are deterministic in their seeds: every draw is a host numpy draw, in
the reference's order, so a trace and an injection schedule are the
reference's.  The injector picks its entries on the carry's own strategy
(copied to the host), and hands the corrupted fields back on the carry's
device; the trace generator replays its own events through
``events.apply_event``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import engine, events
from repro_torch.core.network import Instance

# ---------------------------------------------------------------------------
# Fault injection at the solve boundary
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Injection:
    """One recorded state corruption (for recovery-rate accounting)."""

    event_index: int
    member: int
    mode: str


class FaultInjector:
    """Seeded corruption of a member's solver carry at the solve boundary.

    Modes:

      * ``"nan_carry"``  — up to three live ``phi.e`` entries (above 1e-6)
        become NaN and the carry's cost and best cost are poisoned: the
        non-finite recovery path (repair does not reseed a NaN row, so the
        solver must see the non-finite cost and climb the ladder).
      * ``"denorm_phi"`` — up to four rows carrying mass (above 0.5) are
        scaled by 1.5-4x: the strategy breaks the simplex invariant while
        every entry stays finite (``verify_fleet`` and quarantine).

    ``p_inject`` is the per-event corruption probability; the draws are
    made once per :meth:`maybe_corrupt` call, so the schedule is a pure
    function of the seed.  ``metrics`` (optional, duck-typed: a
    ``counter(name)`` method) takes a ``faults.injected.<mode>`` tick per
    injection.
    """

    MODES = ("nan_carry", "denorm_phi")

    def __init__(self, seed: int = 0, p_inject: float = 0.2,
                 modes: Sequence[str] = MODES, metrics=None):
        for m in modes:
            if m not in self.MODES:
                raise ValueError(f"unknown fault mode {m!r}")
        self._rng = np.random.default_rng(seed)
        self.p_inject = float(p_inject)
        self.modes = tuple(modes)
        self.metrics = metrics
        self.log: list[Injection] = []

    def maybe_corrupt(self, carry_b: engine.SolveCarry, member: int,
                      event_index: int) -> tuple[engine.SolveCarry, Optional[str]]:
        """Roll the dice for one event; returns (carry, mode or None)."""
        if self._rng.random() >= self.p_inject:
            return carry_b, None
        mode = self.modes[int(self._rng.integers(len(self.modes)))]
        if mode == "nan_carry":
            carry_b = self._nan_carry(carry_b)
        else:
            carry_b = self._denorm_phi(carry_b)
        self.log.append(Injection(event_index=event_index, member=member, mode=mode))
        if self.metrics is not None:
            self.metrics.counter(f"faults.injected.{mode}")
        return carry_b, mode

    def _nan_carry(self, carry: engine.SolveCarry) -> engine.SolveCarry:
        e = carry.phi.e.detach().cpu().numpy().astype(np.float32)
        flat = e.reshape(-1)
        live = np.flatnonzero(flat > 1e-6)
        if len(live) == 0:
            return carry
        pick = self._rng.choice(live, size=min(3, len(live)), replace=False)
        flat[pick] = np.nan
        dev = carry.phi.e.device
        nan = torch.full_like(carry.cost, torch.nan)
        return carry._replace(phi=carry.phi._replace(e=torch.from_numpy(e).to(dev)),
                              cost=nan, best_cost=nan.clone())

    def _denorm_phi(self, carry: engine.SolveCarry) -> engine.SolveCarry:
        e = carry.phi.e.detach().cpu().numpy().astype(np.float32)
        c = carry.phi.c.detach().cpu().numpy().astype(np.float32)
        mass = e.sum(-1) + c                          # (A, K1, V) row sums
        rows = np.argwhere(mass > 0.5)
        if len(rows) == 0:
            return carry
        pick = rows[self._rng.choice(len(rows), size=min(4, len(rows)), replace=False)]
        for a, k, i in pick:
            f = self._rng.uniform(1.5, 4.0)
            e[a, k, i] *= f
            c[a, k, i] *= f
        dev = carry.phi.e.device
        return carry._replace(phi=carry.phi._replace(e=torch.from_numpy(e).to(dev),
                                                     c=torch.from_numpy(c).to(dev)))


# ---------------------------------------------------------------------------
# Chaos traces
# ---------------------------------------------------------------------------


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def chaos_trace(
    members: Sequence[Instance],
    n_events: int = 100,
    seed: int = 0,
    *,
    p_flap: float = 0.30,
    p_node_burst: float = 0.15,
    p_surge: float = 0.35,
    p_storm: float = 0.20,
    surge_window: tuple = (2.5, 6.0),
    max_cum: float = 8.0,
    flap_delay: tuple = (1, 3),
    p_shed: float = 0.3,
) -> list[list[events.Event]]:
    """Sample a deterministic adversarial event trace as step batches.

    ``n_events`` counts individual events across all batches (recoveries
    included).  Guarantees, by replaying its own events while sampling:

      * every member keeps at least one live application (a failure that
        would shed the last chain is never emitted);
      * destination-isolating failures are allowed (probability ``p_shed``
        per candidate): the shed chains depart through
        ``events.apply_event``;
      * every surge schedules its exact inverse recovery, and all
        scheduled recoveries are flushed before the trace ends (a recovery
        that later churn invalidated, e.g. its app was shed, is dropped);
      * cumulative per-app rate factors never exceed ``max_cum``.

    Deterministic in ``seed``.  Unsatisfiable pattern draws fall back to a
    bounded rate scale, so generation always terminates.
    """
    rng = np.random.default_rng(seed)
    state = list(members)
    cum = [np.ones(m.A) for m in members]
    orig_cap = [_np(m.link_param).copy() for m in members]
    due: dict[int, list[tuple]] = {}           # step -> recovery specs
    steps: list[list[events.Event]] = []
    emitted = 0
    t = 0

    def alive_apps(m):
        return np.flatnonzero(_np(state[m].stage_mask).any(axis=1))

    def scheduled():
        return sum(len(v) for v in due.values())

    def room():
        return n_events - emitted - scheduled()

    def commit(batch, ev) -> bool:
        nonlocal emitted
        try:
            new, _ = events.apply_event(state[ev.member], ev)
        except ValueError:
            return False
        state[ev.member] = new
        batch.append(ev)
        emitted += 1
        return True

    def schedule(delay: int, spec: tuple) -> None:
        due.setdefault(t + max(1, delay), []).append(spec)

    def realize(spec) -> Optional[events.Event]:
        """A recovery spec as an event, or None where later churn
        invalidated it (dead slot, revived link)."""
        kind, m = spec[0], spec[1]
        if kind == "linkup":
            _, _, i, j, cap = spec
            if bool(_np(state[m].adj)[i, j]):
                return None
            return events.LinkUp(member=m, i=i, j=j, capacity=cap)
        _, _, a, factor = spec                 # "unsurge"
        if not bool(_np(state[m].stage_mask)[a].any()):
            return None
        cum[m][a] *= factor
        return events.RateScale(member=m, factor=factor, app=a)

    def survivable(m, ev) -> Optional[tuple]:
        """Tentatively apply; reject draws that kill the member's last
        chain, or that shed chains when shedding was not rolled."""
        try:
            new, eff = events.apply_event(state[m], ev)
        except ValueError:
            return None
        if not bool(_np(new.stage_mask).any()):
            return None
        if eff.shed and rng.random() >= p_shed:
            return None
        return (new, eff)

    def flap(batch, m) -> bool:
        adj = _np(state[m].adj)
        links = np.argwhere(adj)
        rng.shuffle(links)
        for i, j in links[:32]:
            ev = events.LinkDown(member=m, i=int(i), j=int(j))
            if survivable(m, ev) is None:
                continue
            cap = float(orig_cap[m][i, j]) or float(_np(state[m].link_param)[i, j]) or 1.0
            if not commit(batch, ev):
                continue
            schedule(int(rng.integers(*flap_delay)), ("linkup", m, int(i), int(j), cap))
            return True
        return False

    def node_burst(batch, m) -> bool:
        inst = state[m]
        adj = _np(inst.adj)
        dst = _np(inst.dst)
        apps = alive_apps(m)
        if len(apps) == 0:
            return False
        d = int(dst[int(rng.choice(apps))])
        dsts = {int(dst[a]) for a in apps}
        cand = [int(v) for v in np.flatnonzero(adj[:, d]) if v not in dsts]
        rng.shuffle(cand)
        hit = 0
        for v in cand[: int(rng.integers(1, 3))]:
            ev = events.NodeDown(member=m, node=v)
            if survivable(m, ev) is None:
                continue
            if commit(batch, ev):
                hit += 1
        return hit > 0

    def surge(batch, m) -> bool:
        apps = [a for a in alive_apps(m) if cum[m][a] * 1.1 < max_cum]
        if not apps:
            return False
        a = int(rng.choice(np.asarray(apps)))
        f = float(min(rng.uniform(*surge_window), max_cum / cum[m][a]))
        if f < 1.1:
            return False
        ev = events.RateScale(member=m, factor=f, app=a)
        if not commit(batch, ev):
            return False
        cum[m][a] *= f
        schedule(int(rng.integers(2, 5)), ("unsurge", m, a, 1.0 / f))
        return True

    def small_rate(batch, m) -> bool:
        apps = alive_apps(m)
        if len(apps) == 0:
            return False
        a = int(rng.choice(apps))
        f = 0.5 if cum[m][a] >= max_cum / 2 else float(rng.choice([0.8, 1.25, 1.5]))
        if commit(batch, events.RateScale(member=m, factor=f, app=a)):
            cum[m][a] *= f
            return True
        return False

    def storm(batch) -> bool:
        hit = 0
        targets = rng.permutation(len(members))[: max(2, min(len(members), room()))]
        for m in targets:
            if room() <= 0:
                break
            if small_rate(batch, int(m)):
                hit += 1
        return hit > 1

    probs = np.array([p_flap, p_node_burst, p_surge, p_storm], dtype=float)
    probs = probs / probs.sum()

    while emitted < n_events or scheduled() > 0:
        batch: list[events.Event] = []
        for spec in due.pop(t, []):
            ev = realize(spec)
            if ev is not None:
                commit(batch, ev)
        if room() > 0:
            m = int(rng.integers(len(members)))
            kind = int(rng.choice(4, p=probs))
            ok = False
            if kind == 0 and room() >= 2:
                ok = flap(batch, m)
            elif kind == 1:
                ok = node_burst(batch, m)
            elif kind == 2 and room() >= 2:
                ok = surge(batch, m)
            elif kind == 3:
                ok = storm(batch)
            if not ok and room() > 0:
                small_rate(batch, m)
        if batch:
            steps.append(batch)
        t += 1
    return steps
