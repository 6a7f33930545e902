"""Named scenario sweeps: the paper's figures as batched scenario families.

Port of ``repro.core.scenarios``.  Fig. 5-7 of the paper are statements
about families of instances (Table II topologies x input-rate scalings x
seeds).  This module expands a named sweep into a list of :class:`Scenario`
and solves whole families with the member-batched solver
(``batch.pad_instances`` + ``gp.solve_batched``), grouping members by cost
kinds and by the power-of-two size class of V first.

Built-in sweeps:

  * ``fig5``            — the 8 Table II scenarios at their congested-regime
                          rate scalings (GP vs baselines, Fig. 5)
  * ``fig6-congestion`` — Abilene across input-rate scalings (Fig. 6)
  * ``fig7-packetsize`` — Abilene across input packet sizes L_(a,0) (Fig. 7)
  * ``seed-ensemble``   — one topology, many random seeds
  * ``mixed-topology``  — heterogeneous Table II topologies in ONE padded
                          batch (the padding invariants)
  * ``online-trace``    — the fig6 fleet after each event of an online
                          trace (``events``): the per-event cold baseline

``run_sweep`` solves a family batched, ``run_sweep_serial`` one member at a
time through ``gp.solve``, ``run_sweep_chained`` one at a time with each
member warm-started from its predecessor's strategy.  Instances are built
on ``device`` (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import batch, gp, network
from repro_torch.core.network import Device, resolve_device
from repro_torch.core.traffic import Phi

# Input-rate scaling per Table II scenario so the networks operate in the
# congested regime the paper targets; fog's capacities leave it lightly
# loaded at 2x, so it runs at 3.5x.
FIG5_RATE = {
    "connected-er": 2.0, "balanced-tree": 2.0, "fog": 3.5, "abilene": 2.0,
    "lhc": 2.0, "geant": 2.0, "sw-linear": 1.5, "sw-queue": 1.5,
}

FIG6_SCALES = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)
FIG7_L0 = (2.0, 5.0, 10.0, 20.0, 40.0)

# Table II members small enough to batch comfortably (excludes the V=100
# small-world pair).
SMALL_TABLE_II = ("connected-er", "balanced-tree", "fog", "abilene", "lhc", "geant")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One member of a sweep: a labeled Instance plus provenance."""

    label: str
    instance: network.Instance
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def kinds(self) -> tuple[int, int]:
        return (self.instance.link_kind, self.instance.comp_kind)


def _table_ii(label, name, seed, rate, device) -> Scenario:
    return Scenario(
        label=label,
        instance=network.table_ii_instance(name, seed=seed, rate_scale=rate,
                                           device=device),
        meta={"table_ii": name, "seed": seed, "rate_scale": rate})


def _fig5(device="cuda", **kw) -> list[Scenario]:
    seed = kw.get("seed", 0)
    return [_table_ii(name, name, seed, rate, device)
            for name, rate in FIG5_RATE.items()]


def _fig6_congestion(device="cuda", **kw) -> list[Scenario]:
    name = kw.get("scenario", "abilene")
    seed = kw.get("seed", 0)
    return [_table_ii(f"{name}@r{scale:g}", name, seed, scale, device)
            for scale in kw.get("scales", FIG6_SCALES)]


def _fig7_packetsize(device="cuda", **kw) -> list[Scenario]:
    seed = kw.get("seed", 0)
    out = []
    for l0 in kw.get("l0_values", FIG7_L0):
        inst = network.build_instance(
            network.TOPOLOGIES["abilene"](), n_apps=3, n_tasks=2, n_sources=3,
            link_mean=15.0, comp_mean=10.0, seed=seed,
            packet_sizes=np.array([l0, l0 / 2, 0.01]), device=device)
        out.append(Scenario(label=f"abilene@L0={l0:g}", instance=inst,
                            meta={"topology": "abilene", "seed": seed, "L0": l0}))
    return out


def _seed_ensemble(device="cuda", **kw) -> list[Scenario]:
    name = kw.get("scenario", "abilene")
    rate = kw.get("rate_scale", 2.0)
    return [_table_ii(f"{name}#s{s}", name, s, rate, device)
            for s in range(kw.get("n_seeds", 32))]


def _mixed_topology(device="cuda", **kw) -> list[Scenario]:
    rate = kw.get("rate_scale", 1.5)
    return [_table_ii(f"{name}#s{s}", name, s, rate, device)
            for name in kw.get("scenarios", SMALL_TABLE_II)
            for s in kw.get("seeds", (0, 1))]


def _online_trace(device="cuda", **kw) -> list[Scenario]:
    """Event-trace replay family: one Scenario per event of an online
    trace, holding the event's member after the event.

    Cold-solving this family gives the per-event cold baseline an online
    solver is measured against.  Every member is padded to the fleet's
    envelope plus ``spare_apps`` dead application slots, so the family
    batches as one group.  kwargs: ``scenario`` (Table II name),
    ``scales`` (the fleet's rate ladder), ``seed``, ``n_events``,
    ``spare_apps``, and optionally ``trace`` (a list of ``events.Event``)
    to replay instead of sampling one.
    """
    from repro_torch.core import events

    name = kw.get("scenario", "abilene")
    scales = kw.get("scales", FIG6_SCALES)
    seed = kw.get("seed", 0)
    insts = [network.table_ii_instance(name, seed=seed, rate_scale=s, device=device)
             for s in scales]
    members = events.pad_fleet(insts, spare_apps=kw.get("spare_apps", 2))
    trace = kw.get("trace")
    if trace is None:
        trace = events.random_trace(members, n_events=kw.get("n_events", 50), seed=seed)
    return [Scenario(label=f"{name}-ev{t:02d}-m{ev.member}", instance=inst,
                     meta={"event": type(ev).__name__, "member": ev.member, "t": t,
                           "table_ii": name, "seed": seed,
                           "base_scale": scales[ev.member]})
            for t, (ev, inst, _eff) in enumerate(events.replay(members, trace))]


SWEEPS: dict[str, Callable[..., list[Scenario]]] = {
    "fig5": _fig5,
    "fig6-congestion": _fig6_congestion,
    "fig7-packetsize": _fig7_packetsize,
    "seed-ensemble": _seed_ensemble,
    "mixed-topology": _mixed_topology,
    "online-trace": _online_trace,
}


def register(name: str, build: Callable[..., list[Scenario]]) -> None:
    """Add a sweep to the registry; ``build(device=..., **kw)``."""
    if name in SWEEPS:
        raise ValueError(f"sweep {name!r} already registered")
    SWEEPS[name] = build


def expand(name: str, *, device: Device = "cuda", **kw) -> list[Scenario]:
    """Expand a named sweep into its scenario list, on ``device``."""
    try:
        build = SWEEPS[name]
    except KeyError:
        raise KeyError(f"unknown sweep {name!r}; have {sorted(SWEEPS)}") from None
    return build(device=resolve_device(device), **kw)


def _scenarios(name_or_scenarios, sweep_kwargs, device) -> list[Scenario]:
    if isinstance(name_or_scenarios, str):
        return expand(name_or_scenarios, device=device, **(sweep_kwargs or {}))
    return list(name_or_scenarios)


def _sync(scenarios: Sequence[Scenario]) -> None:
    devs = {sc.instance.device for sc in scenarios}
    for dev in devs:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# Batched execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepResult:
    scenarios: list[Scenario]
    results: list[gp.GPResult]      # aligned with scenarios, phi un-padded
    seconds: float                  # wall clock of the solve(s)
    n_batches: int                  # groups the family was split into


def solve_family(
    insts: Sequence[network.Instance],
    phi0s: Optional[Sequence[Phi]] = None,
    *,
    masks_fn: Optional[Callable] = None,
    mesh=None,
    **gp_kwargs,
) -> list[gp.GPResult]:
    """Solve same-cost-family instances as ONE padded, member-batched solve.

    ``masks_fn`` (e.g. ``baselines.spoc_masks``) maps an Instance to
    (allowed_e, allowed_c, phi0); it runs on the padded family, so the
    restricted baselines go through the same batched solve as GP.  An
    explicit ``phi0s`` overrides the masks' initial strategies.  Returns
    per-instance trimmed GPResults with the padding stripped from phi.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the members' application axis sharded over devices) is "
            "not ported yet: ROADMAP Queue 1, Multi-device")
    binst = batch.pad_instances(insts)
    phi0 = batch.pad_phis(phi0s, insts) if phi0s is not None else None
    if masks_fn is not None:
        allowed_e, allowed_c, mask_phi0 = masks_fn(binst)
        gp_kwargs.setdefault("allowed_e", allowed_e)
        gp_kwargs.setdefault("allowed_c", allowed_c)
        if phi0 is None:
            phi0 = mask_phi0
    gp_kwargs.setdefault("device", binst.device)
    scan = gp.solve_batched(binst, phi0, **gp_kwargs)
    out = []
    for b, inst in enumerate(insts):
        res = scan.member(b)
        out.append(dataclasses.replace(res, phi=batch.unpad_phi(res.phi, inst)))
    return out


def run_sweep(name_or_scenarios, *, sweep_kwargs: Optional[dict] = None,
              masks_fn: Optional[Callable] = None, mesh=None,
              device: Device = "cuda", **gp_kwargs) -> SweepResult:
    """Expand a sweep (on ``device``) and solve it batched.

    ``name_or_scenarios`` is a registry name (expanded with
    ``sweep_kwargs``) or an explicit ``list[Scenario]``; remaining kwargs
    go to ``gp.solve_batched`` (``alpha``, ``max_iters``, ``accel``, ...).
    ``masks_fn`` restricts each member's direction set (the SPOC/LCOF
    baselines, ``baselines.BASELINE_MASKS``), computed on each padded
    group.  Members are grouped by cost kinds AND by the power-of-two size
    class of V: padding a V=11 member to a V=100 envelope would multiply
    its work ~80x, so differently sized members go into separate solves.
    ``results`` align 1:1 with ``scenarios``.
    """
    scenarios = _scenarios(name_or_scenarios, sweep_kwargs, device)
    groups: dict[tuple, list[int]] = {}
    for idx, sc in enumerate(scenarios):
        key = sc.kinds + (batch.next_pow2(sc.instance.V),)
        groups.setdefault(key, []).append(idx)

    results: list[Optional[gp.GPResult]] = [None] * len(scenarios)
    t0 = time.perf_counter()
    for idxs in groups.values():
        group_res = solve_family([scenarios[i].instance for i in idxs],
                                 masks_fn=masks_fn, mesh=mesh, **gp_kwargs)
        for i, r in zip(idxs, group_res):
            results[i] = r
    _sync(scenarios)
    seconds = time.perf_counter() - t0
    return SweepResult(scenarios=scenarios, results=results, seconds=seconds,
                       n_batches=len(groups))


def _masked_kwargs(inst, masks_fn, gp_kwargs):
    kw = dict(gp_kwargs)
    kw.setdefault("device", inst.device)
    phi0 = None
    if masks_fn is not None:
        allowed_e, allowed_c, phi0 = masks_fn(inst)
        kw.setdefault("allowed_e", allowed_e)
        kw.setdefault("allowed_c", allowed_c)
    return phi0, kw


def run_sweep_serial(name_or_scenarios, *, sweep_kwargs: Optional[dict] = None,
                     masks_fn: Optional[Callable] = None,
                     device: Device = "cuda", **gp_kwargs) -> SweepResult:
    """The serial reference: one ``gp.solve`` per scenario, with
    ``masks_fn`` computed on each unpadded instance, so both paths solve
    the same restricted problems."""
    scenarios = _scenarios(name_or_scenarios, sweep_kwargs, device)
    t0 = time.perf_counter()
    results = []
    for sc in scenarios:
        phi0, kw = _masked_kwargs(sc.instance, masks_fn, gp_kwargs)
        results.append(gp.solve(sc.instance, phi0, **kw))
    _sync(scenarios)
    seconds = time.perf_counter() - t0
    return SweepResult(scenarios=scenarios, results=results, seconds=seconds,
                       n_batches=len(scenarios))


def run_sweep_chained(name_or_scenarios, *,
                      sweep_kwargs: Optional[dict] = None,
                      masks_fn: Optional[Callable] = None,
                      device: Device = "cuda", **gp_kwargs) -> SweepResult:
    """Sequential sweep with warm starts: member k starts from member k-1's
    converged strategy (an incremental family such as the Fig. 6 rate
    ladder, ordered from least to most congested).

    A member that cannot inherit its predecessor's strategy (another graph,
    destinations or chain structure, not just another shape) starts cold.
    ``masks_fn`` restrictions still apply; the chained phi only replaces
    the initial strategy.  With ``accel=`` each member builds a fresh carry.
    """
    scenarios = _scenarios(name_or_scenarios, sweep_kwargs, device)
    t0 = time.perf_counter()
    results: list[gp.GPResult] = []
    phi_prev: Optional[Phi] = None
    inst_prev: Optional[network.Instance] = None
    for sc in scenarios:
        inst = sc.instance
        phi0, kw = _masked_kwargs(inst, masks_fn, gp_kwargs)
        inheritable = (
            phi_prev is not None
            and tuple(phi_prev.e.shape) == (inst.A, inst.K1, inst.V, inst.V)
            and torch.equal(inst.adj, inst_prev.adj)
            and torch.equal(inst.dst, inst_prev.dst)
            and torch.equal(inst.n_tasks, inst_prev.n_tasks)
        )
        if inheritable:
            phi0 = phi_prev
        res = gp.solve(inst, phi0, **kw)
        phi_prev, inst_prev = res.phi, inst
        results.append(res)
    _sync(scenarios)
    seconds = time.perf_counter() - t0
    return SweepResult(scenarios=scenarios, results=results, seconds=seconds,
                       n_batches=len(scenarios))
