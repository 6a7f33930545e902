"""Regenerate ``torch_ref_online.npz``, the JAX reference's event layer runs.

The PyTorch port's event tests (``tests/test_torch_events.py``,
``tests/test_torch_simulate.py``) and the ``online_trace`` and ``simulate``
phases of ``chip_smoke.py`` hold the port against this file.  Every solve
runs with ``solver="dense"`` (the reference's ``batched_lu`` route aborts in
XLA on the CPU at V >= 22; ``traffic.AUTO_MIN_V`` is raised so that the
reference's "auto" measurements, such as a solve's initial cost, take the
dense route too) and with the telemetry ring on, so that each
step's rung and Anderson decision can be compared.

Contents, under the fleet's key (``fig6`` or ``sw``):

  * ``<fleet>/trace`` — the event trace of ``events.random_trace`` over the
    padded fleet (``events.pad_fleet``), as JSON: one object per event,
    ``{"type": class name, **fields}``;
  * ``<fleet>/members/<field>`` — every dense field of each post-event
    member (``events.replay``), stacked along the event axis;
  * ``<fleet>/GP/<label>/<column>`` — the reference's batched cold solve of
    the ``online-trace`` family (``scenarios.run_sweep``'s grouping), one
    member per event, in the layout of ``torch_ref_sweep.npz`` (cost and
    residual histories, iterations, and per committed iteration the
    stepsize, rung, Anderson acceptance and largest strategy move), so that
    ``_torch_cases.golden_member`` / ``sweep_parity`` read it as they read
    that file.

The two fleets:

  * ``fig6`` — Abilene at ``FIG6_SCALES``, seed 0, 50 events, two spare
    application slots (``benchmarks/online_bench.py``), ``alpha=0.1,
    max_iters=300``;
  * ``sw`` — sw-queue at full width (V=100, 30 applications plus 2 spare
    slots, 3 stages) at scales 0.5 and 1.0, seed 0, 16 events,
    ``alpha=0.1, max_iters=250``.

``warm/GP/t<t>/<name>`` — warm re-solves over the first ``WARM_EVENTS`` events
of the fig6 trace.  Each fleet member first holds its cold solve
(``gp.solve``, ``alpha=0.1, max_iters=300``) as its live strategy; at each
event, on the event's member after the event:

  * ``live_e`` / ``live_c`` — the member's live strategy before the event;
  * ``phi0_e`` / ``phi0_c`` — ``traffic.repair_phi(inst, live,
    gp.init_phi(inst))``;
  * ``residual0`` — ``conditions.per_app_residual(inst, phi0)`` and
    ``mask = residual0 > GATE_TOL``;
  * the solve ``gp.solve(inst, phi0, app_mask=mask, alpha=0.1,
    max_iters=300)``: its histories and telemetry columns as the fleets'
    runs, and ``final_residual``, its final ``per_app_residual``; its
    strategy becomes the member's live one;
  * under ``warm/GP-sparse/t<t>`` and ``warm/GP-budget/t<t>`` the same
    solve through the reference's other stage solver (``solver="sparse"``
    on ``network.with_sparse(inst)``) and with the stall latch off
    (``patience=max_iters``): the reference's own spread on the solve,
    which ``_torch_cases.sweep_parity`` takes as witnesses.

``sim/<name>`` — ``simulate.simulate(inst, phi, horizon=3000, warmup=300,
seed=1)`` on Abilene at ``rate_scale=1.5`` with the reference's GP strategy
(``gp.solve``, ``alpha=0.1, max_iters=250``): the strategy (``phi_e``,
``phi_c``) and the ``SimResult``'s fields.

Run from the repository root, on the CPU (all parts by default):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_ref_online.py [part ...]

Parts: ``fig6``, ``sw``, ``warm``, ``sim``, and the reference's own other
runs of the fleets' families, its spread on each member, which
``sweep_parity`` takes as witnesses: ``<fleet>-sparse`` (its other stage
solver), ``<fleet>-serial`` (one by one), ``<fleet>-budget`` (the stall
latch off), for ``fig6`` and ``sw``.  Each part rewrites its own keys.
All parts took about 35 minutes on 8 CPU cores, 12 of them the ``sw``
part.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_ref_online.npz")

FLEETS = {
    "fig6": {"scenario": "abilene", "scales": (0.5, 1.0, 1.5, 2.0, 2.5, 3.0),
             "seed": 0, "n_events": 50, "spare_apps": 2,
             "alpha": 0.1, "max_iters": 300},
    "sw": {"scenario": "sw-queue", "scales": (0.5, 1.0), "seed": 0,
           "n_events": 16, "spare_apps": 2, "alpha": 0.1, "max_iters": 250},
}
WARM_EVENTS = 12
WARM = {"fleet": "fig6", "events": WARM_EVENTS, "alpha": 0.1, "max_iters": 300}
GATE_TOL = 1e-4      # an application whose residual is above this is re-solved
SIM = {"scenario": "abilene", "seed": 0, "rate_scale": 1.5, "alpha": 0.1,
       "max_iters": 250, "horizon": 3000.0, "warmup": 300.0, "sim_seed": 1}
SOLVER = "dense"
PARTS = ("fig6", "sw", "warm", "sim", "fig6-sparse", "fig6-serial", "fig6-budget",
         "sw-sparse", "sw-serial", "sw-budget")
FIELDS = ("adj", "link_param", "comp_param", "L", "w", "wnode", "r", "dst",
          "n_tasks", "stage_mask")


def trace_to_json(trace) -> str:
    """An event list as JSON: ``[{"type": class name, **fields}, ...]``."""
    return json.dumps([{"type": type(ev).__name__, **dataclasses.asdict(ev)}
                       for ev in trace])


def fleet_members(fleet: str):
    """The reference's padded fleet and its trace."""
    from repro.core import events, network

    p = FLEETS[fleet]
    insts = [network.table_ii_instance(p["scenario"], seed=p["seed"], rate_scale=s)
             for s in p["scales"]]
    members = events.pad_fleet(insts, spare_apps=p["spare_apps"])
    return members, events.random_trace(members, n_events=p["n_events"], seed=p["seed"])


def run_fleet(part: str) -> dict:
    """A fleet's part: ``<fleet>`` (the trace, the members and the batched
    cold solve ``GP``) or ``<fleet>-sparse`` / ``-serial`` / ``-budget``
    (the reference's own other runs of the family, as in
    ``make_torch_ref_sweep.py``: ``GP-sparse``, ``GP-serial``,
    ``GP-budget``)."""
    import numpy as np

    from repro.core import events, network, scenarios

    sys.path.insert(0, HERE)
    from make_torch_ref_sweep import reference_one_by_one, reference_sweep

    fleet, _, way = part.partition("-")
    p = FLEETS[fleet]
    members, trace = fleet_members(fleet)
    out = {}
    fam = scenarios.expand("online-trace", scenario=p["scenario"], scales=p["scales"],
                           seed=p["seed"], spare_apps=p["spare_apps"], trace=trace)
    kw = {"alpha": p["alpha"], "max_iters": p["max_iters"]}
    if not way:
        out[f"{fleet}/trace"] = np.array(trace_to_json(trace))
        after = [inst for _, inst, _ in events.replay(members, trace)]
        for f in FIELDS:
            out[f"{fleet}/members/{f}"] = np.stack([np.asarray(getattr(i, f)) for i in after])
    t0 = time.perf_counter()
    if way == "serial":
        recs = reference_one_by_one(fam, chained=False, **kw)
    elif way == "sparse":
        fam = [scenarios.Scenario(sc.label, network.with_sparse(sc.instance), sc.meta)
               for sc in fam]
        recs = reference_sweep(fam, None, solver="sparse", **kw)
    else:
        recs = reference_sweep(fam, None, patience=p["max_iters"] if way else 40, **kw)
    name = "GP" + (f"-{way}" if way else "")
    print(f"{part}: {len(fam)} members in {time.perf_counter() - t0:.1f} s, iterations "
          + " ".join(str(int(v["iterations"])) for v in recs.values()), flush=True)
    for label, rec in recs.items():
        for field, val in rec.items():
            out[f"{fleet}/{name}/{label}/{field}"] = val
    return out


def _telemetry_run(r) -> dict:
    """A solve's histories and telemetry columns, as the sweep file keeps
    them (``make_torch_ref_sweep.TEL_COLUMNS``)."""
    import numpy as np

    from make_torch_ref_sweep import TEL_COLUMNS
    from repro.obs.device import COLUMNS

    n = int(r.iterations)
    ring = np.asarray(r.telemetry)[:n]
    rec = {"iterations": np.int32(n),
           "cost_history": np.asarray(r.cost_history, np.float32),
           "residual_history": np.asarray(r.residual_history, np.float32)}
    for col in TEL_COLUMNS:
        rec[col] = ring[:, COLUMNS.index(col)].astype(np.float32)
    return rec


def run_warm() -> dict:
    import numpy as np

    from repro.core import conditions, events, gp, network, traffic
    from repro.obs.device import TelemetryConfig

    sys.path.insert(0, HERE)
    members, trace = fleet_members(WARM["fleet"])
    kw = {"alpha": WARM["alpha"], "max_iters": WARM["max_iters"]}
    tel = TelemetryConfig(ring=WARM["max_iters"], bs_rounds=False)
    live = [gp.solve(m, solver=SOLVER, **kw).phi for m in members]
    out = {}
    for t, ev in enumerate(trace[:WARM["events"]]):
        m = ev.member
        inst, _ = events.apply_event(members[m], ev)
        members[m] = inst
        phi0 = traffic.repair_phi(inst, live[m], gp.init_phi(inst))
        res0 = conditions.per_app_residual(inst, phi0)
        mask = res0 > GATE_TOL
        r = gp.solve(inst, phi0, app_mask=mask, telemetry=tel, solver=SOLVER, **kw)
        runs = {
            "GP": {"member": np.int32(m),
                   "live_e": np.asarray(live[m].e), "live_c": np.asarray(live[m].c),
                   "phi0_e": np.asarray(phi0.e), "phi0_c": np.asarray(phi0.c),
                   "residual0": np.asarray(res0), "mask": np.asarray(mask),
                   "final_residual": np.asarray(conditions.per_app_residual(inst, r.phi)),
                   **_telemetry_run(r)},
            # the reference's own other runs of the same solve: its other
            # stage solver, and its run with the stall latch off
            "GP-sparse": _telemetry_run(gp.solve(
                network.with_sparse(inst), phi0, app_mask=mask, telemetry=tel,
                solver="sparse", **kw)),
            "GP-budget": _telemetry_run(gp.solve(
                inst, phi0, app_mask=mask, telemetry=tel, solver=SOLVER,
                patience=WARM["max_iters"], **kw)),
        }
        print(f"warm {t}: member {m} {type(ev).__name__}, mask "
              f"{np.asarray(mask).astype(int).tolist()}, iterations "
              + " ".join(f"{k}={int(v['iterations'])}" for k, v in runs.items()), flush=True)
        for name, rec in runs.items():
            for k, v in rec.items():
                out[f"warm/{name}/t{t:02d}/{k}"] = v
        live[m] = r.phi
    return out


def run_sim() -> dict:
    import numpy as np

    from repro.core import gp, network
    from repro.core.simulate import simulate

    inst = network.table_ii_instance(SIM["scenario"], seed=SIM["seed"],
                                     rate_scale=SIM["rate_scale"])
    res = gp.solve(inst, alpha=SIM["alpha"], max_iters=SIM["max_iters"], solver=SOLVER)
    sim = simulate(inst, res.phi, horizon=SIM["horizon"], warmup=SIM["warmup"],
                   seed=SIM["sim_seed"])
    print(f"sim: {sim}", flush=True)
    out = {"sim/phi_e": np.asarray(res.phi.e), "sim/phi_c": np.asarray(res.phi.c)}
    for k, v in dataclasses.asdict(sim).items():
        out[f"sim/{k}"] = np.asarray(v)
    return out


def main(parts) -> None:
    import jax
    import numpy as np

    from repro.core import traffic

    # every flow measurement on the dense route, the solves' initial costs
    # and the gate's residuals included: "auto" would take the batched_lu
    # route at V >= AUTO_MIN_V, whose vmapped factorization aborts in XLA
    traffic.AUTO_MIN_V = 1 << 30

    for part in parts:
        if part not in PARTS:
            raise SystemExit(f"unknown part {part!r}; want one of {PARTS}")
        t0 = time.perf_counter()
        new = run_warm() if part == "warm" else run_sim() if part == "sim" else run_fleet(part)
        old = {}
        if os.path.exists(OUT):
            with np.load(OUT) as z:
                old = {k: z[k] for k in z.files}
        # the part rewrites its own (fleet or part, solver or field) keys
        mine = {tuple(k.split("/")[:2]) for k in new}
        keep = {k: v for k, v in old.items()
                if k != "meta" and tuple(k.split("/")[:2]) not in mine}
        keep.update(new)
        meta = {"fleets": FLEETS, "warm": WARM, "gate_tol": GATE_TOL, "sim": SIM,
                "solver": SOLVER, "jax_version": jax.__version__}
        keep["meta"] = np.array(json.dumps(meta))
        np.savez_compressed(OUT, **keep)
        print(f"wrote {OUT} part {part} in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:] or PARTS)
