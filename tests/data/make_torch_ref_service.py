"""Regenerate ``torch_ref_service.npz``, the JAX reference's online service runs.

The PyTorch port's service tests (``tests/test_torch_online.py``) and the
``online_service`` phase of ``chip_smoke.py`` hold ``serve.online.
OnlineSolver`` against this file.  Every run is the reference's
``repro.serve.online.OnlineSolver`` with ``alpha=0.1, tol=1e-4,
accel=True`` and the iteration ring on (``TelemetryConfig(ring=max_iters,
bs_rounds=False)``, which the reference holds trajectory-identical to
``telemetry=None``), through a subclass that records, without changing a
decision:

  * every re-convergence segment (``_converge_one``, and each member of the
    batched cold start): the event index (-1 for the cold start), member,
    phase (``cold-start``, ``warm``, ``cold``, ``unfreeze``, ``rung:<name>``,
    ``quarantine``), its budget, app mask and plateau flag, its starting
    cost, the carry's ``done`` / ``stall`` / ``iters`` / ``residual`` /
    ``cost`` after it, and per committed iteration the ring's cost,
    residual, stepsize, rung, Anderson verdict and largest strategy move;
  * per event: the gate's per-app residuals (the first
    ``per_app_residual`` call of the event), the cost of the re-armed carry
    (the first ``engine.reset_carry`` of the event), every ``HealthReport``
    field, and the member's carry after the event.

Runs (the part names):

  * ``seq`` — the four events of ``tests/test_online.py:33-70`` on Abilene
    at rate 0.5 (one member, no spare slot): ``RateScale(0, 1.8, app=0)``,
    ``RateScale(0, 2.0)``, ``LinkDown`` of the busiest link of the served
    strategy after event 2 (the reference's choice, stored), and
    ``RateScale(0, 0.5)``; per event also the reference's cold
    ``gp.solve(accel=True)`` of the post-event instance (cost, iterations).
  * ``trace50`` — ``benchmarks/online_bench.py``'s ``run_trace``: Abilene at
    ``FIG6_SCALES``, two spare slots, the 50 events of
    ``events.random_trace(seed=0)``; per event the cold accelerated solve as
    above, and for the events of ``STATE_EVENTS`` the touched member's carry
    before the event (``phi``, ``alpha``, ``ax``, ``af``, ``ak``) and its
    last-known-good checkpoint (``phi``, cost, residual, certificate).
  * ``chaos100`` — ``run_chaos``: the same fleet under
    ``faults.chaos_trace(n_events=100, seed=0)`` (the step batches), with
    ``FaultInjector(seed=1, p_inject=0.15)`` and ``debug=True``: the
    injection log, every report, ``ladder_hits``, ``quarantines`` and the
    final ``verify_fleet``.
  * ``budget`` — ``tests/test_faults.py:155``: Abilene at rate 1.0 with
    ``tol=1e-12, max_iters=4`` and ``RateScale(0, 2.0, app=0)``: the ladder
    down to ``baseline:*``.
  * ``inject`` — ``tests/test_faults.py:100``: Abilene at rate 0.5,
    ``debug=True``, ``FaultInjector(seed=0, p_inject=1.0, modes=(mode,))``
    for each mode, and ``RateScale(0, 1.2, app=0)``.

Keys are ``<part>/...``; each run's JSON (the events, the per-event
reports and records, the segments' scalars, the totals) is under
``<part>/json``, its arrays under ``<part>/seg/<n>/<col>`` and
``<part>/state/<t>/<name>``.  ``meta`` holds
each run's parameters, the jax version and the re-measured anchors
(``run_trace``'s online and cold iteration totals, ``run_chaos``'s status
counts).

Run from the repository root, on the CPU (all parts by default):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_ref_service.py [part ...]

Each part rewrites its own keys.  ``trace50`` took about 2 minutes on the
CPU, ``chaos100`` about 2.5, the others under a minute each.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_ref_service.npz")

ALPHA, TOL = 0.1, 1e-4
FLEET = {"scenario": "abilene", "scales": (0.5, 1.0, 1.5, 2.0, 2.5, 3.0), "seed": 0,
         "spare_apps": 2}
RUNS = {
    "seq": {"scenario": "abilene", "seed": 0, "rate_scale": 0.5, "spare_apps": 0,
            "solver": {"alpha": ALPHA, "tol": TOL, "accel": True}},
    "trace50": {**FLEET, "n_events": 50, "solver": {"alpha": ALPHA, "tol": TOL, "accel": True}},
    "chaos100": {**FLEET, "n_events": 100, "injector": {"seed": 1, "p_inject": 0.15},
                 "solver": {"alpha": ALPHA, "tol": TOL, "accel": True, "debug": True}},
    "budget": {"scenario": "abilene", "seed": 0, "rate_scale": 1.0, "spare_apps": 0,
               "event": {"type": "RateScale", "member": 0, "factor": 2.0, "app": 0},
               "solver": {"alpha": ALPHA, "tol": 1e-12, "max_iters": 4, "accel": True}},
    "inject": {"scenario": "abilene", "seed": 0, "rate_scale": 0.5, "spare_apps": 0,
               "modes": ("nan_carry", "denorm_phi"), "injector": {"seed": 0, "p_inject": 1.0},
               "event": {"type": "RateScale", "member": 0, "factor": 1.2, "app": 0},
               "solver": {"alpha": ALPHA, "tol": TOL, "accel": True, "debug": True}},
}
# trace50 events whose pre-event member state is stored (teacher-forced
# replay): all 50 fit in the file's 4 MB.
STATE_EVENTS = tuple(range(50))
PARTS = tuple(RUNS)
SEG_COLUMNS = ("cost", "residual", "alpha", "rung", "anderson", "phi_delta")


def event_dict(ev) -> dict:
    return {"type": type(ev).__name__, **dataclasses.asdict(ev)}


def event_from_dict(d: dict):
    import typing

    from repro.core import events

    fields = {k: v for k, v in d.items() if k != "type"}
    if "rates" in fields:
        fields["rates"] = tuple((int(n), float(r)) for n, r in fields["rates"])
    return {t.__name__: t for t in typing.get_args(events.Event)}[d["type"]](**fields)


def report_dict(rep) -> dict:
    """Every ``HealthReport`` field (the event as ``event_dict``)."""
    out = {}
    for f in dataclasses.fields(rep):
        v = getattr(rep, f.name)
        out[f.name] = (event_dict(v) if f.name == "event"
                       else list(v) if isinstance(v, tuple) else v)
    return out


def recording_solver(insts, **kw):
    """The reference's ``OnlineSolver`` with the segment and per-event
    recording of the module docstring (no decision changed)."""
    import numpy as np

    from repro.core import engine
    from repro.obs.device import TelemetryConfig
    from repro.serve.online import OnlineSolver

    class Recorder(OnlineSolver):
        def __init__(self, *a, **k):
            self.segments = []
            super().__init__(*a, **k)

        def _record(self, b, phase, start, n0, seg_kw):
            c = self.carry
            recs = [r for r in self.iter_trace[n0:] if r["member"] == b]
            self.segments.append({
                "event": -1 if phase == "cold-start" else len(self.reports),
                "member": int(b), "phase": phase, "start_cost": start,
                "done": bool(c.done[b]), "stall": int(c.stall[b]),
                "iters": int(c.iters[b]), "residual": float(c.residual[b]),
                "cost": float(c.cost[b]), **seg_kw,
                "cols": {k: np.asarray([r[k] for r in recs], np.float32)
                         for k in SEG_COLUMNS}})

        def _converge(self, members, app_mask=None, plateau_res=None, max_iters=None,
                      allowed=None, phase="solve"):
            if len(members) == 1:
                return super()._converge(members, app_mask, plateau_res, max_iters,
                                         allowed, phase)
            starts = [float(self.carry.cost[m]) for m in members]
            n0 = len(self.iter_trace)
            iters, plateaued = super()._converge(members, app_mask, plateau_res,
                                                 max_iters, allowed, phase)
            for m, s in zip(members, starts):
                self._record(m, phase, s, n0, {"budget": max_iters, "plateau": plateaued,
                                               "app_mask": None, "plateau_res": plateau_res})
            return iters, plateaued

        def _converge_one(self, b, app_mask, plateau_res, max_iters=None, allowed=None,
                          phase="solve"):
            start = float(self.carry.cost[b])
            n0 = len(self.iter_trace)
            iters, plateaued = super()._converge_one(b, app_mask, plateau_res, max_iters,
                                                     allowed, phase)
            mask = None if app_mask is None else np.asarray(app_mask)[0].astype(int).tolist()
            self._record(b, phase, start, n0, {"budget": max_iters, "plateau": plateaued,
                                               "app_mask": mask, "plateau_res": plateau_res,
                                               "allowed": allowed is not None})
            return iters, plateaued

    max_iters = kw.get("max_iters", 400)
    solver = Recorder(insts, telemetry=TelemetryConfig(ring=max_iters, bs_rounds=False),
                      **kw)
    solver.gates = []
    res_fn = solver._residual_fn

    def residual_fn(inst, phi):
        out = res_fn(inst, phi)
        solver.gates.append(np.asarray(out))
        return out
    solver._residual_fn = residual_fn
    if not hasattr(engine.reset_carry, "costs"):
        reset = engine.reset_carry

        def reset_carry(*a, **k):
            out = reset(*a, **k)
            reset_carry.costs.append(float(out.cost))
            return out
        reset_carry.costs = []
        engine.reset_carry = reset_carry
    solver.resets = engine.reset_carry.costs
    return solver


def member_state(solver, b) -> dict:
    """Member ``b``'s carry (strategy and Anderson window) and its
    last-known-good checkpoint, as arrays."""
    import numpy as np

    c = solver.carry
    return {"phi_e": np.asarray(c.phi.e[b]), "phi_c": np.asarray(c.phi.c[b]),
            "alpha": np.asarray(c.alpha[b]), "ax": np.asarray(c.ax[b]),
            "af": np.asarray(c.af[b]), "ak": np.asarray(c.ak[b]),
            "lkg_e": np.asarray(solver._lkg_phi[b].e), "lkg_c": np.asarray(solver._lkg_phi[b].c),
            "lkg_cost": np.float64(solver._lkg_cost[b]),
            "lkg_residual": np.float64(solver._lkg_residual[b]),
            "lkg_cert": np.bool_(solver._lkg_cert[b])}


def drive(part, solver, steps, *, cold=False, states=(), pick_edge=None) -> dict:
    """Run ``steps`` (a list of event batches) through ``solver``: per event
    the report, the gate residuals, the re-armed cost, the member's carry
    after it, the stored state before it (``states``) and, with ``cold``,
    the cold accelerated solve of the post-event instance."""
    from repro.core import gp

    out, events_js, per_event = {}, [], []
    t = 0
    for batch in steps:
        for ev in batch:
            if pick_edge is not None and ev is None:
                ev = pick_edge(solver)
            b = ev.member
            if t in states:
                for k, v in member_state(solver, b).items():
                    out[f"{part}/state/{t:02d}/{k}"] = v
            solver.gates.clear()
            solver.resets.clear()
            n_seg = len(solver.segments)
            rep = solver.process(ev)
            c = solver.carry
            row = {"report": report_dict(rep), "gate_residual": solver.gates[0].tolist(),
                   "reset_cost": solver.resets[0],
                   "segments": list(range(n_seg, len(solver.segments))),
                   "after": {"done": bool(c.done[b]), "stall": int(c.stall[b]),
                             "iters": int(c.iters[b]), "residual": float(c.residual[b]),
                             "cost": float(c.cost[b])}}
            if cold:
                r = gp.solve(solver.member(b), alpha=ALPHA, tol=TOL, accel=True)
                row["cold"] = {"cost": r.final_cost, "iterations": int(r.iterations)}
            events_js.append(event_dict(ev))
            per_event.append(row)
            print(f"{part} {t}: {type(ev).__name__} m{b} {rep.status} it={rep.iterations} "
                  f"rungs={rep.rungs} cold={row.get('cold')}", flush=True)
            t += 1
    return out, events_js, per_event


def pack(part, solver, out, js) -> dict:
    """The run's segments into ``out`` and its JSON under ``<part>/json``."""
    import numpy as np

    segs = []
    for n, s in enumerate(solver.segments):
        for k, v in s["cols"].items():
            out[f"{part}/seg/{n:03d}/{k}"] = v
        segs.append({k: v for k, v in s.items() if k != "cols"})
    js["segments"] = segs
    js["total_iters"] = int(solver.total_iters)
    js["event_iters"] = int(solver.event_iters)
    js["cold_iters"] = np.asarray(solver.cold_iters).astype(int).tolist()
    js["ladder_hits"] = dict(solver.ladder_hits)
    js["quarantines"] = int(solver.quarantines)
    js["final_health"] = [dataclasses.asdict(h) for h in solver.verify_fleet()]
    out[f"{part}/json"] = np.array(json.dumps(js))
    return out


def fleet(p):
    from repro.core import network

    return [network.table_ii_instance(p["scenario"], seed=p["seed"], rate_scale=s)
            for s in p["scales"]]


def run_part(part: str) -> tuple[dict, dict]:
    """(arrays, anchors) of one part."""
    import numpy as np

    from repro.core import events, faults, network, traffic

    p = RUNS[part]
    anchors = {}
    if part == "seq":
        inst = network.table_ii_instance(p["scenario"], seed=p["seed"],
                                         rate_scale=p["rate_scale"])
        solver = recording_solver([inst], **p["solver"])

        def busiest(s):
            F = np.asarray(traffic.flows(s.member(0), s.phi(0)).F)
            i, j = (int(x) for x in np.unravel_index(F.argmax(), F.shape))
            return events.LinkDown(member=0, i=i, j=j)
        seq = [events.RateScale(member=0, factor=1.8, app=0),
               events.RateScale(member=0, factor=2.0), None,
               events.RateScale(member=0, factor=0.5)]
        out, evs, rows = drive(part, solver, [seq], cold=True, pick_edge=busiest)
        js = {"events": evs, "per_event": rows}
    elif part in ("trace50", "chaos100"):
        insts = fleet(p)
        members = events.pad_fleet(insts, spare_apps=p["spare_apps"])
        if part == "trace50":
            trace = events.random_trace(members, n_events=p["n_events"], seed=p["seed"])
            steps = [trace]
            kw = dict(p["solver"])
        else:
            steps = faults.chaos_trace(members, n_events=p["n_events"], seed=p["seed"])
            injector = faults.FaultInjector(**p["injector"])
            kw = dict(p["solver"], fault_injector=injector)
        solver = recording_solver(insts, spare_apps=p["spare_apps"], **kw)
        t0 = time.perf_counter()
        out, evs, rows = drive(part, solver, steps, cold=part == "trace50",
                               states=STATE_EVENTS if part == "trace50" else ())
        js = {"events": evs, "per_event": rows, "seconds": time.perf_counter() - t0}
        statuses = {}
        for r in rows:
            statuses[r["report"]["status"]] = statuses.get(r["report"]["status"], 0) + 1
        if part == "trace50":
            cold = sum(r["cold"]["iterations"] for r in rows)
            signed = [(r["report"]["cost"] - r["cold"]["cost"]) / max(1.0, abs(r["cold"]["cost"]))
                      for r in rows]
            anchors = {"fig6-trace50": {
                "online_iters": int(solver.event_iters), "cold_accel_iters": int(cold),
                "iter_ratio": solver.event_iters / max(cold, 1),
                "max_rel_dcost": max(0.0, max(signed)),
                "gate_hits": sum(1 for r in rows if r["report"]["iterations"] == 0
                                 or r["report"]["skipped_apps"] > 0),
                "statuses": statuses}}
        else:
            js["steps"] = [[event_dict(ev) for ev in batch] for batch in steps]
            js["injections"] = [dataclasses.asdict(i) for i in injector.log]
            anchors = {"chaos-trace100": {
                "online_iters": int(solver.event_iters), "events": len(rows),
                "steps": len(steps), "statuses": statuses,
                "ladder_hits": dict(solver.ladder_hits), "injections": len(injector.log),
                "quarantines": int(solver.quarantines),
                "rollbacks": sum(1 for r in rows if r["report"]["rolled_back"])}}
    elif part == "budget":
        inst = network.table_ii_instance(p["scenario"], seed=p["seed"],
                                         rate_scale=p["rate_scale"])
        solver = recording_solver([inst], **p["solver"])
        out, evs, rows = drive(part, solver, [[event_from_dict(p["event"])]])
        js = {"events": evs, "per_event": rows}
    else:
        inst = network.table_ii_instance(p["scenario"], seed=p["seed"],
                                         rate_scale=p["rate_scale"])
        out, js = {}, {"modes": {}}
        for mode in p["modes"]:
            inj = faults.FaultInjector(modes=(mode,), **p["injector"])
            solver = recording_solver([inst], fault_injector=inj, **p["solver"])
            o, evs, rows = drive(f"{part}/{mode}", solver, [[event_from_dict(p["event"])]])
            sub = {"events": evs, "per_event": rows,
                   "injections": [dataclasses.asdict(i) for i in inj.log]}
            pack(f"{part}/{mode}", solver, o, sub)
            out.update(o)
        return out, anchors
    return pack(part, solver, out, js), anchors


def main(parts) -> None:
    import jax
    import numpy as np

    for part in parts:
        if part not in PARTS:
            raise SystemExit(f"unknown part {part!r}; want one of {PARTS}")
        t0 = time.perf_counter()
        new, anchors = run_part(part)
        old, meta = {}, {}
        if os.path.exists(OUT):
            with np.load(OUT) as z:
                old = {k: z[k] for k in z.files}
            meta = json.loads(str(old.pop("meta", "{}")))
        keep = {k: v for k, v in old.items() if k.split("/")[0] != part}
        keep.update(new)
        meta.update({"runs": RUNS, "state_events": STATE_EVENTS,
                     "jax_version": jax.__version__})
        meta.setdefault("anchors", {}).update(anchors)
        meta.setdefault("seconds", {})[part] = time.perf_counter() - t0
        keep["meta"] = np.array(json.dumps(meta))
        np.savez_compressed(OUT, **keep)
        print(f"wrote {OUT} part {part} in {time.perf_counter() - t0:.1f} s "
              f"({os.path.getsize(OUT)} bytes)", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:] or PARTS)
