"""Regenerate ``torch_ref_sweep.npz``, the JAX reference's evaluation sweeps.

The PyTorch port's sweep tests (``tests/test_torch_sweep.py``) and the
``sweep`` phases of ``chip_smoke.py`` hold every member of the port's
batched sweeps against this file.  The reference solves each family as
``scenarios.run_sweep`` does (grouped by cost kinds and the pow2 size
class of V, padded with ``batch.pad_instances``, baseline masks computed
on the padded batch, one ``gp.solve_batched`` per group), with
``solver="dense"`` (its ``batched_lu`` route aborts in XLA on the CPU at
V >= 22) and with the telemetry ring on, so that every latch of the stop
test can be replayed from the file: per member the cost and residual
histories, and per committed iteration the winning stepsize, rung,
Anderson acceptance and the largest strategy move.

Parts (each rewrites its own keys of the file and keeps the others):

  * ``fig6``       — ``fig6-congestion`` (Abilene, six rate scales),
                     ``alpha=0.1, max_iters=300``: GP, GP with
                     ``accel=True``, SPOC, LCOF; GP through
                     ``run_sweep_chained`` (warm starts, ``GP-chained``);
                     GP with ``accel=True`` through ``run_sweep_serial``
                     (``GP-accel-serial``: where the reference's own
                     batched and serial accelerated solves part);
  * ``fig5-small`` — the six ``SMALL_TABLE_II`` members of ``fig5``,
                     ``alpha=0.1, max_iters=250``: GP, SPOC, LCOF;
  * ``fig5-sw``    — the V=100 pair (sw-linear, sw-queue), same settings;
  * ``fig7``       — ``fig7-packetsize`` (Abilene at five input packet
                     sizes, ``benchmarks/fig7_packetsize.py``), ``alpha=0.1,
                     max_iters=300``: GP, SPOC, LCOF;
  * ``ensemble``   — ``seed-ensemble`` (32 Abilene seeds at rate 2.0,
                     ``benchmarks/fig5_scenarios.py``
                     ``run_ensemble_speedup``), ``alpha=0.1,
                     max_iters=250``: GP and GP with ``accel=True``;
  * ``mixed``      — ``mixed-topology`` (the six small Table II networks,
                     seeds 0 and 1, rate 1.5), ``alpha=0.1, max_iters=250``:
                     GP, SPOC, LCOF;
  * ``fig6-serial``, ``fig5-small-serial``, ``fig7-serial``,
                     ``ensemble-serial``, ``mixed-serial`` — the solvers of
                     those families (``ensemble``: GP and GP-accel; the
                     others GP, SPOC and LCOF) through ``run_sweep_serial`` (one
                     ``gp.solve`` per member, masks on the unpadded
                     instance), under the solver names with ``-serial``
                     appended: the reference's own batched and serial runs
                     of one member are the second measure of how far the
                     reference fixes that member's end point;
  * ``<part>-budget`` — the batched solves of ``<part>`` with the stall
                     latch off (``patience=max_iters``), under the solver
                     names with ``-budget`` appended: where the reference's
                     own solve goes when it is not stopped for want of
                     progress, the lowest end point a run that stops later
                     than the reference's may reach;
  * ``<part>-sparse`` — the same solves (not the chained one) through the
                     reference's other stage solver, ``solver="sparse"``
                     (the members carry ``network.with_sparse``), under the
                     solver names with ``-sparse`` appended: where the two
                     reference runs of one member part by more than float32
                     rounding, the reference does not fix that member's
                     trajectory to 1e-5 itself (see ``tests/_torch_cases.py``
                     ``sweep_parity``).

Run from the repository root, on the CPU (all parts by default):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_ref_sweep.py [part ...]
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_ref_sweep.npz")

FIG6 = {"sweep": "fig6-congestion", "alpha": 0.1, "max_iters": 300}
FIG5 = {"sweep": "fig5", "alpha": 0.1, "max_iters": 250}
FIG7 = {"sweep": "fig7-packetsize", "alpha": 0.1, "max_iters": 300}
ENSEMBLE = {"sweep": "seed-ensemble", "alpha": 0.1, "max_iters": 250}
MIXED = {"sweep": "mixed-topology", "alpha": 0.1, "max_iters": 250}
# Each figure's settings (the file's "meta") and the parts' key prefixes.
FIGS = {"fig6": FIG6, "fig5": FIG5, "fig7": FIG7, "ensemble": ENSEMBLE, "mixed": MIXED}
SOLVER = "dense"
PARTS = ("fig6", "fig5-small", "fig5-sw",
         "fig6-sparse", "fig5-small-sparse", "fig5-sw-sparse",
         "fig6-serial", "fig5-small-serial",
         "fig6-budget", "fig5-small-budget", "fig5-sw-budget",
         "fig7", "fig7-sparse", "fig7-serial", "fig7-budget",
         "ensemble", "ensemble-sparse", "ensemble-serial", "ensemble-budget",
         "mixed", "mixed-sparse", "mixed-serial", "mixed-budget")
# Telemetry columns kept per committed iteration (repro.obs.device).
TEL_COLUMNS = ("alpha", "rung", "anderson", "phi_delta")


def _family(part: str):
    from repro.core import network, scenarios

    base = part.removesuffix("-sparse").removesuffix("-serial").removesuffix("-budget")
    if base in FIGS:
        fam = scenarios.expand(FIGS[base]["sweep"])
    else:
        small = base == "fig5-small"
        fam = [sc for sc in scenarios.expand(FIG5["sweep"])
               if (sc.label in scenarios.SMALL_TABLE_II) == small]
    if part.endswith("-sparse"):
        fam = [scenarios.Scenario(sc.label, network.with_sparse(sc.instance),
                                  sc.meta) for sc in fam]
    return fam


def reference_sweep(family, masks_fn, *, alpha, max_iters, accel=None,
                    solver=SOLVER, patience=40):
    """``scenarios.run_sweep``'s grouping and ``solve_family``'s padding,
    with the telemetry ring on; returns {label: dict of numpy arrays}."""
    import jax
    import numpy as np

    from repro.core import batch, gp
    from repro.obs.device import COLUMNS, TelemetryConfig

    tel = TelemetryConfig(ring=max_iters, bs_rounds=False)
    groups: dict = {}
    for sc in family:
        key = sc.kinds + (batch.next_pow2(sc.instance.V),)
        groups.setdefault(key, []).append(sc)
    out = {}
    for scs in groups.values():
        insts = [sc.instance for sc in scs]
        binst = batch.pad_instances(insts)
        kw = {}
        phi0 = None
        if masks_fn is not None:
            allowed_e, allowed_c, phi0 = jax.vmap(masks_fn)(binst)
            kw = {"allowed_e": allowed_e, "allowed_c": allowed_c}
        scan = gp.solve_batched(binst, phi0, alpha=alpha, max_iters=max_iters,
                                solver=solver, accel=accel, telemetry=tel,
                                patience=patience, **kw)
        for b, sc in enumerate(scs):
            n = int(scan.iterations[b])
            ring = np.asarray(scan.telemetry[b])[:n]
            rec = {
                "iterations": np.int32(n),
                "cost_history": np.asarray(scan.cost_history[b, :n + 1],
                                           np.float32),
                "residual_history": np.asarray(scan.residual_history[b, :n],
                                               np.float32),
            }
            for col in TEL_COLUMNS:
                rec[col] = ring[:, COLUMNS.index(col)].astype(np.float32)
            out[sc.label] = rec
    return out


def reference_one_by_one(family, *, alpha, max_iters, chained, accel=None,
                         masks_fn=None):
    """``scenarios.run_sweep_chained`` (``chained``) or ``run_sweep_serial``,
    telemetry on: {label: dict of arrays}."""
    import numpy as np

    from repro.core import scenarios
    from repro.obs.device import COLUMNS, TelemetryConfig

    run = scenarios.run_sweep_chained if chained else scenarios.run_sweep_serial
    res = run(family, alpha=alpha, max_iters=max_iters, solver=SOLVER, accel=accel,
              masks_fn=masks_fn, telemetry=TelemetryConfig(ring=max_iters, bs_rounds=False))
    out = {}
    for sc, r in zip(res.scenarios, res.results):
        n = int(r.iterations)
        ring = np.asarray(r.telemetry)[:n]
        rec = {"iterations": np.int32(n),
               "cost_history": np.asarray(r.cost_history, np.float32),
               "residual_history": np.asarray(r.residual_history, np.float32)}
        for col in TEL_COLUMNS:
            rec[col] = ring[:, COLUMNS.index(col)].astype(np.float32)
        out[sc.label] = rec
    return out


def run_part(part: str) -> dict:
    from repro.core import baselines

    fig = part.split("-")[0]
    sparse = part.endswith("-sparse")
    serial = part.endswith("-serial")
    budget = part.endswith("-budget")
    params = FIGS[fig]
    family = _family(part)
    kw = {"alpha": params["alpha"], "max_iters": params["max_iters"]}
    solvers = {"GP": (None, None)}
    # Fig. 6's accelerated serial run is the "fig6" part's GP-accel-serial
    if fig == "ensemble" or (fig == "fig6" and not serial):
        solvers["GP-accel"] = (None, True)
    if fig != "ensemble":
        solvers["SPOC"] = (baselines.BASELINE_MASKS["SPOC"], None)
        solvers["LCOF"] = (baselines.BASELINE_MASKS["LCOF"], None)
    arrays = {}
    for name, (masks_fn, accel) in solvers.items():
        t0 = time.perf_counter()
        if serial:
            name += "-serial"
            recs = reference_one_by_one(family, chained=False, accel=accel,
                                        masks_fn=masks_fn, **kw)
        else:
            name += "-sparse" if sparse else "-budget" if budget else ""
            recs = reference_sweep(family, masks_fn, accel=accel,
                                   solver="sparse" if sparse else SOLVER,
                                   patience=params["max_iters"] if budget else 40,
                                   **kw)
        print(f"{part} {name}: {time.perf_counter() - t0:.1f} s, iterations "
              + " ".join(f"{k}={int(v['iterations'])}" for k, v in recs.items()),
              flush=True)
        for label, rec in recs.items():
            for field, val in rec.items():
                arrays[f"{fig}/{name}/{label}/{field}"] = val
    if part == "fig6":
        for name, chained, accel in (("GP-chained", True, None),
                                     ("GP-accel-serial", False, True)):
            t0 = time.perf_counter()
            recs = reference_one_by_one(family, chained=chained, accel=accel, **kw)
            print(f"fig6 {name}: {time.perf_counter() - t0:.1f} s, iterations "
                  + " ".join(f"{k}={int(v['iterations'])}" for k, v in recs.items()),
                  flush=True)
            for label, rec in recs.items():
                for field, val in rec.items():
                    arrays[f"fig6/{name}/{label}/{field}"] = val
    return arrays


def main(parts) -> None:
    import jax
    import numpy as np

    for part in parts:
        if part not in PARTS:
            raise SystemExit(f"unknown part {part!r}; want one of {PARTS}")
        t0 = time.perf_counter()
        new = run_part(part)
        old = {}
        if os.path.exists(OUT):
            with np.load(OUT) as z:
                old = {k: z[k] for k in z.files}
        # the part rewrites its own (figure, solver, member) keys
        mine = {tuple(k.split("/")[:3]) for k in new}
        keep = {k: v for k, v in old.items()
                if k != "meta" and tuple(k.split("/")[:3]) not in mine}
        keep.update(new)
        meta = {**FIGS, "solver": SOLVER,
                "jax_version": jax.__version__,
                "tel_columns": list(TEL_COLUMNS)}
        keep["meta"] = np.array(json.dumps(meta))
        np.savez_compressed(OUT, **keep)
        print(f"wrote {OUT} part {part} in {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:] or PARTS)
