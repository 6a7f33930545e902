"""Time a solve path from several source trees on one CUDA card, each tree
in its own process.

    python3 scripts/compare_solve.py TREE [TREE ...] [--what solve] [--rounds 2] [--reps 5]
                                     [--profile]

Each TREE is a checkout root holding ``src/repro_torch``; kernels build
into its own ``build/``.  The trees run in the order given and then back
(A B B A for two trees), ``--rounds`` times, so a drift of the card's clocks
falls on both.  Each run warms up once, then times ``--reps`` runs with the
host clock around a device sync, and prints one JSON line:

  * ``--what solve`` (the default): ``gp.solve`` of
    ``network.table_ii_instance("sw-queue")`` at ``alpha=0.1,
    max_iters=400`` (the settings of ``chip_smoke.py``'s ``solve`` phase):
    wall ms per step of each rep (the steps the solve ran: its iterations
    rounded up to whole chunks) and their median;
  * ``--what metro`` / ``dense300``: 32 steps of ``gp.solve`` with the
    stall latch off on ``network.metro_instance("sw", 1000)`` (the sparse
    route; ``chip_smoke.py``'s ``metro_profile`` chunk) or on
    ``without_sparse(metro_instance("sw", 300))`` (the dense route at
    V = 300): wall ms per step;
  * ``--what fig6``: the batched GP sweep ``scenarios.run_sweep`` of
    ``fig6-congestion`` (6 members, ``max_iters=300``, ``alpha=0.1``): wall
    seconds of each rep;
  * ``--what fig6-accel`` / ``ensemble-accel``: the batched accelerated
    sweep ``scenarios.run_sweep(..., accel=True)`` of ``fig6-congestion``
    (6 members, ``max_iters=300``) or ``seed-ensemble`` (32 members,
    ``max_iters=250``), ``alpha=0.1`` (the settings of the golden sweep
    file): wall seconds of each rep, their median, and the members'
    iterations (the same in every tree unless the trajectories differ);
  * ``--what ensemble-accel-steps``: the same 32 members padded into one
    batch, ``gp.solve_batched`` with acceleration, every latch off (no
    compaction, ``residual_stop`` off) for 64 steps: wall ms per step, the
    cost of one accelerated step whatever the trajectories.

Every line but the last kind's carries ``cost_sha256``, the sha256 of the
cost histories' float32 bytes (each member's, in order): two trees whose
trajectories are the same bit for bit print the same digest.  With
``--profile`` the solve, metro, dense300 and fig6 lines also give
``torch.profiler``'s device ms and kernel launches per step over 32 steps
with the latch off (the sweep: 32 batched steps of the padded family).
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

SWEEPS = {"fig6": ("fig6-congestion", 300, False), "fig6-accel": ("fig6-congestion", 300, True),
          "ensemble-accel": ("seed-ensemble", 250, True)}
STEPS = 64
PROFILE_STEPS = 32


def _digest(histories) -> str:
    import numpy as np

    h = hashlib.sha256()
    for c in histories:
        h.update(np.asarray(c.detach().cpu() if hasattr(c, "detach") else c,
                            dtype=np.float32).tobytes())
    return h.hexdigest()


def _profile(run, steps):
    """(device ms, kernel launches) per step of ``run`` (a warm-up first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(ev.self_device_time_total for ev in dev) / 1e3 / steps,
            sum(ev.count for ev in dev) / steps)


def child(tree: str, what: str, reps: int, with_profile: bool) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.core import gp, network, scenarios

    prof_run = None
    if what in SWEEPS:
        name, max_iters, accel = SWEEPS[what]
        fam = scenarios.expand(name)

        def run():
            return scenarios.run_sweep(fam, alpha=0.1, max_iters=max_iters, accel=accel)
        if what == "fig6":
            from repro_torch.core import batch

            binst = batch.pad_instances([sc.instance for sc in fam])

            def prof_run():
                return gp.solve_batched(binst, alpha=0.1, max_iters=PROFILE_STEPS, tol=-1.0,
                                        patience=10**6)
    elif what == "ensemble-accel-steps":
        from repro_torch.core import batch, engine

        binst = batch.pad_instances([sc.instance for sc in scenarios.expand("seed-ensemble")])
        acc = engine.AccelConfig(residual_stop=False)

        def run():
            return gp.solve_batched(binst, alpha=0.1, max_iters=STEPS, tol=-1.0,
                                    patience=10**6, compact=False, accel=acc)
    elif what in ("metro", "dense300"):
        inst = (network.metro_instance("sw", 1000) if what == "metro"
                else network.without_sparse(network.metro_instance("sw", 300)))
        phi0 = gp.init_phi(inst)

        def run():
            return gp.solve(inst, phi0, alpha=0.1, max_iters=PROFILE_STEPS, patience=10**6,
                            tol=0.0)
        prof_run = run
    else:
        inst = network.table_ii_instance("sw-queue")
        phi0 = gp.init_phi(inst)

        def run():
            return gp.solve(inst, alpha=0.1, max_iters=400)

        def prof_run():
            return gp.solve(inst, phi0, alpha=0.1, max_iters=PROFILE_STEPS, patience=10**6,
                            tol=0.0)
    res = run()                                          # build, warm up
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    extra = {}
    if with_profile and prof_run is not None:
        dev_ms, launches = _profile(prof_run, PROFILE_STEPS)
        extra = {"device_ms_per_step": dev_ms, "device_launches_per_step": launches}
    if what == "ensemble-accel-steps":
        print(json.dumps({"tree": tree, "what": what, "steps": STEPS,
                          "ms_per_step": [t / STEPS for t in ms],
                          "median_ms_per_step": statistics.median(ms) / STEPS}), flush=True)
        return
    if what in SWEEPS:
        print(json.dumps({"tree": tree, "what": what,
                          "iterations": [r.iterations for r in res.results],
                          "final_costs": [r.final_cost for r in res.results],
                          "cost_sha256": _digest(r.cost_history for r in res.results),
                          "seconds": [t / 1e3 for t in ms],
                          "median_seconds": statistics.median(ms) / 1e3, **extra}), flush=True)
        return
    if what in ("metro", "dense300"):
        steps = PROFILE_STEPS
    else:
        steps = min(400, -(-res.iterations // gp._SOLVE_CHUNK) * gp._SOLVE_CHUNK)
    ms = [t / steps for t in ms]
    print(json.dumps({"tree": tree, "what": what, "iterations": res.iterations, "steps": steps,
                      "final_cost": res.final_cost,
                      "cost_sha256": _digest([res.cost_history]), "ms_per_step": ms,
                      "median_ms_per_step": statistics.median(ms), **extra}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--what", choices=("solve", "metro", "dense300", *SWEEPS,
                                       "ensemble-accel-steps"), default="solve")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0], args.what, args.reps, args.profile)
        return 0
    order = (args.trees + args.trees[::-1]) * args.rounds
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              "--what", args.what, "--reps", str(args.reps), tree]
                             + (["--profile"] if args.profile else []))
        if out.returncode:
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
