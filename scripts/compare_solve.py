"""Time a solve path from several source trees on one CUDA card, each tree
in its own process.

    python3 scripts/compare_solve.py TREE [TREE ...] [--what solve] [--rounds 2] [--reps 5]

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
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SWEEPS = {"fig6-accel": ("fig6-congestion", 300), "ensemble-accel": ("seed-ensemble", 250)}
STEPS = 64


def child(tree: str, what: str, reps: int) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.core import gp, network, scenarios

    if what in SWEEPS:
        name, max_iters = SWEEPS[what]
        fam = scenarios.expand(name)

        def run():
            return scenarios.run_sweep(fam, alpha=0.1, max_iters=max_iters, accel=True)
    elif what == "ensemble-accel-steps":
        from repro_torch.core import batch, engine

        binst = batch.pad_instances([sc.instance for sc in scenarios.expand("seed-ensemble")])
        acc = engine.AccelConfig(residual_stop=False)

        def run():
            return gp.solve_batched(binst, alpha=0.1, max_iters=STEPS, tol=-1.0,
                                    patience=10**6, compact=False, accel=acc)
    else:
        inst = network.table_ii_instance("sw-queue")

        def run():
            return gp.solve(inst, alpha=0.1, max_iters=400)
    res = run()                                          # build, warm up
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if what == "ensemble-accel-steps":
        print(json.dumps({"tree": tree, "what": what, "steps": STEPS,
                          "ms_per_step": [t / STEPS for t in ms],
                          "median_ms_per_step": statistics.median(ms) / STEPS}), flush=True)
        return
    if what in SWEEPS:
        print(json.dumps({"tree": tree, "what": what,
                          "iterations": [r.iterations for r in res.results],
                          "final_costs": [r.final_cost for r in res.results],
                          "seconds": [t / 1e3 for t in ms],
                          "median_seconds": statistics.median(ms) / 1e3}), flush=True)
        return
    steps = min(400, -(-res.iterations // gp._SOLVE_CHUNK) * gp._SOLVE_CHUNK)
    ms = [t / steps for t in ms]
    print(json.dumps({"tree": tree, "iterations": res.iterations, "steps": steps,
                      "final_cost": res.final_cost, "ms_per_step": ms,
                      "median_ms_per_step": statistics.median(ms)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--what", choices=("solve", *SWEEPS, "ensemble-accel-steps"),
                    default="solve")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0], args.what, args.reps)
        return 0
    order = (args.trees + args.trees[::-1]) * args.rounds
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              "--what", args.what, "--reps", str(args.reps), tree])
        if out.returncode:
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
