"""Time ``gp.solve`` on sw-queue, the dense main path, from several source
trees on one CUDA card, each tree in its own process.

    python3 scripts/compare_solve.py TREE [TREE ...] [--rounds 2] [--reps 5]

Each TREE is a checkout root holding ``src/repro_torch``; kernels build
into its own ``build/``.  The trees run in the order given and then back
(A B B A for two trees), ``--rounds`` times, so a drift of the card's clocks
falls on both.  Each run warms up with one solve, then times ``--reps``
solves of ``network.table_ii_instance("sw-queue")`` at ``alpha=0.1,
max_iters=400`` (the settings of ``chip_smoke.py``'s ``solve`` phase) with
the host clock around a device sync, and prints one JSON line: wall ms per
step of each rep (the steps the solve ran: its iterations rounded up to
whole chunks) and their median.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def child(tree: str, reps: int) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.core import gp, network

    inst = network.table_ii_instance("sw-queue")
    res = gp.solve(inst, alpha=0.1, max_iters=400)       # build, warm up
    steps = min(400, -(-res.iterations // gp._SOLVE_CHUNK) * gp._SOLVE_CHUNK)
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp.solve(inst, alpha=0.1, max_iters=400)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / steps)
    print(json.dumps({"tree": tree, "iterations": res.iterations, "steps": steps,
                      "final_cost": res.final_cost, "ms_per_step": ms,
                      "median_ms_per_step": statistics.median(ms)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0], args.reps)
        return 0
    order = (args.trees + args.trees[::-1]) * args.rounds
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              "--reps", str(args.reps), tree])
        if out.returncode:
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
