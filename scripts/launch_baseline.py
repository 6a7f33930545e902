#!/usr/bin/env python3
"""Launches and trajectories of three main paths with telemetry off, on one card.

    python3 scripts/launch_baseline.py [--tree DIR] [--out FILE]

Runs the port of ``DIR/src`` (default: this checkout) on the card and
prints one JSON object (also written to ``FILE``) with, for each path,

  * ``sw-queue``: ``gp.solve(table_ii_instance("sw-queue"))``, 32 steps,
    ``alpha=0.1``, the stall latch and the residual stop off;
  * ``metro-sw``: the same on ``metro_instance("sw", 1000)``, 16 steps;
  * ``service``: the fig6 fleet (Abilene at the six Fig. 6 scales, two
    spare application slots) in ``OnlineSolver(alpha=0.1, tol=1e-4,
    accel=True)``, cold-started, then the first event of
    ``events.random_trace(n_events=50, seed=0)``;

the sha256 of the cost history (the served cost, the iteration count and
the member's strategy for the event) and of the final strategy, the
kernel launch counts per step (``ops.launch_counts``) and the PyTorch
operations the loop issues (every operator dispatched inside
``engine.scan_chunk``, counted by a ``TorchDispatchMode``; per step, or
over the event): each operator launches what it launches, so equal counts
and equal bits mean equal launches.  ``torch.profiler``'s device-kernel
count is not used: for the same code and the same bits it differed
between processes by up to 0.7% on the card.  Run on the parent commit's
tree it records what a change that claims to leave these paths alone must
reproduce: ``chip_smoke.py``'s ``telemetry`` phase measures the same with
this function and compares (``tests/data/torch_card_telemetry_off.json``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


class _Ops:
    """Counts the operators dispatched inside ``engine.scan_chunk`` while
    installed (a ``TorchDispatchMode`` entered around each call)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self._mode = 0, Mode

    def __enter__(self):
        from repro_torch.core import engine

        self._real = real = engine.scan_chunk
        mode = self._mode

        def counted(*a, **k):
            with mode():
                return real(*a, **k)

        engine.scan_chunk = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine

        engine.scan_chunk = self._real
        return False


def measure(telemetry=None) -> dict:
    """The three paths' record (module docstring).  ``telemetry`` is passed
    to the solves and the service where given (a tree that has it); None
    leaves the argument out, as a tree without it needs."""
    import torch
    from repro_torch.core import events, gp, network
    from repro_torch.kernels import ops
    from repro_torch.serve import OnlineSolver

    tele = {} if telemetry is None else {"telemetry": telemetry}
    out = {}
    for name, make, steps in (("sw-queue", lambda: network.table_ii_instance("sw-queue"), 32),
                              ("metro-sw", lambda: network.metro_instance("sw", 1000), 16)):
        inst = make()
        phi0 = gp.init_phi(inst)

        def run():
            return gp.solve(inst, phi0, alpha=0.1, max_iters=steps, patience=10**6, tol=0.0,
                            **tele)

        run()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with _Ops() as loop_ops:
            res = run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        out[name] = {"steps": steps, "cost_sha256": _sha(res.cost_history),
                     "phi_sha256": _sha(res.phi.e, res.phi.c),
                     "kernel_launches_per_step": {k: v / steps for k, v in counts.items() if v},
                     "loop_ops_per_step": loop_ops.n / steps}
        del inst, phi0, res

    scales = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)
    fleet = [network.table_ii_instance("abilene", seed=0, rate_scale=s) for s in scales]
    ev = events.random_trace(events.pad_fleet(fleet, spare_apps=2), n_events=50, seed=0)[0]
    solver = OnlineSolver(fleet, spare_apps=2, alpha=0.1, tol=1e-4, accel=True, **tele)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with _Ops() as loop_ops:
        rep = solver.process(ev)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    phi = solver.phi(ev.member)
    out["service"] = {"event": type(ev).__name__, "member": ev.member,
                      "iterations": rep.iterations, "status": rep.status,
                      "cost_hex": float(rep.cost).hex(), "phi_sha256": _sha(phi.e, phi.c),
                      "kernel_launches": {k: v for k, v in counts.items() if v},
                      "loop_ops": loop_ops.n}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(__file__), ".."),
                    help="the checkout whose src/repro_torch to run")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("launch_baseline: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    rec = {"tree": os.path.basename(os.path.abspath(args.tree)), "torch": torch.__version__,
           "card": torch.cuda.get_device_name(0), **measure()}
    text = json.dumps(rec, indent=1, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
