#!/usr/bin/env python3
"""Replay the JAX reference from the port's own iterates on the known sweep
faults (``tests/_torch_cases.SWEEP_KNOWN_FAULTS``, ROADMAP Queue 3).

Two steps, because the machine with the card has no JAX:

    PYTHONPATH=src:tests python3 scripts/replay_known_faults.py dump [--device cuda] OUT.pt
    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python3 scripts/replay_known_faults.py replay OUT.pt

``dump`` (PyTorch only) runs, for every known fault of the device's type
(each a plain GP member, a float32 stall trap), the port's sweep of the
member's family the way the fault names (batched, or the member alone), and
saves its final strategy and cost history.

``replay`` (JAX on the CPU) starts the reference from each saved final
strategy for 60 plain ``gp_step``s: does the reference go on descending, or
stall too?  One JSON line per fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "..", "tests", "data", "torch_ref_sweep.npz")
REPLAY_STEPS = 60


def _member_run(fig, solver, way, label, device, z):
    """The port's run of one sweep member."""
    from repro_torch.core import baselines, scenarios

    params = json.loads(str(z["meta"]))[fig]
    fam = scenarios.expand(params["sweep"], device=device)
    kw = dict(alpha=params["alpha"], max_iters=params["max_iters"], record=True,
              masks_fn=baselines.BASELINE_MASKS.get(solver))
    i = [sc.label for sc in fam].index(label)
    res = (scenarios.run_sweep(fam, **kw) if way == "batched"
           else scenarios.run_sweep_serial([fam[i]], **kw))
    return res.results[i if way == "batched" else 0]


def dump(device: str, out: str) -> None:
    import numpy as np
    import torch
    from _torch_cases import SWEEP_KNOWN_FAULTS

    dev = torch.device(device)
    with np.load(GOLDEN) as zf:
        z = {k: zf[k] for k in zf.files}
    saved = {}
    for fig, solver, way, label in SWEEP_KNOWN_FAULTS[dev.type]:
        r = _member_run(fig, solver, way, label, device, z)
        saved[(fig, solver, way, label)] = {
            "iterations": r.iterations, "cost_history": r.cost_history.cpu(),
            "phi_e": r.phi.e.cpu(), "phi_c": r.phi.c.cpu()}
        print(json.dumps({"dumped": [fig, solver, way, label],
                          "iterations": r.iterations}), flush=True)
    torch.save({"device": str(dev), "faults": saved}, out)


def replay(path: str) -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch
    from _torch_cases import stall_stop
    from repro.core import gp as jgp
    from repro.core import scenarios as jsc
    from repro.core.traffic import Phi

    doc = torch.load(path, weights_only=False)
    with np.load(GOLDEN) as zf:
        meta = json.loads(str(zf["meta"]))
    for (fig, solver, way, label), e in doc["faults"].items():
        params = meta[fig]
        fam = jsc.expand(params["sweep"])
        inst = fam[[sc.label for sc in fam].index(label)].instance
        line = {"device": doc["device"], "fig": fig, "solver": solver, "way": way,
                "member": label, "port_iterations": e["iterations"],
                "port_final_cost": float(e["cost_history"][-1])}
        p = Phi(e=jnp.asarray(e["phi_e"].numpy()), c=jnp.asarray(e["phi_c"].numpy()))
        costs = [line["port_final_cost"]]
        for _ in range(REPLAY_STEPS):
            st = jgp.gp_step(inst, p, params["alpha"], solver="dense")
            p = st.phi
            costs.append(float(st.cost))
        h = np.asarray(costs)
        line.update(reference_steps=REPLAY_STEPS,
                    reference_descent_rel=float((h[0] - h[-1]) / h[0]),
                    reference_stall=stall_stop(h, max_iters=10**6)[0])
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--device", default="cuda")
    d.add_argument("out")
    r = sub.add_parser("replay")
    r.add_argument("path")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(HERE, "..", "src"), os.path.join(HERE, "..", "tests")]
    if args.cmd == "dump":
        dump(args.device, args.out)
    else:
        replay(args.path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
