"""Regenerate ``torch_ref_sw_queue.json``, the JAX reference's sw-queue solve.

The PyTorch port's ``chip_smoke.py`` holds its on-card solve against this
file: same iteration count, cost history within 1e-5 relative.  The
reference runs with ``solver="dense"`` (the per-stage ``jnp.linalg.solve``
path), which is the JAX package's differential reference.

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_ref.py
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_ref_sw_queue.json")

PARAMS = {"scenario": "sw-queue", "seed": 0, "rate_scale": 1.0,
          "alpha": 0.1, "max_iters": 400, "solver": "dense"}


def reference_solve(max_iters: int):
    """The reference's sw-queue solve, capped at ``max_iters`` iterations."""
    from repro.core import gp, network

    inst = network.table_ii_instance(PARAMS["scenario"], seed=PARAMS["seed"],
                                     rate_scale=PARAMS["rate_scale"])
    return gp.solve(inst, alpha=PARAMS["alpha"], max_iters=max_iters,
                    solver=PARAMS["solver"])


def main() -> None:
    import jax
    import numpy as np

    res = reference_solve(PARAMS["max_iters"])
    doc = dict(PARAMS)
    doc["jax_version"] = jax.__version__
    doc["iterations"] = int(res.iterations)
    doc["cost_history"] = [float(c) for c in np.asarray(res.cost_history)]
    with open(OUT, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {OUT}: {doc['iterations']} iterations, "
          f"final cost {doc['cost_history'][-1]:.6f}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
