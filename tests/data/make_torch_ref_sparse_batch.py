"""Regenerate ``torch_ref_sparse_batch.npz``, the JAX reference's batched
sparse solves.

The PyTorch port's sparse batching (``tests/test_torch_sparse_batch.py``) and
the ``sparse_batch`` phase of ``chip_smoke.py`` hold the port against this
file.  Every solve runs the reference's sparse route (``solver="sparse"``)
with the stall latch and the residual stop off (``patience=10**6,
tol=0.0``), so the histories have a fixed length; ``traffic.AUTO_MIN_V``
is raised so that the measurements the reference makes on "auto" (a
solve's initial cost) do not take its ``batched_lu`` route, whose
factorization aborts in XLA on the CPU.  Parts:

  * ``sw100`` — three members of one topology,
    ``_torch_cases.sparse_family("sw", 100, seeds=(0, 1, 2))``;
  * ``mixed`` — ``sparse_family`` over (sw, 0), (geant, 0), (sw, 1): two
    topologies, so the members' neighbor and block lists differ.

For each: ``<part>/batched/cost`` (B, STEPS + 1) and
``<part>/batched/iterations`` from ``gp.solve_batched`` on
``batch.pad_instances(family)``, and ``<part>/serial/cost`` from
``gp.solve`` member by member (on the padded member, so the two see the
same instance).

  * ``geant1000`` — ``metro_instance("geant", 1000, seed=0)``, 32 steps:
    ``geant1000/cost`` and ``geant1000/phi_c`` (A, K1, V), the companion of
    ``torch_ref_metro_sw1000.npz``'s latch-off run.

Run from the repository root, on the CPU (all parts by default, about four
minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_ref_sparse_batch.py [part ...]

A part rewrites only its own keys.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_ref_sparse_batch.npz")

ALPHA, STEPS, METRO_STEPS = 0.1, 16, 32
FAMILIES = {"sw100": (("sw", 0), ("sw", 1), ("sw", 2)),
            "mixed": (("sw", 0), ("geant", 0), ("sw", 1))}
PARTS = ("sw100", "mixed", "geant1000")


def run_family(part: str) -> dict:
    import numpy as np

    from _torch_cases import sparse_family
    from repro.core import batch, gp, network

    fam = sparse_family(network, FAMILIES[part], V=100)
    binst = batch.pad_instances(fam)
    kw = dict(alpha=ALPHA, max_iters=STEPS, patience=10**6, tol=0.0, solver="sparse")
    res = gp.solve_batched(binst, **kw)
    serial = [gp.solve(batch.instance_slice(binst, b), **kw) for b in range(len(fam))]
    return {f"{part}/batched/cost": np.asarray(res.cost_history, np.float32),
            f"{part}/batched/iterations": np.asarray(res.iterations, np.int64),
            f"{part}/serial/cost": np.stack([np.asarray(s.cost_history, np.float32)
                                             for s in serial])}


def run_geant() -> dict:
    import numpy as np

    from repro.core import gp, network, traffic

    inst = network.metro_instance("geant", 1000, seed=0)
    assert traffic.resolve_solver("auto", inst.V, inst) == "sparse"
    res = gp.solve(inst, alpha=ALPHA, max_iters=METRO_STEPS, patience=10**6, tol=0.0)
    return {"geant1000/cost": np.asarray(res.cost_history, np.float32),
            "geant1000/iterations": np.asarray(int(res.iterations), np.int64),
            "geant1000/phi_c": np.asarray(res.phi.c, np.float32)}


def main(parts) -> None:
    import jax
    import numpy as np

    from repro.core import traffic

    traffic.AUTO_MIN_V = 1 << 30
    out = dict(np.load(OUT)) if os.path.exists(OUT) else {}
    for part in parts:
        if part not in PARTS:
            raise SystemExit(f"unknown part {part!r}; want some of {PARTS}")
        out.update(run_geant() if part == "geant1000" else run_family(part))
        print(f"{part}: done", flush=True)
    out["meta/jax_version"] = np.asarray(jax.__version__)
    out["meta/alpha"] = np.asarray(ALPHA)
    out["meta/steps"] = np.asarray(STEPS)
    out["meta/metro_steps"] = np.asarray(METRO_STEPS)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.path[:0] = [os.path.join(HERE, "..", "..", "src"), os.path.join(HERE, "..")]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:] or PARTS)
