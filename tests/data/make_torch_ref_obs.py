"""Regenerate ``torch_ref_obs.npz``, the JAX reference's telemetry rings.

The PyTorch port's observability tests (``tests/test_torch_obs.py``) and
the ``telemetry`` phase of ``chip_smoke.py`` hold the port's iteration ring
against this file.  Every solve runs the reference's dense stage solver
(``solver="dense"``; its ``batched_lu`` route aborts in XLA on the CPU)
with the ring on, and each ring is stored whole (R, 8) beside its
iteration count (decode with ``obs.ring_valid(ring, iterations)``):

  * ``swq/*`` — sw-queue (``table_ii_instance("sw-queue")``),
    ``alpha=0.1``, the stall latch and the residual stop off
    (``patience=10**6, tol=0.0``) over the reference's default solve's
    count, 272 steps, ``TelemetryConfig(ring=512)``;
  * ``abilene/*`` — Abilene at ``rate_scale=2.0``, 30 steps, latch off,
    the default ring (``tests/test_obs.py``'s single-device instance);
  * ``batched/*`` — Abilene seeds 0, 1, 2 at scales 1.0, 1.5, 2.0, padded
    (``batch.pad_instances``) and solved by ``gp.solve_batched(alpha=0.1,
    max_iters=25, tol=1e-4)``: rings (3, 256, 8) and counts
    (``tests/test_obs.py``'s batched family).

Each also under ``<key>-sparse/*``: the same solve through the reference's
other stage solver (``solver="sparse"`` on ``network.with_sparse`` of the
instances), the reference's own spread, which bounds how far the port's
residual column may lie from the dense run's
(``_torch_cases.ring_parity``).  ``traffic.AUTO_MIN_V`` is raised so that
no measurement takes the reference's ``batched_lu`` route.

Run from the repository root, on the CPU (about eight minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_ref_obs.py
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_ref_obs.npz")

ALPHA = 0.1
SWQ_STEPS, SWQ_RING = 272, 512
ABILENE_STEPS = 30
BATCHED = (((0, 1.0), (1, 1.5), (2, 2.0)), 25, 1e-4)


def main() -> None:
    import jax
    import numpy as np

    from repro import obs
    from repro.core import batch, gp, network, traffic

    traffic.AUTO_MIN_V = 1 << 30
    out = {"meta/jax_version": np.asarray(jax.__version__)}
    for twin in ("", "-sparse"):
        prep = network.with_sparse if twin else (lambda inst: inst)
        latch_off = dict(alpha=ALPHA, patience=10**6, tol=0.0,
                         solver="sparse" if twin else "dense")

        res = gp.solve(prep(network.table_ii_instance("sw-queue")), max_iters=SWQ_STEPS,
                       telemetry=obs.TelemetryConfig(ring=SWQ_RING), **latch_off)
        out.update({f"swq{twin}/ring": np.asarray(res.telemetry, np.float32),
                    f"swq{twin}/iterations": np.asarray(int(res.iterations)),
                    f"swq{twin}/cost": np.asarray(res.cost_history, np.float32)})
        print(f"swq{twin}: done", flush=True)

        res = gp.solve(prep(network.table_ii_instance("abilene", seed=0, rate_scale=2.0)),
                       max_iters=ABILENE_STEPS, telemetry=True, **latch_off)
        out.update({f"abilene{twin}/ring": np.asarray(res.telemetry, np.float32),
                    f"abilene{twin}/iterations": np.asarray(int(res.iterations)),
                    f"abilene{twin}/cost": np.asarray(res.cost_history, np.float32)})

        members, steps, tol = BATCHED
        binst = batch.pad_instances([prep(network.table_ii_instance("abilene", seed=s,
                                                                    rate_scale=r))
                                     for s, r in members])
        res = gp.solve_batched(binst, alpha=ALPHA, max_iters=steps, tol=tol,
                               solver=latch_off["solver"], telemetry=True)
        out.update({f"batched{twin}/ring": np.asarray(res.telemetry, np.float32),
                    f"batched{twin}/iterations": np.asarray(res.iterations, np.int64),
                    f"batched{twin}/cost": np.asarray(res.cost_history, np.float32)})
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
