"""Regenerate ``torch_ref_dense_sw300.npz``, the JAX reference's dense solve
of ``without_sparse(metro_instance("sw", 300))``.

``chip_smoke.py``'s ``dense_scale`` phase (the port's dense route above the
kernels' shared-memory limits) and ``tests/test_torch_dense_scale.py`` hold
the port against this file.  The reference runs ``solver="dense"`` (its
``batched_lu`` path aborts in XLA on jax 0.9.0); the instance is the size
of ``benchmarks/gp_scaling.py``'s dense leg.  The file holds

  * ``t0``/``pdt0``: stage traffic and ``dD/dt`` at ``init_phi``,
    (A, K1, V) float32 each;
  * the default solve (``alpha=0.1, max_iters=400``): its iteration count
    and cost history;
  * a ``LATCH_OFF_ITERS``-iteration solve with the stall latch and the
    residual stop off (``tol=-1``: the instance's residual reaches 0 at its
    first step, so ``tol=0`` would stop there): its cost history and its final strategy, ``phi.e``
    on the out-neighbor lists (A, K1, V, D: the support entries, not the
    V x V arrays) and ``phi.c`` (A, K1, V), float32.

Run from the repository root, on the CPU (about a minute):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_ref_dense_scale.py
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_ref_dense_sw300.npz")

TOPO, V, SEED = "sw", 300, 0
ALPHA, MAX_ITERS, LATCH_OFF_ITERS = 0.1, 400, 8


def main() -> None:
    import jax
    import numpy as np

    from repro.core import gp, marginals, network, traffic

    sparse = network.metro_instance(TOPO, V, seed=SEED)
    nbr, mask = np.asarray(sparse.out_nbr), np.asarray(sparse.out_mask)
    inst = network.without_sparse(sparse)
    phi0 = gp.init_phi(inst)
    m0 = marginals.marginals(inst, phi0, solver="dense")
    t0, _ = traffic.stage_traffic(inst, phi0, solver="dense")
    default = gp.solve(inst, phi0, alpha=ALPHA, max_iters=MAX_ITERS, solver="dense")
    latch_off = gp.solve(inst, phi0, alpha=ALPHA, max_iters=LATCH_OFF_ITERS,
                         patience=10**6, tol=-1.0, solver="dense")
    e_nbr = np.take_along_axis(np.asarray(latch_off.phi.e),
                               np.broadcast_to(nbr, latch_off.phi.e.shape[:-1]
                                               + nbr.shape[-1:]), axis=-1)
    np.savez_compressed(
        OUT,
        topo=TOPO, V=V, seed=SEED, alpha=ALPHA, max_iters=MAX_ITERS, solver="dense",
        jax_version=jax.__version__,
        t0=np.asarray(t0, dtype=np.float32),
        pdt0=np.asarray(m0.pdt, dtype=np.float32),
        iterations=int(default.iterations),
        cost_history=np.asarray(default.cost_history, dtype=np.float32),
        latch_off_iterations=int(latch_off.iterations),
        latch_off_cost_history=np.asarray(latch_off.cost_history, dtype=np.float32),
        latch_off_phi_e_nbr=np.where(mask, e_nbr, 0.0).astype(np.float32),
        latch_off_phi_c=np.asarray(latch_off.phi.c, dtype=np.float32),
    )
    print(f"wrote {OUT}: default solve {int(default.iterations)} iterations, "
          f"latch-off {int(latch_off.iterations)}, final cost "
          f"{float(latch_off.cost_history[-1]):.6f}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
