"""Regenerate ``torch_ref_metro_sw1000.npz``, the JAX reference's metro solve.

The PyTorch port's ``chip_smoke.py`` holds its on-card metro solve against
this file: ``metro_instance("sw", 1000)``, which the reference sends down
its sparse path (``solver="auto"`` resolves to ``"sparse"`` at V >= 128
with the sparse topology attached).  The file holds

  * ``t0``/``pdt0``: stage traffic and ``dD/dt`` at ``init_phi``,
    (A, K1, V) float32 each;
  * the default solve (``alpha=0.1, max_iters=400``): its iteration count
    and cost history;
  * a 32-iteration solve with the stall latch and the residual stop off
    (``tol=0, patience=10**6``): its cost history and its final strategy,
    ``phi.e`` on the out-neighbor lists (A, K1, V, D) and ``phi.c``
    (A, K1, V), float32.  The instance is lightly loaded: the cost does not
    move in float32 over these steps, but the strategy does (in a few
    entries, by about 1e-4), so the strategy is what tells a step that
    moves it right from one that leaves it in place.

Run from the repository root, on the CPU (about a minute):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_ref_metro.py
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_ref_metro_sw1000.npz")

TOPO, V, SEED = "sw", 1000, 0
ALPHA, MAX_ITERS, LATCH_OFF_ITERS = 0.1, 400, 32


def main() -> None:
    import jax
    import numpy as np

    from repro.core import gp, marginals, network, traffic

    inst = network.metro_instance(TOPO, V, seed=SEED)
    assert traffic.resolve_solver("auto", inst.V, inst) == "sparse"
    nbr, mask = np.asarray(inst.out_nbr), np.asarray(inst.out_mask)
    phi0 = gp.init_phi(inst)
    m0 = marginals.marginals(inst, phi0)
    t0, _ = traffic.stage_traffic(inst, phi0)
    default = gp.solve(inst, phi0, alpha=ALPHA, max_iters=MAX_ITERS)
    latch_off = gp.solve(inst, phi0, alpha=ALPHA, max_iters=LATCH_OFF_ITERS,
                         patience=10**6, tol=0.0)
    e_nbr = np.take_along_axis(np.asarray(latch_off.phi.e),
                               np.broadcast_to(nbr, latch_off.phi.e.shape[:-1]
                                               + nbr.shape[-1:]), axis=-1)
    np.savez_compressed(
        OUT,
        topo=TOPO, V=V, seed=SEED, alpha=ALPHA, max_iters=MAX_ITERS,
        jax_version=jax.__version__,
        t0=np.asarray(t0, dtype=np.float32),
        pdt0=np.asarray(m0.pdt, dtype=np.float32),
        iterations=int(default.iterations),
        cost_history=np.asarray(default.cost_history, dtype=np.float32),
        latch_off_iterations=int(latch_off.iterations),
        latch_off_cost_history=np.asarray(latch_off.cost_history,
                                          dtype=np.float32),
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
