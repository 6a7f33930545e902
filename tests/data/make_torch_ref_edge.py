"""Regenerate ``torch_ref_edge.json``, the JAX reference's edge-serving chain
instance and its GP solve.

The instance: two applications, each a 2-segment vertical split
(``chain_from_arch``, 2048 tokens per packet) of internlm2-1.8b and of
mamba2-780m at full width, on Abilene, sources [[0, 2], [1, 5]] at rate 1.0
each, destinations [9, 10], link capacity 160, CPU capacity 0.005.  The
PyTorch port's ``chip_smoke.py`` (phase ``edge``) and
``tests/test_torch_chain.py`` hold the port against this file.  It holds

  * the two chains' ``L``/``w`` (float64, bit-exact) and the instance's
    fields;
  * the default solve (``alpha=0.1, max_iters=400``, ``solver="dense"``):
    its iteration count and cost history;
  * the solve with the stall latch and residual stop off over that count:
    its cost history, the winning ladder rung of every step (from the
    solve's telemetry), every iterate's strategy ``phi_e`` (n+1, A, K1, V,
    V) and ``phi_c`` (n+1, A, K1, V), and the costs of all 12 ladder rungs
    at every iterate (each rung evaluated by ``engine.gp_step`` alone).

The trajectory splits wherever two rungs tie in float32 (see ROADMAP
Queue 3): the per-iterate strategies let a port be held to the reference
step by step, from the reference's own iterates.  On this congested
instance GP does not converge (its sufficiency residual never falls below
0.4 against a tol of 1e-4; the cost swings between 2.5 and 5.1), so its
final cost is a point of an oscillation.  The file therefore also holds,
under ``steady``, the default solve of the same two chains with a CPU
capacity of 0.04: there the cost falls at every step for all 400
iterations, so a port's free-running solve can be held to the reference's
history and final cost.

Run from the repository root, on the CPU (about a minute and a half):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_ref_edge.py
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_ref_edge.json")

PARAMS = {
    "archs": ["internlm2-1.8b", "mamba2-780m"],
    "n_segments": 2, "tokens_per_packet": 2048, "flops_unit": 1e12, "bits_unit": 1e6,
    "topology": "abilene", "sources": [[0, 2], [1, 5]], "rates": [[1.0, 1.0], [1.0, 1.0]],
    "dests": [9, 10], "link_capacity": 160.0, "comp_capacity": 0.005,
    "alpha": 0.1, "max_iters": 400, "solver": "dense",
}
STEADY_COMP_CAPACITY = 0.04
FIELDS = ["adj", "link_param", "comp_param", "L", "w", "wnode", "r", "dst",
          "n_tasks", "stage_mask"]


def reference_instance(comp_capacity=PARAMS["comp_capacity"]):
    """(chains, instance) of the reference, from ``PARAMS``, at CPU capacity
    ``comp_capacity``."""
    from repro import configs
    from repro.core import chain, network

    p = PARAMS
    chains = [chain.chain_from_arch(configs.get(a), n_segments=p["n_segments"],
                                    tokens_per_packet=p["tokens_per_packet"],
                                    flops_unit=p["flops_unit"], bits_unit=p["bits_unit"])
              for a in p["archs"]]
    inst = chain.instance_from_chains(
        network.TOPOLOGIES[p["topology"]](), chains, sources=p["sources"],
        rates=p["rates"], dests=p["dests"], link_capacity=p["link_capacity"],
        comp_capacity=comp_capacity)
    return chains, inst


def ladder_costs(inst, phis, alpha):
    """Cost of each of the 12 ladder rungs at each of ``phis`` (inf where
    invalid): ``engine.gp_step`` with a one-rung ladder, compiled once per
    rung."""
    import jax
    from repro.core import engine

    ladder = engine.ALPHA_LADDER
    per_rung = []
    try:
        for mult in ladder:
            engine.ALPHA_LADDER = (mult,)
            step = jax.jit(lambda phi: engine.gp_step(inst, phi, alpha,
                                                      solver=PARAMS["solver"]).cost)
            per_rung.append([float(step(phi)) for phi in phis])
    finally:
        engine.ALPHA_LADDER = ladder
    return [list(row) for row in zip(*per_rung)]


def main() -> None:
    import jax
    import numpy as np

    from repro.core import gp
    from repro.obs import device as obs_device

    p = PARAMS
    chains, inst = reference_instance()
    kw = dict(alpha=p["alpha"], solver=p["solver"])
    default = gp.solve(inst, max_iters=p["max_iters"], **kw)
    n = int(default.iterations)
    off = gp.solve(inst, max_iters=n, patience=10**6, tol=0.0, telemetry=True, **kw)
    hist = np.asarray(off.cost_history)
    assert int(off.iterations) == n
    assert np.array_equal(hist, np.asarray(gp.solve(
        inst, max_iters=n, patience=10**6, tol=0.0, **kw).cost_history))
    ring = np.asarray(obs_device.ring_valid(off.telemetry, off.iterations))
    assert ring.shape[0] == n and np.array_equal(ring[:, obs_device.COL_ITER], np.arange(n))
    rungs = [int(r) for r in ring[:, obs_device.COL_RUNG]]

    phis = [gp.init_phi(inst)]
    for k in range(1, n + 1):
        res = gp.solve(inst, max_iters=k, patience=10**6, tol=0.0, **kw)
        assert np.array_equal(np.asarray(res.cost_history), hist[:k + 1])
        phis.append(res.phi)
    lad = ladder_costs(inst, phis[:n], p["alpha"])
    for k in range(n):
        assert abs(lad[k][rungs[k]] - hist[k + 1]) <= 1e-6 * abs(hist[k + 1]), k

    def f32(x):
        return np.asarray(x, dtype=np.float32).tolist()

    doc = dict(p)
    doc["jax_version"] = jax.__version__
    doc["chains"] = [{"name": c.name, "L": c.L.tolist(), "w": c.w.tolist()} for c in chains]
    doc["instance"] = {f: np.asarray(getattr(inst, f)).tolist() for f in FIELDS}
    doc["instance"]["link_kind"] = int(inst.link_kind)
    doc["instance"]["comp_kind"] = int(inst.comp_kind)
    doc["default"] = {"iterations": n,
                      "cost_history": [float(c) for c in np.asarray(default.cost_history)]}
    doc["latch_off"] = {
        "iterations": n, "cost_history": [float(c) for c in hist], "rungs": rungs,
        "ladder_costs": lad,
        "phi_e": [f32(ph.e) for ph in phis], "phi_c": [f32(ph.c) for ph in phis],
    }
    _, steady_inst = reference_instance(STEADY_COMP_CAPACITY)
    steady = gp.solve(steady_inst, max_iters=p["max_iters"], **kw)
    steady_hist = np.asarray(steady.cost_history, dtype=np.float64)
    assert int(steady.iterations) == p["max_iters"] and np.all(np.diff(steady_hist) < 0)
    doc["steady"] = {"comp_capacity": STEADY_COMP_CAPACITY,
                     "iterations": int(steady.iterations),
                     "cost_history": [float(c) for c in steady_hist],
                     "final_residual": float(np.asarray(steady.residual_history)[-1])}
    doc["default"]["final_residual"] = float(np.asarray(default.residual_history)[-1])
    with open(OUT, "w") as fh:
        json.dump(doc, fh, separators=(",", ":"))
        fh.write("\n")
    print(f"wrote {OUT}: {n} iterations, final cost {hist[-1]:.6f}, rungs {rungs}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
