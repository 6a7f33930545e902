"""Seeded numpy inputs shared by the port's kernel tests (CPU and card)."""

import numpy as np


def stage_mats(rng, B, V, loopy=()):
    """(B, V, V) float32 stage systems I - Phi of random loop-free strategies.

    Each row of Phi spreads 0.3..1 of its mass over a few later nodes of a
    hidden order (a DAG), so I - Phi is a nonsingular M-matrix.  Members
    listed in ``loopy`` get a 2-cycle 0 <-> 1 carrying all of rows 0 and 1,
    which makes them singular.
    """
    phi = np.zeros((B, V, V))
    for b in range(B):
        for i in range(V - 1):
            js = rng.choice(np.arange(i + 1, V), size=min(3, V - 1 - i),
                            replace=False)
            phi[b, i, js] = rng.dirichlet(np.ones(len(js))) * rng.uniform(0.3, 1.0)
        perm = rng.permutation(V)
        phi[b] = phi[b][np.ix_(perm, perm)]
    for b in loopy:
        phi[b, 0, :] = 0.0
        phi[b, 1, :] = 0.0
        phi[b, 0, 1] = phi[b, 1, 0] = 1.0
    return (np.eye(V)[None] - phi).astype(np.float32)


def random_bits(rng, B, V, density):
    """Routing DAGs in a hidden node order, with a few improper links."""
    route = np.triu(rng.random((B, V, V)) < density, k=1)
    perm = rng.permutation(V)
    route = route[:, perm][:, :, perm]
    improper = route & (rng.random((B, V, V)) < 0.02)
    return route, improper


def stall_stop(costs, patience=40, max_iters=400):
    """Replay the solve loop's stall latch on a cost history.

    Returns ``(stop, improved)``: the iteration at which no improvement
    above 1e-6 relative for ``patience`` iterations (or the budget) ends
    the solve, or None, and the per-iteration improvement flags, computed
    in float32 as the loop computes them.
    """
    h = np.asarray(costs, dtype=np.float32)
    best, stall, improved = h[0], 0, []
    for i in range(1, len(h)):
        imp = bool(h[i] < best * np.float32(1 - 1e-6))
        improved.append(imp)
        best, stall = (h[i], 0) if imp else (best, stall + 1)
        if stall >= patience or i >= max_iters:
            return i, improved
    return None, improved


def with_loops(phi_e, r, out_nbr):
    """Ladder candidates (L, A, K1, V, V) with routing loops put into three
    members, the inputs the sparse chain's divergence latch and sweep cap
    are for.

    At application 0's largest source i and its first neighbor j, stage 0
    of rungs 1, 2 and 3 routes all of rows i and j around the 2-cycle
    i -> j -> i with gains 1 (never settles: runs to the cap), 0.5 (settles
    geometrically) and 1e3 (diverges past 1e12 and latches at +inf).
    Returns a new tensor.
    """
    e = phi_e.clone()
    i = int(r[0].argmax())
    j = int(out_nbr[i, 0])
    for rung, gain in ((1, 1.0), (2, 0.5), (3, 1e3)):
        e[rung, 0, 0, i, :] = 0.0
        e[rung, 0, 0, j, :] = 0.0
        e[rung, 0, 0, i, j] = gain
        e[rung, 0, 0, j, i] = 1.0
    return e


# The edge-serving chain instance's GP trajectory splits where two ladder
# rungs tie in float32; rung costs closer than this, relative, are a tie.
RUNG_TIE = 1e-6


def edge_step_parity(inst, lo, alpha):
    """Hold the port's GP step to the reference's from each of the
    reference's own latch-off iterates ``lo`` (``torch_ref_edge.json``'s
    ``latch_off``), on ``inst``'s device.

    At every iterate: all 12 rung costs within 1e-5 relative of the
    reference's (inf where inf), the step's cost within 1e-5 of the
    reference's next cost, the winning rung the reference's or tied with it
    in the reference's own rung costs (``RUNG_TIE``), and where the rungs
    agree the next strategy within 1e-5 per entry.  Returns the largest
    errors and the steps whose rung differs; the caller asserts.
    """
    import torch
    from repro_torch.core import engine
    from repro_torch.core.traffic import Phi

    dev = inst.device
    hist = np.asarray(lo["cost_history"], dtype=np.float64)
    out = {"ladder_max_rel": 0.0, "step_max_rel": 0.0, "phi_max_abs": 0.0,
           "inf_mismatch": 0, "rung_flips": [], "untied_flips": []}
    for k in range(lo["iterations"]):
        phi = Phi(e=torch.tensor(lo["phi_e"][k], device=dev),
                  c=torch.tensor(lo["phi_c"][k], device=dev))
        cands, _, _ = engine.ladder_candidates(inst, phi, alpha)
        costs = engine._strategy_cost(inst, cands)
        costs = torch.where(torch.isnan(costs), torch.inf, costs)
        r = int(torch.argmin(costs))
        got = costs.double().cpu().numpy()
        want = np.asarray(lo["ladder_costs"][k], dtype=np.float64)
        fin = np.isfinite(want)
        out["inf_mismatch"] += int((np.isfinite(got) != fin).sum())
        if fin.any():
            rel = np.abs(got[fin] - want[fin]) / np.abs(want[fin])
            out["ladder_max_rel"] = max(out["ladder_max_rel"], float(rel.max()))
        out["step_max_rel"] = max(out["step_max_rel"],
                                  abs(got[r] - hist[k + 1]) / abs(hist[k + 1]))
        rr = lo["rungs"][k]
        if r == rr:
            nxt_e = torch.tensor(lo["phi_e"][k + 1], device=dev)
            nxt_c = torch.tensor(lo["phi_c"][k + 1], device=dev)
            out["phi_max_abs"] = max(out["phi_max_abs"],
                                     float((cands.e[r] - nxt_e).abs().max()),
                                     float((cands.c[r] - nxt_c).abs().max()))
        else:
            out["rung_flips"].append(k)
            if abs(want[r] - want[rr]) > RUNG_TIE * abs(want[rr]):
                out["untied_flips"].append(k)
    return out


def free_run_split(costs, rungs, lo):
    """Where a free-running latch-off trajectory (``costs`` (n+1,), the
    winning ``rungs`` (n,)) leaves the reference's ``lo``.

    Returns ``(flip, tied, prefix_max_rel)``: the first step whose rung
    differs from the reference's (None if none), whether the reference's
    own costs of the two rungs tie there (``RUNG_TIE``), and the largest
    relative cost difference up to and including that step's cost (the
    whole history if no rung flips).  After a tie flips the argmin the two
    trajectories are different solves of one problem.
    """
    ref = np.asarray(lo["cost_history"], dtype=np.float64)
    got = np.asarray(costs, dtype=np.float64)
    flips = [k for k, (a, b) in enumerate(zip(rungs, lo["rungs"])) if a != b]
    flip = flips[0] if flips else None
    end = len(ref) if flip is None else flip + 2
    prefix = float(np.max(np.abs(got[:end] - ref[:end]) / np.abs(ref[:end])))
    tied = True
    if flip is not None:
        want = np.asarray(lo["ladder_costs"][flip], dtype=np.float64)
        a, b = rungs[flip], lo["rungs"][flip]
        tied = bool(abs(want[a] - want[b]) <= RUNG_TIE * abs(want[b]))
    return flip, tied, prefix


def stepped_rungs(inst, alpha, n):
    """The port's latch-off solve from ``init_phi`` stepped by hand: the
    (n+1,) cost history after each step and the (n,) winning rungs."""
    import torch
    from repro_torch.core import engine, gp

    phi = gp.init_phi(inst)
    costs, rungs = [], []
    for _ in range(n):
        st = engine.gp_step(inst, phi, alpha)
        costs.append(st.cost)
        rungs.append(st.rung)
        phi = st.phi
    return (torch.stack(costs).double().cpu().numpy(),
            [int(r) for r in torch.stack(rungs).cpu()])
