"""Seeded numpy inputs shared by the port's kernel tests (CPU and card)."""

import collections
import contextlib
import functools
import json

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


# The node counts the blocked-set kernels are held at (card tests): rows
# shorter than a 16-byte chunk of the mask (4, 8, 12; a chunk spans up to
# four rows at V = 4), word and cluster boundaries (32, 128 / 129: a second
# CTA), the dense route's scale ladder and lu_factor's limit.
BLOCKED_SET_V = (1, 4, 8, 12, 16, 31, 32, 33, 100, 128, 240, 241, 300, 600, 1000, 1614)
BLOCK_EPS = 1e-7      # engine.BLOCK_EPS


def rounding_pair(rng):
    """(x, lo, hi) float32: ``x + 1e-7`` rounds to ``lo`` as one float32 add
    and to ``hi`` through float64, or the other way round; ``lo < hi``."""
    while True:
        x = np.float32(rng.uniform(0.0, 1e-5))
        f32 = np.float32(x + np.float32(BLOCK_EPS))
        f64 = np.float32(np.float64(x) + BLOCK_EPS)
        if f32 != f64:
            return x, min(f32, f64), max(f32, f64)


def blocked_set_inputs(seed, V, members=1, per=3, special=False):
    """(phi (B, V, V) float32, pdt (B, V) float32, adj (M, V, V) bool) with
    B = members * per, row batch b of member b // per, as the GP step hands
    them to the blocked sets.

    Each member has a random symmetric adjacency; each row batch routes
    along a random DAG inside it (phi in 0.05..1 on 70% of the forward
    edges of a hidden order), and its pdt falls along that order (1e-6 a
    rank) but for 2% of the nodes, drawn at random: their links are the
    improper ones, so tags propagate upstream.  ``special`` adds NaN, +inf,
    -inf and -0.0 entries to phi (on adjacency entries, routed or not) and
    to pdt, and pdt pairs on routed links whose threshold ``pdt_p + 1e-7``
    rounds otherwise in float32 than in float64 (``rounding_pair``), with
    pdt_q the higher of the two roundings: there the two rules disagree.
    """
    rng = np.random.default_rng(seed)
    B = members * per
    dens = min(0.5, 4.0 / max(V, 1))
    adj = np.zeros((members, V, V), dtype=bool)
    phi = np.zeros((B, V, V), dtype=np.float32)
    pdt = np.zeros((B, V), dtype=np.float32)
    for m in range(members):
        a = rng.random((V, V)) < dens
        a = (a | a.T) & ~np.eye(V, dtype=bool)
        adj[m] = a
        for b in range(m * per, (m + 1) * per):
            rank = rng.permutation(V)
            route = a & (rank[:, None] < rank[None, :]) & (rng.random((V, V)) < 0.7)
            phi[b][route] = rng.uniform(0.05, 1.0, int(route.sum()))
            p = (V - rank) * 1e-6
            out = rng.random(V) < 0.02
            p[out] = rng.uniform(0.0, V * 1e-6, int(out.sum()))
            pdt[b] = p
            if not special:
                continue
            on = np.argwhere(a)
            for val in (np.nan, np.inf, -np.inf, -0.0, np.nan, np.inf):
                if len(on):
                    i, j = on[rng.integers(len(on))]
                    phi[b, i, j] = val
            for val in (np.nan, np.inf, -np.inf, -0.0, 0.0):
                pdt[b, rng.integers(V)] = val
            for i, j in np.argwhere(route)[:3]:
                x, _, hi = rounding_pair(rng)
                pdt[b, i], pdt[b, j] = x, hi
    return phi, pdt, adj


def three_term_mask(phi, pdt, adj):
    """The blocked-set kernels' contract in numpy (float32 threshold, one
    add): ``~adj | worse | tagged[q]``, tagged the least fixed point of
    ``tagged[p] = OR_q route[p, q] & (improper[p, q] | tagged[q])``."""
    B, V = pdt.shape
    per = B // adj.shape[0]
    route = phi > 0
    thr = (pdt + np.float32(BLOCK_EPS)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        worse = pdt[:, None, :] > thr[:, :, None]
    improper = route & worse
    tagged = np.zeros((B, V), dtype=bool)
    while True:
        nxt = (route & (improper | tagged[:, None, :])).any(-1)
        if np.array_equal(nxt, tagged):
            break
        tagged = nxt
    return ~np.repeat(adj, per, axis=0) | worse | tagged[:, None, :], tagged


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


# ---------------------------------------------------------------------------
# Sweep members against the reference's golden runs (torch_ref_sweep.npz)
# ---------------------------------------------------------------------------

SYNC_TOL = 1e-5      # cost histories agree within this, relative
# A step's two choices (rungs, or the mixed and the plain candidate) whose
# costs lie within the histories' own agreement are a tie: the port pins
# each cost only to SYNC_TOL of the reference's, so the reference's choice
# between them is not determined at that precision.
FLIP_TIE = SYNC_TOL
# The start of a run moved by one float32 ulp (relative), to see where the
# solve's own trajectory stops being fixed by float32 arithmetic.
JITTER = 2.0 ** -23


def golden_member(z, fig, solver, label):
    """One member of ``torch_ref_sweep.npz`` as {field: array}, or None."""
    pre = f"{fig}/{solver}/{label}/"
    keys = [k for k in z.keys() if k.startswith(pre)]
    return {k[len(pre):]: z[k] for k in keys} or None


def golden_witnesses(z, fig, solver, label, serial=False):
    """The reference's own other runs of one member, for ``sweep_parity``:
    ``sparse`` (its other stage solver), ``twin`` (its one-by-one run when
    the member is held to its batched run, and the other way round) and
    ``budget`` (its batched run with the stall latch off); None where the
    golden file has no such run."""
    base = solver.removesuffix("-serial")
    return {"sparse": golden_member(z, fig, base + "-sparse", label),
            "twin": golden_member(z, fig, base if serial else base + "-serial", label),
            "budget": golden_member(z, fig, base + "-budget", label)}


def jittered(masks_fn=None, seed=0):
    """A ``masks_fn`` for ``scenarios.run_sweep`` whose initial strategy is
    ``masks_fn``'s (``gp.init_phi``'s without one) with every entry moved
    by -1, 0 or +1 ulp (``JITTER``, relative; seeded): the same solve from a
    start that differs only by float32 rounding."""
    import torch
    from repro_torch.core import gp
    from repro_torch.core.traffic import Phi

    def fn(inst):
        ae, ac, phi = (None, None, gp.init_phi(inst)) if masks_fn is None else masks_fn(inst)
        g = torch.Generator().manual_seed(seed)

        def move(x):
            u = torch.randint(-1, 2, x.shape, generator=g).to(x.device, x.dtype)
            return x * (1 + JITTER * u)

        return ae, ac, Phi(e=move(phi.e), c=move(phi.c))
    return fn


def certify(inst, phi, masks_fn=None):
    """The cost of a sweep member's final strategy ``phi`` recomputed in
    float64 on the CPU (the plain versions of the kernels), or None where
    ``phi`` is not a strategy of the member's problem: a negative entry, a
    direction outside the topology or ``masks_fn``'s restriction, a row
    that does not sum to one within 1e-5, or traffic that does not settle.
    """
    from repro_torch.core import engine
    from repro_torch.core.traffic import feasibility_violation

    allowed_e = inst.adj[..., None, None, :, :]
    allowed_c = inst.cpu_allowed()[..., None]
    if masks_fn is not None:
        ae, ac, _ = masks_fn(inst)
        allowed_e, allowed_c = allowed_e & ae, allowed_c & ac

    inst, phi = _cpu64(inst, phi)
    allowed_e, allowed_c = allowed_e.cpu(), allowed_c.cpu()
    ok = (bool((phi.e >= 0).all() and (phi.c >= 0).all())
          and not bool((phi.e > 0)[~allowed_e.expand(phi.e.shape)].any())
          and not bool((phi.c > 0)[~allowed_c.expand(phi.c.shape)].any())
          and float(feasibility_violation(inst, phi)) <= 1e-5)
    cost = float(engine._strategy_cost(inst, phi)) if ok else None
    return cost if cost is not None and np.isfinite(cost) else None


def _cpu64(inst, phi):
    """``inst`` and ``phi`` as float64 CPU tensors."""
    import dataclasses

    from repro_torch.core import network
    from repro_torch.core.traffic import Phi

    def cpu64(x):
        x = x.detach().cpu()
        return x.double() if x.is_floating_point() else x

    return (dataclasses.replace(inst, **{f: cpu64(getattr(inst, f))
                                         for f in network.DENSE_FIELDS}),
            Phi(e=cpu64(phi.e), c=cpu64(phi.c)))


def local_steps(inst, n, *, alpha, masks_fn=None):
    """The port's plain GP solve of one member (unpadded ``inst``, on its
    device, from ``gp.init_phi`` or ``masks_fn``'s start) stepped ``n``
    times, every latch off, and at each of its iterates the same step
    recomputed in float64 on the CPU (the plain versions of the kernels).

    Returns ``(costs, worst, same)``: the (n+1,) float32 cost history, the
    largest relative difference between a float32 step's cost and the
    float64 step's from the same iterate, and whether every step took the
    float64 step's rung.  Where these steps are each right to float32
    precision, two trajectories part only by rounding the map amplifies.
    """
    import torch
    from repro_torch.core import engine, gp

    ae = ac = None
    phi = gp.init_phi(inst)
    if masks_fn is not None:
        ae, ac, phi = masks_fn(inst)
    ae64, ac64 = (None if m is None else m.cpu() for m in (ae, ac))
    a32 = torch.tensor(alpha, dtype=torch.float32, device=inst.device)
    a64 = torch.tensor(alpha, dtype=torch.float64)
    costs = [float(engine.total_cost(inst, phi))]
    worst, same = 0.0, True
    for _ in range(n):
        st = engine.gp_step(inst, phi, a32, ae, ac)
        i64, p64 = _cpu64(inst, phi)
        st64 = engine.gp_step(i64, p64, a64, ae64, ac64)
        worst = max(worst, abs(float(st.cost) - float(st64.cost)) / abs(float(st64.cost)))
        same = same and int(st.rung) == int(st64.rung)
        costs.append(float(st.cost))
        phi = st.phi
    return np.asarray(costs), worst, same


def _arr(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _hist(run):
    return _arr(run["cost_history"] if isinstance(run, dict) else run.cost_history
                ).astype(np.float64)


def _count(run):
    return int(run["iterations"] if isinstance(run, dict) else run.iterations)


def _split(a, b, tol=SYNC_TOL):
    """(first index where two cost histories part by more than ``tol``
    relative on their common prefix, or None; largest relative difference
    on the prefix up to there)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = min(len(a), len(b))
    with np.errstate(invalid="ignore"):
        rel = np.abs(a[:n] - b[:n]) / np.maximum(np.abs(b[:n]), 1e-30)
    # equal values agree, infinite ones too, and so do two NaNs (the cost of
    # a corrupted strategy)
    rel[(a[:n] == b[:n]) | (np.isnan(a[:n]) & np.isnan(b[:n]))] = 0.0
    out = np.flatnonzero(~(rel <= tol))
    split = int(out[0]) if len(out) else None
    return split, float(rel[:split].max()) if split != 0 else 0.0


def departure(a, b):
    """Where two runs of one member (golden members or ``GPResult``s) stop
    being one run: the first index where their cost histories part by more
    than ``SYNC_TOL``, else, where their counts differ, the earlier stop;
    None for one run."""
    split, _ = _split(_hist(a), _hist(b))
    if split is not None:
        return split
    ia, ib = _count(a), _count(b)
    return min(ia, ib) if ia != ib else None


def _final_rel(run, ref):
    if run is None:
        return 0.0
    r = float(_hist(ref)[-1])
    return abs(float(_hist(run)[-1]) - r) / abs(r)


def sweep_parity(port, ref, *, max_iters, sparse=None, twin=None, budget=None,
                 own=(), certify=None, local=None):
    """Hold one sweep member of the port to the reference's golden run.

    ``port``: the member's trimmed ``GPResult`` solved with ``record=True``
    (numpy or torch); ``ref``: its golden run (``golden_member``, with the
    reference's telemetry columns ``rung``/``anderson``); ``sparse``,
    ``twin``, ``budget``: the reference's own other runs of the member
    (``golden_witnesses``), or None; ``own``: the port's own other runs of
    the member (its run from a ``jittered`` start, its batched or
    one-by-one run), or empty; ``certify``: a callable giving the port's
    final strategy's cost recomputed in float64, None if that strategy is
    not one of the problem (``functools.partial(certify, inst, phi,
    masks_fn)``), or None; ``local``: ``functools.partial(local_steps,
    inst, alpha=..., masks_fn=...)`` for a plain (not accelerated) member,
    or None; ``max_iters`` the sweep's budget.

    The contract, whose limit is the determinism of the solve itself:
      * the cost histories agree within ``SYNC_TOL`` up to their first
        parting (``split``), or on the whole common prefix;
      * the port's first departure from the reference (its first decision
        that differs: winning rung or Anderson acceptance; its first
        parting; or, where the counts differ, the earlier stop) has a
        witness:
          - a decision flip that is a float32 tie (the port's costs of the
            two choices within ``FLIP_TIE``, relative), after which the two
            runs are different solves of one problem;
          - for a count difference alone, the stall latch replayed on each
            history giving each count, the two first disagreeing where the
            costs differ by less than its own 1e-6 threshold;
          - a run that departs as early or earlier from its sibling
            where the only difference is float32 rounding: the reference's
            ``sparse`` or ``twin`` run from the reference, or one of the
            port's ``own`` runs from the port;
          - for a parting with every decision the reference's up to it, the
            port's ``local`` steps: replayed, its history up to the parting
            (within 1e-6), and from each of those iterates the step is the
            float64 step within ``SYNC_TOL`` and takes its rung, so that
            only rounding the map amplifies parts the two runs;
      * the final cost, whatever happened before: at most ``final_tol``
        above the reference's, ``max(SYNC_TOL, 2 |sparse - ref|,
        |twin - ref|)`` relative (the reference's own spread on the
        member), and at most ``final_tol`` below the lowest end point of
        the reference's own runs of the member (``ref``, ``sparse``,
        ``twin``, and ``budget``, the same solve without the stall latch,
        where the port runs longer than the reference); lower still only
        as a better solution of the same problem that ``certify`` checks:
        a strategy of the member's (restricted) problem whose float64 cost
        is the port's final cost within ``SYNC_TOL``.
    Returns a report dict; ``report["ok"]`` is the verdict and
    ``report["why"]`` what failed.
    """
    hist = _hist(port)
    rec = {k: _arr(v) for k, v in port.records.items()}
    it, ref_it = _count(port), _count(ref)
    rh = _hist(ref)
    split, prefix = _split(hist, rh)
    horizon = len(rh) if split is None else split
    flips, untied = [], []
    for j in range(min(horizon, it, ref_it)):
        pr, rr = int(rec["rung"][j]), int(ref["rung"][j])
        lc = rec["ladder_costs"][j].astype(np.float64)
        if pr != rr:
            a, b = lc[pr], lc[rr]
            flips.append(("rung", j + 1, pr, rr))
            if not ((a == b) or abs(a - b) <= FLIP_TIE * abs(b)):
                untied.append(("rung", j + 1, float(a), float(b)))
        if rec["anderson"][j] != ref["anderson"][j]:
            plain, mix = lc[pr], float(rec["mix_cost"][j])
            flips.append(("anderson", j + 1, float(rec["anderson"][j]),
                          float(ref["anderson"][j])))
            if not abs(mix - plain) <= FLIP_TIE * abs(plain):
                untied.append(("anderson", j + 1, mix, float(plain)))
    events = [flips[0][1]] if flips else []
    events += [split] if split is not None else []
    events += [min(it, ref_it)] if it != ref_it else []
    first = min(events) if events else None
    selfs = [d for d in (departure(ref, x) for x in (sparse, twin) if x is not None)
             if d is not None]
    owns = [d for d in (departure(port, x) for x in own) if d is not None]
    self_first = min(selfs + owns) if selfs or owns else None
    self_witness = first is not None and self_first is not None and self_first <= first
    first_tied = bool(flips) and not (untied and untied[0][1] == flips[0][1])
    port_stop, port_imp = stall_stop(hist, max_iters=max_iters)
    ref_stop, ref_imp = stall_stop(rh, max_iters=max_iters)
    dis = [i for i, (a, b) in enumerate(zip(port_imp, ref_imp), 1) if a != b]
    stall_witness = bool(port_stop == it and ref_stop == ref_it and dis
                         and abs(hist[dis[0]] - rh[dis[0]]) < 1e-6 * abs(rh[dis[0]]))

    why, local_witness = [], None
    if first is not None and not self_witness:
        if flips and flips[0][1] == first:
            if not first_tied:
                why.append(f"first decision flip untied: {untied[0]}")
        elif split is not None and split == first:
            if local is not None:
                costs, worst, same = local(split)
                replay, _ = _split(costs, hist[:split + 1], tol=1e-6)
                local_witness = {"replayed": replay is None, "worst_step_rel": worst,
                                 "rungs_same": same}
            if not (local_witness and local_witness["replayed"] and same
                    and worst <= SYNC_TOL):
                why.append(f"histories part at {split} with no witness ({local_witness})")
        elif not stall_witness:
            why.append(f"counts {it} vs {ref_it} with no witness")
    final_tol = max(SYNC_TOL, 2 * _final_rel(sparse, ref), _final_rel(twin, ref))
    r_final = float(rh[-1])
    lows = [sparse, twin] + ([budget] if it > ref_it else [])
    lo = min([r_final] + [float(_hist(x)[-1]) for x in lows if x is not None])
    final_rel = abs(hist[-1] - r_final) / abs(r_final)
    certified = None
    if hist[-1] > r_final + final_tol * abs(r_final):
        why.append(f"final cost {float(hist[-1])} above {r_final} + {final_tol} relative")
    elif hist[-1] < lo - final_tol * abs(lo):
        certified = certify() if certify is not None else None
        if certified is None or not abs(certified - hist[-1]) <= SYNC_TOL * abs(hist[-1]):
            why.append(f"final cost {float(hist[-1])} below {lo} - {final_tol} relative, "
                       f"not certified ({certified})")
    return {"ok": not why, "why": why, "iterations": it, "reference_iterations": ref_it,
            "split": split, "prefix_max_rel": prefix, "final_rel": float(final_rel),
            "final_tol": final_tol, "final_floor": lo, "certified": certified,
            "flips": len(flips), "first_flip": flips[0] if flips else None,
            "untied": untied[:3], "stall_witness": stall_witness,
            "first_departure": first, "self_departure": self_first,
            "self_witness": self_witness, "local_witness": local_witness}


# The sweeps held to the golden file besides Figs. 5 and 6 (the file's
# figure keys; ``tests/data/make_torch_ref_sweep.py``) and their solvers.
HELD_SWEEPS = {"fig7": ("GP", "SPOC", "LCOF"), "ensemble": ("GP", "GP-accel"),
               "mixed": ("GP", "SPOC", "LCOF")}

# Members of those sweeps that fail ``sweep_parity`` for a reason recorded
# in ROADMAP Queue 3, by the device type the port ran on:
# {(figure, solver, way, member): fault}.  They are held strictly: each
# must still fail (the CPU test marks it a strict xfail; the card's sweep
# phase requires its failure), so a change that makes one pass shows; and
# each must fail only as recorded (:func:`known_fault_holds`), so that a
# worse failure of the member fails too.
STALL_TRAP = {
    "reason": ("float32 stall trap: the port's plain GP stops on its stall latch "
               "(tiny-step rungs win by one-ulp cost differences) where the "
               "reference's run, and the reference's own steps from the port's "
               "iterate, go on descending; final cost 2e-5 above the reference's"),
    # the one failure: the final cost above the reference's bound, at most
    # 3e-5 above the reference's, after a stop before the reference's
    "why": r"final cost \S+ above \S+ \+ \S+ relative",
    "final_rel_max": 3e-5,
    "stops_first": True,
}
# A congested member that does not converge within the budget: at a ladder
# rung tie its float32 trajectory takes another descent branch than the
# reference's and ends on it at the iteration cap.  Held with a witness
# (``branch_witness``): a run of the member that differs from the line's
# only by float32 rounding (a start moved by one ulp, ``jittered``; on the
# card, another batch composition) ends on the reference's branch.
TIE_BRANCH = {
    "reason": ("float32 branch at a rung tie: the port's trajectory parts from the "
               "reference's at a ladder rung tied within 1e-5 and, not converged, "
               "reaches the iteration cap on another descent branch; a run that "
               "differs from it only by float32 rounding ends on the reference's"),
    "why": r"final cost \S+ above \S+ \+ \S+ relative",
    "final_rel_max": 2e-3,
    "stops_first": False,
    "branch_witness": True,
}
# The stall trap on the online-trace members and warm re-solves, where the
# port's early stop lands up to 6e-5 above the reference's end point.
ONLINE_STALL_TRAP = dict(STALL_TRAP, final_rel_max=6e-5)
SWEEP_KNOWN_FAULTS = {
    "cpu": {("ensemble", "GP", "batched", "abilene#s11"): STALL_TRAP,
            ("ensemble", "GP", "serial", "abilene#s11"): STALL_TRAP,
            ("mixed", "GP", "batched", "abilene#s0"): STALL_TRAP},
    "cuda": {("ensemble", "GP", "batched", "abilene#s29"): STALL_TRAP},
}
# The same for the online-trace fleets of tests/data/torch_ref_online.npz
# ((fleet, solver, way, member)) and its warm re-solves (label ``tNN``).
ONLINE_KNOWN_FAULTS = {
    "cpu": {("fig6", "GP", "batched", "abilene-ev00-m5"): TIE_BRANCH,
            ("fig6", "GP", "serial", "abilene-ev00-m5"): TIE_BRANCH,
            ("fig6", "GP", "batched", "abilene-ev03-m3"): ONLINE_STALL_TRAP,
            ("fig6", "GP", "serial", "abilene-ev03-m3"): ONLINE_STALL_TRAP},
    # on the card the one-by-one runs of these two take the reference's
    # branch, and so do their batched runs in a batch of two
    "cuda": {("fig6", "GP", "batched", "abilene-ev00-m5"): TIE_BRANCH,
             ("fig6", "GP", "batched", "abilene-ev16-m4"): TIE_BRANCH},
}
# Both tables by device type, for a check that holds the members of both
# golden files (their member labels do not collide).
KNOWN_FAULTS = {dev: {**SWEEP_KNOWN_FAULTS[dev], **ONLINE_KNOWN_FAULTS[dev]}
                for dev in ("cpu", "cuda")}


def known_fault_holds(rep, fault, witnesses=()) -> list:
    """What in a known fault's ``sweep_parity`` report differs from the
    fault as recorded (empty where it fails just so): the member must fail,
    with exactly one reason, the fault's ``why`` (a regular expression);
    its histories must agree within ``SYNC_TOL`` up to their parting; its
    final cost must lie at most ``final_rel_max`` from the reference's;
    with ``stops_first`` it must stop before the reference's run; and with
    ``branch_witness`` one of ``witnesses`` (the ``sweep_parity`` reports
    of the member's runs that differ from the line's only by float32
    rounding) must end within its final tolerance of the reference's."""
    import re

    bad = []
    if rep["ok"]:
        bad.append("passes")
    elif len(rep["why"]) != 1 or not re.fullmatch(fault["why"], rep["why"][0]):
        bad.append(f"fails otherwise: {rep['why']}")
    if not rep["prefix_max_rel"] <= SYNC_TOL:
        bad.append(f"histories part by {rep['prefix_max_rel']} before their parting")
    if not rep["final_rel"] <= fault["final_rel_max"]:
        bad.append(f"final cost {rep['final_rel']} from the reference's, "
                   f"above {fault['final_rel_max']}")
    if fault.get("stops_first") and not rep["iterations"] < rep["reference_iterations"]:
        bad.append(f"stops at {rep['iterations']}, the reference at "
                   f"{rep['reference_iterations']}")
    if fault.get("branch_witness") and not any(w["final_rel"] <= w["final_tol"]
                                               for w in witnesses):
        bad.append("no run that differs only by float32 rounding ends on the reference's "
                   f"branch: {[w['final_rel'] for w in witnesses]}")
    return bad


def chained_parity(results, refs, colds, *, max_iters):
    """``sweep_parity`` along a warm-started chain (``run_sweep_chained``):
    member k starts from member k-1's final strategy; ``colds`` are the
    reference's cold (batched) golden runs of the same members.

    A member that starts where the reference's starts (cost within
    ``SYNC_TOL``) is held to ``sweep_parity``.  One that starts elsewhere
    is witnessed by its predecessor having ended on another iterate than
    the reference's (a decision flip, a parting or another count), and is
    then held to descent (a finite history that never rises above its
    start) and to its final cost: within ``max(SYNC_TOL, |cold - ref|)``
    of the reference's chained run, relative, where ``cold - ref`` is how
    far the reference's own end point moves when the member starts cold
    instead of from its predecessor.  Returns one report per member.
    """
    reports, prev_moved = [], False
    for res, ref, cold in zip(results, refs, colds):
        hist = _hist(res)
        r0 = float(ref["cost_history"][0])
        start_rel = abs(hist[0] - r0) / abs(r0)
        if start_rel <= SYNC_TOL:
            rep = sweep_parity(res, ref, max_iters=max_iters)
            moved = bool(rep["flips"] or rep["split"] is not None
                         or rep["iterations"] != rep["reference_iterations"])
        else:
            descent = bool(np.isfinite(hist).all() and hist.max() <= hist[0])
            final_rel = _final_rel(res, ref)
            final_tol = max(SYNC_TOL, _final_rel(cold, ref))
            why = ([] if prev_moved else ["starts elsewhere, predecessor did not"])
            why += [] if descent else ["history rises above its start"]
            why += ([] if final_rel <= final_tol
                    else [f"final cost {final_rel} > {final_tol}"])
            rep = {"ok": not why, "why": why, "iterations": int(res.iterations),
                   "reference_iterations": int(ref["iterations"]), "split": 0,
                   "prefix_max_rel": 0.0, "start_rel": float(start_rel),
                   "final_rel": final_rel, "final_tol": final_tol,
                   "flips": None, "first_flip": None, "stall_witness": False}
            moved = True
        reports.append(rep)
        prev_moved = moved
    return reports


# ---------------------------------------------------------------------------
# The event layer against the reference's runs (torch_ref_online.npz, made
# by tests/data/make_torch_ref_online.py)
# ---------------------------------------------------------------------------

ONLINE_FIELDS = ("adj", "link_param", "comp_param", "L", "w", "wnode", "r", "dst",
                 "n_tasks", "stage_mask")
# A gate residual this close to the gate's tolerance (absolute) decides
# nothing at float32 precision: a mask that differs there is a tie.
GATE_TIE = 1e-5


# ``simulate``'s mean delay against a stored run: ``numpy.mean``'s pairwise
# sum of a few thousand positive delays rounds by the host's numpy build;
# two summation orders of n positive terms part by at most about
# 2 (log2(n) + 16) ulps (numpy's 8-way unrolled blocks of 128), ~5e-15.
SIM_MEAN_TOL = 1e-14


def online_meta(z) -> dict:
    return json.loads(str(z["meta"]))


def online_sweep_kwargs(z, fleet: str) -> tuple[dict, dict]:
    """(``sweep_kwargs`` of the fleet's ``online-trace`` sweep, the solve's
    ``alpha`` and ``max_iters``) as the file's meta records them."""
    p = online_meta(z)["fleets"][fleet]
    return ({k: (tuple(v) if isinstance(v, list) else v) for k, v in p.items()
             if k in ("scenario", "scales", "seed", "n_events", "spare_apps")},
            {"alpha": p["alpha"], "max_iters": p["max_iters"]})


def event_from_dict(d: dict):
    """The port's event that ``{"type": class name, **fields}`` (a stored
    trace's entry) describes; ``rates`` pairs become tuples."""
    import typing

    from repro_torch.core import events

    fields = {k: v for k, v in d.items() if k != "type"}
    if "rates" in fields:
        fields["rates"] = tuple((int(n), float(r)) for n, r in fields["rates"])
    return {t.__name__: t for t in typing.get_args(events.Event)}[d["type"]](**fields)


def online_trace(z, fleet: str) -> list:
    """The reference's stored trace of one fleet, as the port's events."""
    return [event_from_dict(d) for d in json.loads(str(z[f"{fleet}/trace"]))]


def same_event(port_ev, ref_ev) -> bool:
    """An event of either package against one of the other (or a stored
    one): same class name and same fields."""
    import dataclasses

    return (type(port_ev).__name__ == type(ref_ev).__name__
            and dataclasses.asdict(port_ev) == dataclasses.asdict(ref_ev))


def member_mismatches(z, fleet: str, insts) -> list:
    """(event index, field) of each post-event member field that is not the
    stored one bit for bit (integer fields compared by value)."""
    bad = []
    for f in ONLINE_FIELDS:
        want = z[f"{fleet}/members/{f}"]
        if len(insts) != len(want):
            return [(None, f"{len(insts)} members, want {len(want)}")]
        for t, inst in enumerate(insts):
            got = getattr(inst, f).detach().cpu().numpy()
            w = want[t]
            # floats bit for bit in the same dtype; ints and bools by value
            same_kind = got.dtype == w.dtype or "f" not in (got.dtype.kind, w.dtype.kind)
            if not (got.shape == w.shape and same_kind and np.array_equal(got, w)):
                bad.append((t, f))
    return bad


def warm_case(z, t: int) -> dict:
    """Warm re-solve ``t`` of the file (the reference's default solve and
    its inputs), as {name: array}."""
    return golden_member(z, "warm", "GP", f"t{t:02d}")


# Warm re-solves that fail ``sweep_parity`` for a recorded reason, by the
# device type the port ran on: {label: fault}, held as SWEEP_KNOWN_FAULTS.
WARM_KNOWN_FAULTS = {"cpu": {"t03": ONLINE_STALL_TRAP}, "cuda": {}}


def latch_replay(costs, residuals, *, tol, patience=40, max_iters=400, alphas=None,
                 moved=None, phi_tol=1e-6):
    """Replay the solve loop's stop test (residual at most ``tol``, no
    improvement above 1e-6 relative for ``patience`` iterations, the
    budget) on a cost and residual history, in float32 as the loop tests
    it.  With ``alphas`` and ``moved`` (each step's winning stepsize and
    committed max|dphi|) also the accelerated solve's phi fixed-point latch
    (a positive stepsize and a move of at most ``phi_tol``).  Returns
    ``(stop, flags)``: the iteration the test stops at, or None, and per
    iteration (improved, residual latched), with the fixed-point latch's
    flag third where it is replayed."""
    h = np.asarray(costs, dtype=np.float32)
    res = np.asarray(residuals, dtype=np.float32)
    best, stall, flags = h[0], 0, []
    for i in range(1, len(h)):
        imp = bool(h[i] < best * np.float32(1 - 1e-6))
        hit = bool(res[i - 1] <= np.float32(tol))
        flag = (imp, hit)
        if alphas is not None:
            fixed = bool(np.float32(alphas[i - 1]) > 0
                         and np.float32(moved[i - 1]) <= np.float32(phi_tol))
            flag, hit = flag + (fixed,), hit or fixed
        flags.append(flag)
        best, stall = (h[i], 0) if imp else (best, stall + 1)
        if hit or stall >= patience or i >= max_iters:
            return i, flags
    return None, flags


def gate_parity(port_residual, ref_residual, ref_mask, tol) -> dict:
    """The port's skip gate (``per_app_residual > tol``) against the
    reference's on the same strategy: the masks equal, except at an
    application whose two residuals agree (within ``SYNC_TOL`` of
    max(|reference|, 1)) and lie within ``GATE_TIE`` of ``tol``: a tie."""
    got = _arr(port_residual).astype(np.float64)
    want = np.asarray(ref_residual, dtype=np.float64)
    mask = got > tol
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    differ = np.flatnonzero(mask != np.asarray(ref_mask))
    ties = [int(a) for a in differ
            if rel[a] <= SYNC_TOL and abs(want[a] - tol) <= GATE_TIE]
    untied = [int(a) for a in differ if int(a) not in ties]
    return {"ok": not untied, "mask": mask.astype(int).tolist(),
            "reference_mask": np.asarray(ref_mask).astype(int).tolist(),
            "ties": ties, "untied": untied, "residual_max_rel": float(rel.max())}


def warm_parity(port, ref, *, tol, patience=40, max_iters=400) -> dict:
    """The stall-latch contract on one default-latch solve (``port``: a trimmed
    ``GPResult``; ``ref``: the stored run, ``warm_case``): the cost
    histories within ``SYNC_TOL`` on their whole common prefix, the final
    costs within ``SYNC_TOL``, and each count reproduced by replaying the
    stop test on its own history; where the counts differ, the two replays
    first disagree at costs within the latch's own 1e-6 (relative) or at a
    residual within ``GATE_TIE`` of ``tol`` on both sides."""
    hist, rh = _hist(port), _hist(ref)
    pres = _arr(port.residual_history).astype(np.float64)
    rres = np.asarray(ref["residual_history"], dtype=np.float64)
    split, prefix = _split(hist, rh)
    it, ref_it = _count(port), _count(ref)
    final = abs(hist[-1] - rh[-1]) / abs(rh[-1])
    stop, flags = latch_replay(hist, pres, tol=tol, patience=patience, max_iters=max_iters)
    rstop, rflags = latch_replay(rh, rres, tol=tol, patience=patience, max_iters=max_iters)
    why = []
    if split is not None:
        why.append(f"histories part at {split}")
    if not final <= SYNC_TOL:
        why.append(f"final cost {final} relative from the reference's")
    if (stop, rstop) != (it, ref_it):
        why.append(f"the stop test replays {(stop, rstop)}, not {(it, ref_it)}")
    first = None
    if it != ref_it:
        dis = [i for i, (a, b) in enumerate(zip(flags, rflags), 1) if a != b]
        first = dis[0] if dis else min(it, ref_it)
        (ia, ha), (ib, hb) = (flags[first - 1], rflags[first - 1]) if dis else ((0, 0), (0, 0))
        tied = ((ia == ib or abs(hist[first] - rh[first]) < 1e-6 * abs(rh[first]))
                and (ha == hb or (abs(pres[first - 1] - tol) <= GATE_TIE
                                  and abs(rres[first - 1] - tol) <= GATE_TIE)))
        if not (dis and tied):
            why.append(f"counts {it} vs {ref_it}, first latch disagreement at {first} "
                       "is no tie")
    return {"ok": not why, "why": why, "iterations": it, "reference_iterations": ref_it,
            "prefix_max_rel": prefix, "final_rel": float(final),
            "first_latch_disagreement": first}


# ---------------------------------------------------------------------------
# The online service against the reference's runs (torch_ref_service.npz,
# made by tests/data/make_torch_ref_service.py)
# ---------------------------------------------------------------------------

# HealthReport fields held equal, and those held numerically (costs within
# SYNC_TOL relative, the iteration count exactly), per event.
SERVICE_EXACT = ("status", "rungs", "solved_apps", "skipped_apps", "unfroze", "repaired",
                 "kept_window", "cold_restart", "converged", "rolled_back", "quarantined",
                 "injected", "shed")
SERVICE_NUMERIC = ("cost", "iterations", "incumbent_cost")
SERVICE_COLUMNS = ("cost", "residual", "alpha", "rung", "anderson", "phi_delta")
# A committed move within this (absolute) of the phi fixed-point latch's
# 1e-6 decides nothing at float32 precision: strategy entries of order one
# are spaced 6e-8 apart, and the move is a difference of two of them.
PHI_TIE = 1.2e-7
# Seeds of the one-ulp moves and starts (``_mover``) a departure's witness tries.
WITNESS_SEEDS = range(8)


def service_run(z, part: str) -> dict:
    """One run of the file (``seq``, ``trace50``, ``chaos100``, ``budget``,
    ``inject/<mode>``) as its JSON."""
    return json.loads(str(z[f"{part}/json"]))


def service_segment(z, part: str, n: int) -> dict:
    """Re-convergence segment ``n`` of a stored run, with its histories."""
    seg = dict(service_run(z, part)["segments"][n])
    cols = {k: z[f"{part}/seg/{n:03d}/{k}"] for k in SERVICE_COLUMNS}
    seg.update(cols, iterations=seg["iters"],
               cost_history=np.concatenate([[np.float32(seg["start_cost"])], cols["cost"]]),
               residual_history=cols["residual"])
    return seg


def service_state(z, part: str, t: int) -> dict:
    """The stored state of the touched member before event ``t``."""
    pre = f"{part}/state/{t:02d}/"
    return {k[len(pre):]: z[k] for k in z.keys() if k.startswith(pre)}


def load_member_state(solver, b: int, inst, state: dict) -> None:
    """Teacher forcing: give the port's service member ``b`` the reference's
    pre-event instance ``inst``, carry (strategy and Anderson window) and
    last-known-good checkpoint (``service_state``), on the solver's device."""
    import dataclasses

    import torch
    from repro_torch.core import network
    from repro_torch.core.traffic import Phi
    from repro_torch.serve.online import _take

    dev = solver.device

    def t(name):
        return torch.from_numpy(np.array(state[name])).to(dev)

    solver._members[b] = inst
    idx = torch.tensor([b], device=dev)
    solver.binst = dataclasses.replace(solver.binst, **{
        f: getattr(solver.binst, f).index_copy(0, idx, getattr(inst, f)[None])
        for f in network.DENSE_FIELDS})
    one = _take(solver.carry, b)
    solver._scatter_carry(b, one._replace(
        phi=Phi(e=t("phi_e"), c=t("phi_c")), alpha=t("alpha"), ax=t("ax"), af=t("af"),
        ak=t("ak").to(one.ak.dtype)))
    solver._lkg_phi[b] = Phi(e=t("lkg_e"), c=t("lkg_c"))
    solver._lkg_cost[b] = float(state["lkg_cost"])
    solver._lkg_residual[b] = float(state["lkg_residual"])
    solver._lkg_cert[b] = bool(state["lkg_cert"])


def _mover(seed: int):
    import torch
    from repro_torch.core.traffic import Phi

    g = torch.Generator().manual_seed(seed)

    def move(phi):
        def one(x):
            u = torch.randint(-1, 2, x.shape, generator=g).to(x.device, x.dtype)
            return x * (1 + JITTER * u)
        return Phi(e=one(phi.e), c=one(phi.c))
    return move


def jitter_phi(solver, b: int, seed: int) -> None:
    """Move every entry of member ``b``'s live strategy by -1, 0 or +1 ulp
    (``JITTER``, relative; seeded): the same service state but for float32
    rounding."""
    from repro_torch.serve.online import _take

    one = _take(solver.carry, b)
    solver._scatter_carry(b, one._replace(phi=_mover(seed)(one.phi)))


@contextlib.contextmanager
def jittered_cold_starts(seed: int):
    """Within the block, ``gp.init_phi`` (the service's cold-restart and
    repair seed) returns its strategy moved by one ulp (seeded)."""
    from repro_torch.core import gp

    init, move = gp.init_phi, _mover(seed)
    gp.init_phi = lambda inst: move(init(inst))
    try:
        yield
    finally:
        gp.init_phi = init


class Enough(Exception):
    """A witness run recorded as far as it is needed (``ServiceRecorder``)."""


class ServiceRecorder:
    """Records the port service's re-convergence segments, as the reference
    file's: a context manager that wraps ``engine.scan_chunk`` (with
    ``record=True``) and ``OnlineSolver._converge_one`` / ``_converge`` of
    the class, so the fleet's cold start is seen too.  ``segments`` is a
    list of dicts: ``event`` (the solver's report count; -1 in the cold
    start), ``member``, ``phase``, ``budget``, ``cost_history`` (start
    first), ``residual_history``, ``iterations``, ``done``, ``stall``, the
    per-step records (``engine.RECORDS``) of the committed steps, and what
    ``replay`` needs to reach the segment's carry again: the member's start
    carry, instance and masks, or, in the fleet's cold start, the batch it
    ran in (``batch``) and its lane there.

    ``stop_at = (k, step)`` ends the run (``Enough``) once segment ``k`` of a
    single member has committed more than ``step`` iterations: a witness
    needs its run only up to the departure it is held against."""

    def __init__(self, stop_at=None):
        self.segments = []
        self._chunks = []
        self.stop_at = stop_at

    def __enter__(self):
        from repro_torch.core import engine
        from repro_torch.serve import online

        rec = self
        self._scan, self._one, self._many = (engine.scan_chunk, online.OnlineSolver._converge_one,
                                             online.OnlineSolver._converge)

        def scan(*a, **k):
            k["record"] = True
            c, cs, rs, r = rec._scan(*a, **k)
            rec._chunks.append((cs, rs, r))
            if (rec.stop_at is not None and c.iters.ndim == 0
                    and len(rec.segments) == rec.stop_at[0] and int(c.iters) > rec.stop_at[1]):
                rec._last = c
                raise Enough
            return c, cs, rs

        def one(solver, b, app_mask, plateau_res, max_iters=None, allowed=None,
                phase="solve"):
            from repro_torch.serve.online import _take

            start = float(solver.carry.cost[b])
            carry0, inst = _take(solver.carry, b), solver.member(b)
            rec._chunks.clear()
            try:
                out = rec._one(solver, b, app_mask, plateau_res, max_iters=max_iters,
                               allowed=allowed, phase=phase)
            except Enough:
                rec._take(solver, [b], None, phase, [start], max_iters, last=rec._last)
                raise
            rec._take(solver, [b], None, phase, [start], max_iters)
            rec.segments[-1].update(start_carry=carry0, instance=inst, allowed=allowed,
                                    app_mask=None if app_mask is None
                                    else np.asarray(app_mask, dtype=bool)[0])
            return out

        def many(solver, members, app_mask=None, plateau_res=None, max_iters=None,
                 allowed=None, phase="solve"):
            import torch
            from repro_torch.core import batch, gp

            if len(members) == 1:
                return rec._many(solver, members, app_mask, plateau_res, max_iters,
                                 allowed, phase)
            # the batch as ``OnlineSolver._converge`` forms it
            n = len(members)
            bucket = batch.next_pow2(n)
            sel = solver._index(list(members) + [members[0]] * (bucket - n))
            carry_s = gp._members(solver.carry, sel)
            carry_s = carry_s._replace(
                done=carry_s.done | (torch.arange(bucket, device=solver.device) >= n))
            am = None if app_mask is None else torch.as_tensor(np.concatenate(
                [np.asarray(app_mask, dtype=bool)]
                + [np.asarray(app_mask, dtype=bool)[:1]] * (bucket - n)), device=solver.device)
            start = (gp._members(solver.binst, sel), carry_s, am)
            starts = [float(solver.carry.cost[m]) for m in members]
            insts = [solver.member(m) for m in members]
            rec._chunks.clear()
            out = rec._many(solver, members, app_mask, plateau_res, max_iters, allowed,
                            phase)
            rec._take(solver, members, list(range(n)), phase, starts, max_iters)
            for i, seg in enumerate(rec.segments[-n:]):
                seg.update(batch=start, lane=i, instance=insts[i])
            return out

        engine.scan_chunk = scan
        online.OnlineSolver._converge_one = one
        online.OnlineSolver._converge = many
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine
        from repro_torch.serve import online

        engine.scan_chunk = self._scan
        online.OnlineSolver._converge_one = self._one
        online.OnlineSolver._converge = self._many
        return False

    def _take(self, solver, members, lanes, phase, starts, budget, last=None):
        import torch

        cs = torch.cat([c[0] for c in self._chunks]).cpu().numpy()
        rs = torch.cat([c[1] for c in self._chunks]).cpu().numpy()
        recs = {k: torch.cat([c[2][k] for c in self._chunks]).cpu().numpy()
                for k in self._chunks[0][2]}
        for i, (b, start) in enumerate(zip(members, starts)):
            lane = (slice(None),) if lanes is None else (slice(None), lanes[i])
            carry = solver.carry if last is None else last
            pick = (lambda x: x) if last is not None else (lambda x: x[b])
            it = int(pick(carry.iters))
            seg = {"event": -1 if phase == "cold-start" else len(solver.reports),
                   "member": int(b), "phase": phase, "budget": budget,
                   "cost_history": np.concatenate([[np.float32(start)], cs[lane][:it]]),
                   "residual_history": rs[lane][:it], "iterations": it,
                   "done": bool(pick(carry.done)), "stall": int(pick(carry.stall)),
                   "truncated": last is not None}
            seg.update({k: v[lane][:it] for k, v in recs.items()})
            self.segments.append(seg)
        self._chunks.clear()


def segment_count(seg, *, tol, patience, max_iters, plateau_res=None, phi_tol=1e-6):
    """The count the service's stop test and chunk schedule give a segment
    (``OnlineSolver._chunk_schedule``): the latch replayed on its histories
    (the phi fixed-point latch included), the segment's budget, and for the
    warm round the plateau exit (not done one chunk after a first chunk that
    ended at a residual of at most ``plateau_res``)."""
    h = np.asarray(seg["cost_history"], dtype=np.float64)
    stop, _ = latch_replay(h, seg["residual_history"], tol=tol, patience=patience,
                           max_iters=max_iters, alphas=seg["alpha"], moved=seg["phi_delta"],
                           phi_tol=phi_tol)
    budget = max_iters if seg.get("budget") is None else int(seg["budget"])
    steps, chunk, suspect = 0, 8, False
    while steps < budget:
        length = min(chunk, 1 << ((budget - steps).bit_length() - 1))
        chunk = min(chunk * 2, 64)
        steps += length
        if stop is not None and stop <= steps:
            return stop
        if suspect:
            return steps
        if plateau_res is not None:
            if steps > len(h) - 1:
                return None
            suspect = bool(np.float32(seg["residual_history"][steps - 1])
                           <= np.float32(plateau_res))
            plateau_res = None
    return budget


# Departure kinds that are float32 ties in themselves: a rung flip between
# two rungs whose costs (the port's) lie within FLIP_TIE, an Anderson flip
# whose mixed and plain costs do, and a count difference where the two
# latch replays first disagree at a tied test.
TIED_KINDS = ("rung-tie", "anderson-tie", "latch-tie")


def segment_parity(port, ref, *, tol, patience=40, max_iters=400, plateau_res=None) -> dict:
    """One re-convergence segment of the port's service against the
    reference's (``ServiceRecorder``, ``service_segment``), under the
    stall-latch contract: each count reproduced by ``segment_count`` on its
    own histories (``why`` otherwise), and the cost histories within
    ``SYNC_TOL`` up to the first departure, ``departure = (step, kind)``:

      * ``rung-tie`` / ``anderson-tie`` — the first differing decision, a
        rung flip whose two rungs' costs (the port's) lie within
        ``FLIP_TIE``, or an Anderson flip whose mixed and plain costs do;
      * ``rung`` / ``anderson`` — such a flip outside ``FLIP_TIE``;
      * ``part`` — the histories part with every decision the same (an
        accepted Anderson mix rounding otherwise);
      * ``latch-tie`` / ``count`` — the counts alone differ, and the two
        latch replays first disagree at a tie (costs within the latch's own
        1e-6, a residual within ``GATE_TIE`` of ``tol`` or of
        ``plateau_res`` at the warm round's plateau probe, a move within
        ``PHI_TIE`` of the phi latch, on both sides) or not.

    ``departure`` is None where the two are one run.  ``port`` may be
    another run of the port (a witness), compared the same way."""
    hist, rh = _hist(port), _hist(ref)
    it, rit = int(port["iterations"]), int(ref["iterations"])
    split, prefix = _split(hist, rh)
    horizon = len(rh) if split is None else split
    flip = None
    for j in range(min(horizon, it, rit)):
        pr, rr = int(port["rung"][j]), int(ref["rung"][j])
        lc = np.asarray(port["ladder_costs"][j], dtype=np.float64)
        if pr != rr:
            a, b = lc[pr], lc[rr]
            flip = (j + 1, "rung-tie" if a == b or abs(a - b) <= FLIP_TIE * abs(b) else "rung")
            break
        if float(port["anderson"][j]) != float(ref["anderson"][j]):
            plain, mix = lc[pr], float(port["mix_cost"][j])
            flip = (j + 1, "anderson-tie" if abs(mix - plain) <= FLIP_TIE * abs(plain)
                    else "anderson")
            break
    probe = plateau_res if port.get("phase") == "warm" else None
    kw = dict(tol=tol, patience=patience, max_iters=max_iters)
    why = []
    for name, run, n in (("port", port, it), ("reference", ref, rit)):
        want = segment_count(run, plateau_res=probe, **kw)
        if want != n:
            why.append(f"the {name}'s count {n} is not its stop test's {want}")
    steps = [e for e in (flip and flip[0], split, min(it, rit) if it != rit else None)
             if e is not None]
    first = min(steps) if steps else None
    departure = None
    if first is not None:
        if flip and flip[0] == first:
            departure = flip
        elif split == first:
            departure = (split, "part")
        else:
            lat = [latch_replay(h, r["residual_history"], alphas=r["alpha"],
                                moved=r["phi_delta"], **kw)[1]
                   for h, r in ((hist, port), (rh, ref))]
            dis = [i for i, (a, b) in enumerate(zip(*lat), 1) if a != b]
            if dis:
                i = dis[0]
                (ia, ha, fa), (ib, hb, fb) = lat[0][i - 1], lat[1][i - 1]
                pres, rres = port["residual_history"][i - 1], ref["residual_history"][i - 1]
                tied = ((ia == ib or abs(hist[i] - rh[i]) < 1e-6 * abs(rh[i]))
                        and (ha == hb or (abs(pres - tol) <= GATE_TIE
                                          and abs(rres - tol) <= GATE_TIE))
                        and (fa == fb or (abs(port["phi_delta"][i - 1] - 1e-6) <= PHI_TIE
                                          and abs(ref["phi_delta"][i - 1] - 1e-6) <= PHI_TIE)))
            else:
                # the same latch flags: the counts part at the plateau probe
                i = 8
                tied = (probe is not None and len(hist) > 8 and len(rh) > 8
                        and abs(port["residual_history"][7] - probe) <= GATE_TIE
                        and abs(ref["residual_history"][7] - probe) <= GATE_TIE)
            departure = (i, "latch-tie" if tied else "count")
    return {"ok": not why, "why": why, "departure": departure, "iterations": it,
            "reference_iterations": rit, "split": split, "prefix_max_rel": prefix,
            "final_rel": float(abs(hist[-1] - rh[-1]) / abs(rh[-1])
                               if np.isfinite(rh[-1]) and rh[-1] else 0.0)}


def _same(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return a == b or (a != a and b != b)
    return (list(a) if isinstance(a, (list, tuple)) else a) == \
        (list(b) if isinstance(b, (list, tuple)) else b)


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    if not (np.isfinite(a) and np.isfinite(b)):
        return 0.0 if (a == b or (a != a and b != b)) else float("inf")
    return abs(a - b) / max(abs(b), 1e-30)


def segments_departure(xs, ys, **kw):
    """The first departure of one event's segment list ``xs`` from ``ys``:
    ``(segment index, step, kind)`` (``segment_parity``'s, or ``phase`` /
    ``segments`` where the lists' phases or lengths differ), or None."""
    for k, (x, y) in enumerate(zip(xs, ys)):
        if x["phase"] != y["phase"]:
            return (k, 0, "phase")
        d = segment_parity(x, y, **kw)["departure"]
        if d is not None:
            return (k,) + tuple(d)
    if len(xs) != len(ys):
        return (min(len(xs), len(ys)), 0, "segments")
    return None


def event_parity(port_rep, ref_row, port_segs, ref_segs, *, tol, gate_tol,
                 rollback_margin=1e-4, patience=40, max_iters=400, plateau_res=None,
                 port_gate=None) -> dict:
    """One event of the port's service against the reference's.

    ``match`` where the exact fields (``SERVICE_EXACT``) are equal, the
    costs within ``SYNC_TOL`` relative, the counts equal and every segment
    one run with the reference's (``segment_parity``: histories within
    ``SYNC_TOL``, so a served cost apart from the reference's by more comes
    only after a departure).  Otherwise ``departs``, with the
    event's first ``departure``: a gate residual within ``GATE_TIE`` of
    ``gate_tol`` on which the masks differ (``port_gate``: the port's
    per-app residuals on the reference's strategy; ``gate-tie``), a cost
    within ``SYNC_TOL`` of the incumbent bound (``incumbent-tie``), or the
    first segment departure (``segments_departure``); ``(None, 0,
    "fields")`` where the fields differ and no segment departs.  ``why``
    lists what breaks the contract whatever the departure: an untied gate
    difference, a count its own stop test does not give."""
    rep = ref_row["report"]
    kw = dict(tol=tol, patience=patience, max_iters=max_iters, plateau_res=plateau_res)
    mism = [f for f in SERVICE_EXACT if not _same(getattr(port_rep, f), rep[f])]
    cost_rel = _rel(port_rep.cost, rep["cost"])
    numeric = []
    if not cost_rel <= SYNC_TOL:
        numeric.append(f"cost {port_rep.cost} vs {rep['cost']}")
    if not _rel(port_rep.incumbent_cost, rep["incumbent_cost"]) <= SYNC_TOL:
        numeric.append(f"incumbent {port_rep.incumbent_cost} vs {rep['incumbent_cost']}")
    if port_rep.iterations != rep["iterations"]:
        numeric.append(f"iterations {port_rep.iterations} vs {rep['iterations']}")
    why, departure = [], None
    if port_gate is not None:
        ref_res = np.asarray(ref_row["gate_residual"], dtype=np.float32)
        gate = gate_parity(port_gate, ref_res, ref_res > np.float32(gate_tol), gate_tol)
        if gate["ties"]:
            departure = (None, 0, "gate-tie")
        if gate["untied"]:
            why.append(f"gate masks differ untied at apps {gate['untied']}")
    bound = float(rep["incumbent_cost"]) * (1 + rollback_margin)
    if departure is None and np.isfinite(bound) and any(
            np.isfinite(c) and abs(c - bound) <= SYNC_TOL * abs(bound)
            for c in [ref_row["reset_cost"], rep["cost"]]
            + [float(s["cost_history"][-1]) for s in ref_segs]):
        departure = (None, 0, "incumbent-tie")
    segs, first = [], None
    for k, (ps, rs) in enumerate(zip(port_segs, ref_segs)):
        if ps["phase"] != rs["phase"]:
            first = (k, 0, "phase")
            break
        sp = segment_parity(ps, rs, **kw)
        segs.append({k2: sp[k2] for k2 in ("ok", "departure", "why", "iterations",
                                           "reference_iterations", "final_rel")})
        why += [f"segment {k} ({ps['phase']}): {w}" for w in sp["why"]]
        if sp["departure"]:
            first = (k,) + tuple(sp["departure"])
            break
    else:
        if len(port_segs) != len(ref_segs):
            first = (min(len(port_segs), len(ref_segs)), 0, "segments")
    if not (first or mism or numeric):
        departure = None                 # a tie that decided nothing
    elif departure is None:
        departure = first or (None, 0, "fields")
    return {"verdict": "match" if departure is None else "departs",
            "departure": departure, "tied": bool(departure and departure[2] in
                                                 TIED_KINDS + ("gate-tie", "incumbent-tie")),
            "ok": not why, "why": why, "fields": mism, "numeric": numeric,
            "cost_rel": cost_rel, "segments": segs,
            "iterations": port_rep.iterations, "reference_iterations": rep["iterations"]}


def forced_event(solver, state, inst, ev, *, jitter=None, stop_at=None):
    """Process ``ev`` on the port's service from a stored pre-event state
    (``load_member_state``: the member's pre-event instance ``inst``, the
    reference's carry and checkpoint), or from the solver's own state where
    ``state`` is None; with a seed ``jitter`` the live strategy and every
    cold start moved by one ulp (``jitter_phi``, ``jittered_cold_starts``).
    Returns ``(report, the event's segments (ServiceRecorder), the port's
    gate residuals on the strategy it starts from, None with ``jitter``)``;
    with ``stop_at`` (``ServiceRecorder``) the run may end early, with no
    report, and the solver's state is then the event's half-done one."""
    from repro_torch.core import conditions, events, gp, traffic
    from repro_torch.serve.online import _take

    b = ev.member
    if state is not None:
        load_member_state(solver, b, inst, state)
    gate = None
    if jitter is not None:
        jitter_phi(solver, b, jitter)
    else:
        after, eff = events.apply_event(solver.member(b), ev)
        phi = _take(solver.carry.phi, b)
        if eff.topology:
            phi = traffic.repair_phi(after, phi, gp.init_phi(after))
        gate = conditions.per_app_residual(after, phi)
    rep = None
    with ServiceRecorder(stop_at) as rec, (jittered_cold_starts(jitter) if jitter is not None
                                           else contextlib.nullcontext()):
        try:
            rep = solver.process(ev)
        except Enough:
            pass
    return rep, rec.segments, gate


def checkpoint(solver) -> dict:
    """The service's whole state (its tensors are never written in place,
    so references suffice), the fault injector's draws included."""
    import copy

    ck = {k: copy.copy(v) for k, v in vars(solver).items()
          if k not in ("fault_injector", "metrics", "tracer")}
    inj = solver.fault_injector
    if inj is not None:
        ck["_injector"] = (copy.deepcopy(inj._rng.bit_generator.state), list(inj.log))
    return ck


def restore(solver, ck: dict) -> None:
    """Put a ``checkpoint`` back."""
    import copy

    for k, v in ck.items():
        if k != "_injector":
            setattr(solver, k, copy.copy(v))
    if "_injector" in ck:
        state, log = ck["_injector"]
        solver.fault_injector._rng.bit_generator.state = copy.deepcopy(state)
        solver.fault_injector.log = list(log)


def replay(solver, seg, ns) -> dict:
    """The member of a recorded segment (``ServiceRecorder``) after each
    count of committed steps in ``ns``, reached again in one pass by the
    same steps from the segment's start: ``{n: (instance, carry, app_mask,
    (allowed_e, allowed_c))}`` of the one member, without a member dim.  In
    the fleet's cold start the whole batch runs again and the member's lane
    is taken."""
    import torch
    from repro_torch.core import engine
    from repro_torch.serve.online import _take

    if "batch" in seg:
        inst, carry, am = seg["batch"]
        ae = ac = None
    else:
        inst, carry = seg["instance"], seg["start_carry"]
        am = (None if seg["app_mask"] is None
              else torch.as_tensor(seg["app_mask"], device=inst.device))
        ae, ac = seg["allowed"] or (None, None)
    out, done = {}, 0
    for n in sorted(set(ns)):
        if n > done:
            carry, *_ = engine.scan_chunk(inst, carry, solver._alpha, solver.tol,
                                          solver.patience, solver.max_iters, ae, ac,
                                          length=n - done, accel=solver._accel, app_mask=am)
            done = n
        if "batch" in seg:
            i = seg["lane"]
            out[n] = (seg["instance"], _take(carry, i), None if am is None else am[i],
                      (None, None))
        else:
            out[n] = (inst, carry, am, (ae, ac))
    return out


def float64_tie(solver, seg, step: int, ref_rung: int, start) -> float:
    """For a decision flip at ``step`` of a recorded segment: the port's
    carry before that step (``start``, from ``replay``), and from it the step recomputed in
    float64 on the CPU (the plain versions of the kernels; the Anderson
    mix's products in float32, as the engine forms them, its candidate
    costed in float64).  Returns the relative difference of the two float64
    choices' costs: for a rung flip the port's and the reference's
    (``ref_rung``) rungs, for an Anderson flip the mixed and the plain
    candidate."""
    from repro_torch.core import engine

    inst, carry, am, (ae, ac) = start
    i64, _ = _cpu64(inst, carry.phi)
    # the Anderson window stays float32: the engine forms the mix's products
    # in float32 by design (``engine._flat_phi``)
    c64 = type(carry)(*(type(v)(*(x.detach().cpu().double() for x in v))
                        if isinstance(v, tuple) else
                        (v.detach().cpu().double() if v.is_floating_point() and v.ndim == 0
                         else v.detach().cpu())
                        for v in carry))
    cpu = (lambda m: None if m is None else m.cpu())
    *_, rec = engine.scan_chunk(i64, c64, solver._alpha.double().cpu(), solver.tol,
                                solver.patience, solver.max_iters, cpu(ae), cpu(ac), length=1,
                                accel=solver._accel, app_mask=cpu(am), record=True)
    lc = rec["ladder_costs"][0].numpy()
    if int(seg["rung"][step - 1]) != ref_rung:
        a, b = lc[int(seg["rung"][step - 1])], lc[ref_rung]
    else:
        a, b = float(rec["mix_cost"][0]), lc[int(rec["rung"][0])]
    return float(abs(a - b) / abs(b))


# Departure kinds that are one step's decision (``segment_parity``).
FLIP_KINDS = ("rung", "rung-tie", "anderson", "anderson-tie")
# How many steps before a departure the ``step`` witness's runs start.
STEP_BACKS = (1, 2, 4, 8, 16)


def step_witness(solver, ref_seg, step: int, kind: str, back: int, start) -> dict:
    """A departure at ``step`` of a recorded segment against runs that
    differ from the port's only by float32 rounding: the port's carry
    ``back`` steps before it (``start``, from ``replay``) with its strategy
    moved by one ulp (``_mover``, seeds ``WITNESS_SEEDS``), run ``back``
    steps.  It holds
    where a moved run stays on the reference's run up to the step (the same
    decisions, costs within ``SYNC_TOL``) and there takes the reference's
    decision (its rung or Anderson verdict: a flip, ``FLIP_KINDS``) or its
    cost within ``SYNC_TOL`` (a parting, ``part``); and, for a parting with
    ``back`` 1, where the moved steps' costs spread from the port's own by
    at least the port's gap to the reference's: float32 rounding of the
    step's input alone moves its cost as far as the two runs lie apart.
    Returns ``{"ok", "seed", "back", "spread", "gap"}``."""
    from repro_torch.core import engine

    inst, carry, am, (ae, ac) = start

    def run(c):
        _, cs, _, r = engine.scan_chunk(inst, c, solver._alpha, solver.tol, solver.patience,
                                        solver.max_iters, ae, ac, length=back,
                                        accel=solver._accel, app_mask=am, record=True)
        return (cs.cpu().numpy().astype(np.float64), r["rung"].cpu().numpy(),
                r["anderson"].cpu().numpy())

    def ref(j):
        return (float(ref_seg["cost_history"][j]), int(ref_seg["rung"][j - 1]),
                float(ref_seg["anderson"][j - 1]))

    base = run(carry)[0][-1]
    gap = _rel(base, ref(step)[0])
    spread = 0.0
    for seed in WITNESS_SEEDS:
        costs, rungs, accs = run(carry._replace(phi=_mover(seed)(carry.phi)))
        on = all(_rel(costs[i], ref(j)[0]) <= SYNC_TOL and (rungs[i], accs[i]) == ref(j)[1:]
                 for i, j in enumerate(range(step - back + 1, step)))
        spread = max(spread, _rel(costs[-1], base))
        want = ref(step)
        if on and ((kind.startswith("rung") and rungs[-1] == want[1])
                   or (kind.startswith("anderson") and accs[-1] == want[2])
                   or (kind == "part" and (_rel(costs[-1], want[0]) <= SYNC_TOL
                                           or (back == 1 and spread >= gap)))):
            return {"ok": True, "seed": seed, "back": back, "spread": spread, "gap": gap}
    return {"ok": False, "seed": None, "back": back, "spread": spread, "gap": gap}


def _later(a, b) -> bool:
    """Departure ``a`` (``segments_departure``; None for none) comes after
    ``b``."""
    return a is None or (b is not None and a[:2] > b[:2])


def departure_witness(solver, port_segs, ref_segs, runs=(), **kw) -> dict:
    """The witness an event's departure needs: evidence that float32
    rounding, not the port, decides it.  Tried in order of cost:

      * ``float64`` — a decision flip whose two choices' costs at the
        port's carry, recomputed in float64 (``float64_tie``), lie within
        ``FLIP_TIE`` of each other: the problem itself does not decide;
      * ``step`` — from the port's carry ``back`` steps before the
        departure (``STEP_BACKS``, shortest first) with its strategy moved
        by one ulp, a run that stays on the reference's run and at the
        departing step takes the reference's decision or cost, or, one step
        back at a parting, moves that step's cost as far as the reference's
        lies (``step_witness``);
      * ``branch`` — one of ``runs`` (an iterable of segment lists of runs
        of the event that differ from the port's only by float32 rounding:
        one-ulp starts, another batch composition; made lazily) departs
        from the reference's run later than the port's run does, or not at
        all: it takes the reference's branch.

    Returns ``{"ok", "kind", "departure", ...}`` with each witness's
    numbers."""
    d = segments_departure(port_segs, ref_segs, **kw)
    w = {"ok": False, "kind": None, "departure": d}
    if d is not None and d[1] > 0 and d[2] in FLIP_KINDS + ("part",):
        seg, rseg = port_segs[d[0]], ref_segs[d[0]]
        backs = [b for b in STEP_BACKS if b <= d[1]]
        starts = replay(solver, seg, [d[1] - b for b in backs])
        if d[2] in FLIP_KINDS:
            w["float64_rel"] = float64_tie(solver, seg, d[1], int(rseg["rung"][d[1] - 1]),
                                           starts[d[1] - 1])
            if w["float64_rel"] <= FLIP_TIE:
                return dict(w, ok=True, kind="float64")
        for back in backs:
            w["step"] = step_witness(solver, rseg, d[1], d[2], back, starts[d[1] - back])
            if w["step"]["ok"]:
                return dict(w, ok=True, kind="step")
    if d is None:
        return w
    for n, run in enumerate(runs):
        if _later(segments_departure(run, ref_segs, **kw), d):
            return dict(w, ok=True, kind="branch", run=n)
    return w


def service_witness(solver, state, inst, ev, port_segs, ref_segs, **kw) -> dict:
    """``departure_witness`` for one event, its ``branch`` runs from one-ulp
    starts (``forced_event(jitter=seed)`` from ``state`` / ``inst`` as
    there, seeds ``WITNESS_SEEDS``, each only as far as the port's
    departure).  With ``state`` None the runs start from the solver's
    current state (a ``checkpoint`` before the event), which is put back
    before each run and left as it was found."""
    ck = checkpoint(solver) if state is None else None
    d = segments_departure(port_segs, ref_segs, **kw)
    stop_at = d[:2] if d is not None and d[1] > 0 else None

    def runs():
        for seed in WITNESS_SEEDS:
            if ck is not None:
                restore(solver, ck)
            yield forced_event(solver, state, inst, ev, jitter=seed, stop_at=stop_at)[1]

    try:
        return departure_witness(solver, port_segs, ref_segs, runs(), **kw)
    finally:
        if ck is not None:
            restore(solver, ck)


def solve_segment(res, phase="cold-start") -> dict:
    """A ``gp.solve(record=True)`` result as a segment (``ServiceRecorder``)."""
    return {"phase": phase, "budget": None, "iterations": int(res.iterations),
            "cost_history": _arr(res.cost_history), "residual_history":
            _arr(res.residual_history), **{k: _arr(v) for k, v in res.records.items()}}


# tests/test_online.py's bounds on its sequence, per event: the served cost
# at most this far above the cold accelerated solve, relative
SEQ_COLD_BOUNDS = (10 * 1e-4, 1e-2, 1e-2, 1e-2)


def cold_witness(solver, port_seg, ref_seg, *, alpha, tol, patience=40, max_iters=400,
                 accel=True, **kw) -> dict:
    """``departure_witness`` for a member's departure in the fleet's
    batched cold start, its ``branch`` runs the member solved alone
    (``gp.solve``, a batch of one: another batch composition than the
    fleet's) and from one-ulp starts (seeds ``WITNESS_SEEDS``), each only
    one step past the departure."""
    from repro_torch.core import gp

    inst = port_seg["instance"]
    d = segment_parity(port_seg, ref_seg, tol=tol, patience=patience, max_iters=max_iters,
                       **kw)["departure"]
    budget = max_iters if d is None else min(max_iters, d[0] + 1)

    def runs():
        for seed in (None,) + tuple(WITNESS_SEEDS):
            phi0 = gp.init_phi(inst) if seed is None else _mover(seed)(gp.init_phi(inst))
            res = gp.solve(inst, phi0, alpha=alpha, tol=tol, patience=patience,
                           max_iters=budget, accel=accel, record=True,
                           device=inst.device.type)
            yield [solve_segment(res)]

    return departure_witness(solver, [port_seg], [ref_seg], runs(), tol=tol,
                             patience=patience, max_iters=max_iters, **kw)


def _line(t, ev, rep, row) -> dict:
    ref = row["report"]
    return {"t": t, "event": type(ev).__name__, "member": ev.member, "status": rep.status,
            "reference_status": ref["status"], "iterations": rep.iterations,
            "reference_iterations": ref["iterations"], "cost": rep.cost,
            "reference_cost": ref["cost"], "incumbent_cost": rep.incumbent_cost,
            "rungs": list(rep.rungs), "reference_rungs": ref["rungs"],
            "injected": rep.injected, "cold_restart": rep.cold_restart,
            "wall_s": rep.wall_s}


def _witness_line(w) -> dict:
    out = {k: w.get(k) for k in ("ok", "kind", "run", "float64_rel")}
    if w.get("step"):
        out.update(step_back=w["step"]["back"], step_spread=w["step"]["spread"],
                   step_gap=w["step"]["gap"], step_seed=w["step"]["seed"])
    return out


def survival_breaches(key, solver, rep, *, lkg_margin=1e-4) -> list:
    """``run_chaos``'s survival claims on one event's report
    (``benchmarks/online_bench.py``): the served cost at most ``lkg_margin``
    (relative) above the incumbent unless the event is ``rejected``, and the
    member left neither corrupt nor non-finite (``verify_member``)."""
    out = []
    if (rep.status != "rejected" and np.isfinite(rep.incumbent_cost)
            and not rep.cost <= rep.incumbent_cost * (1 + lkg_margin)):
        out.append(f"{key}: served {rep.cost} above the incumbent {rep.incumbent_cost}")
    h = solver.verify_member(rep.member)
    if h.corrupt or not np.isfinite(h.cost):
        out.append(f"{key}: member {rep.member} left corrupt or non-finite: {h}")
    return out


def service_forced_pass(z, part, solver, members, *, events=None, tol=1e-4,
                        plateau_res=2e-3, lkg_margin=1e-4) -> dict:
    """Teacher-forced parity over a stored run (``trace50``): every event of
    ``events`` (default: every stored one) processed by the port's service
    from the reference's pre-event state (``forced_event``), under
    ``event_parity`` with the port's gate on the reference's strategy.  An
    event that departs needs a witness (``service_witness``); every event,
    departed or not, is held to the survival claims (``survival_breaches``).
    ``members`` is the run's padded fleet before the first event.  Returns
    ``{"lines", "breaches"}``."""
    import time

    from repro_torch.core import events as tev

    js = service_run(z, part)
    members = list(members)
    kw = dict(tol=tol, plateau_res=plateau_res)
    lines, breaches = [], []
    for t, ev in enumerate(event_from_dict(e) for e in js["events"]):
        pre = members[ev.member]
        members[ev.member], _ = tev.apply_event(pre, ev)
        st = service_state(z, part, t)
        if (events is not None and t not in events) or not st:
            continue
        t0 = time.perf_counter()
        rep, segs, gate = forced_event(solver, st, pre, ev)
        secs = time.perf_counter() - t0
        row = js["per_event"][t]
        rsegs = [service_segment(z, part, n) for n in row["segments"]]
        ep = event_parity(rep, row, segs, rsegs, gate_tol=tol, port_gate=gate, **kw)
        line = dict(_line(t, ev, rep, row), verdict=ep["verdict"], departure=ep["departure"],
                    tied=ep["tied"], fields=ep["fields"], seconds=secs)
        breaches += [f"{(part, t)}: {w}" for w in ep["why"]]
        breaches += survival_breaches((part, t), solver, rep, lkg_margin=lkg_margin)
        if ep["verdict"] != "match":
            w = service_witness(solver, st, pre, ev, segs, rsegs, **kw)
            line["witness"] = _witness_line(w)
            if not w["ok"]:
                breaches.append(f"{(part, t)}: departure {ep['departure']} has no witness: "
                                f"{line['witness']}")
        line["witness_seconds"] = time.perf_counter() - t0 - secs
        lines.append(line)
    return {"lines": lines, "breaches": breaches}


def service_free_run(z, part, make_solver, *, alpha=0.1, tol=1e-4, plateau_res=2e-3,
                     max_iters=400, lkg_margin=1e-4, cold_parity=None, steps=None) -> dict:
    """A stored run replayed by the port's service from its own cold start
    (``make_solver()``; ``steps``: the event batches, default the run's
    events one by one).  Each member is held to the reference under
    ``event_parity`` (its cold start under ``segment_parity``) up to its
    first departure, which needs a witness (``service_witness``,
    ``cold_witness``); every event is held to the survival claims of
    ``benchmarks/online_bench.py``'s ``run_chaos`` (``survival_breaches``)
    and the final fleet to no member corrupt or non-finite.  With
    ``cold_parity`` each event's served cost is also held one-sidedly to a
    cold accelerated solve of the post-event instance: ``"run_trace"``, at
    most max(1e-4, the reference's own largest excess on the run) above it
    (``run_trace``'s parity, relative to max(1, |cold|)); or a list, per
    event, of the largest ratio ``served / cold - 1`` (``tests/
    test_online.py``'s bounds on its sequence).  The cold solve is the
    port's own (``gp.solve_batched``, the members retiring as they stop)
    where it stops with a certificate (its residual or phi fixed-point
    latch, replayed on its records), and the reference's stored cold solve
    of the same instance where the port's stops on its stall latch or
    budget.  Returns lines, breaches and totals."""
    import time

    from repro_torch.core import batch, gp

    js = service_run(z, part)
    key0 = part + "-free"
    kw = dict(tol=tol, plateau_res=plateau_res, max_iters=max_iters)
    ref_cold = [service_segment(z, part, n) for n, sg in enumerate(js["segments"])
                if sg["event"] == -1]
    breaches, lines, diverged = [], [], {}
    t0 = time.perf_counter()
    with ServiceRecorder() as rec:
        solver = make_solver()
    cold_start_s = time.perf_counter() - t0
    cold = []
    for m, (ps, rs) in enumerate(zip(rec.segments, ref_cold)):
        sp = segment_parity(ps, rs, **kw)
        breaches += [f"{(key0, 'cold', m)}: {w}" for w in sp["why"]]
        entry = {"member": m, "iterations": sp["iterations"],
                 "reference_iterations": sp["reference_iterations"],
                 "departure": sp["departure"]}
        if sp["departure"] is not None:
            d = (0,) + tuple(sp["departure"])
            diverged[m] = ("cold",) + d
            w = cold_witness(solver, ps, rs, alpha=alpha, **kw)
            entry["witness"] = _witness_line(w)
            if not w["ok"]:
                breaches.append(f"{(key0, 'cold', m)}: departure {d} has no witness: "
                                f"{entry['witness']}")
        cold.append(entry)
    rows = js["per_event"]
    if steps is None:
        steps = [[event_from_dict(e)] for e in js["events"]]
    ref_excess = max([0.0] + [(r["report"]["cost"] - r["cold"]["cost"])
                              / max(1.0, abs(r["cold"]["cost"])) for r in rows if "cold" in r])
    cold_limit = max(1e-4, ref_excess)
    t, t_run, worst_excess, after = 0, time.perf_counter(), 0.0, []
    for group in steps:
        for ev in group:
            b = ev.member
            live = b not in diverged
            ck = checkpoint(solver) if live else None
            # segments are recorded only while the member is held to the
            # reference's (recording costs host time a step)
            with (ServiceRecorder() if live else contextlib.nullcontext()) as r:
                rep = solver.process(ev)
            row = rows[t]
            line = _line(t, ev, rep, row)
            if live:
                rsegs = [service_segment(z, part, n) for n in row["segments"]]
                ep = event_parity(rep, row, r.segments, rsegs, gate_tol=tol, **kw)
                breaches += [f"{(key0, t)}: {w}" for w in ep["why"]]
                line.update(verdict=ep["verdict"], departure=ep["departure"])
                if ep["verdict"] != "match":
                    diverged[b] = (t,) + tuple(ep["departure"])
                    post = checkpoint(solver)
                    restore(solver, ck)
                    w = service_witness(solver, None, None, ev, r.segments, rsegs, **kw)
                    restore(solver, post)
                    line["witness"] = _witness_line(w)
                    if not w["ok"]:
                        breaches.append(f"{(key0, t)}: departure {ep['departure']} has no "
                                        f"witness: {line['witness']}")
            breaches += survival_breaches((key0, t), solver, rep, lkg_margin=lkg_margin)
            if cold_parity is not None:
                after.append(solver.member(b))
            lines.append(line)
            t += 1
    run_s = time.perf_counter() - t_run
    if cold_parity is not None:
        # the port's cold accelerated solve of every post-event instance, in
        # one batched solve (the members retire as they stop)
        res = gp.solve_batched(batch.pad_instances(after), alpha=alpha, tol=tol,
                               max_iters=max_iters, accel=True, record=True,
                               device=solver.device.type)
        for t, line in enumerate(lines):
            c = res.member(t)
            stop, flags = latch_replay(_hist(c), _arr(c.residual_history), tol=tol,
                                       max_iters=max_iters, alphas=_arr(c.records["alpha"]),
                                       moved=_arr(c.records["phi_delta"]))
            certified = bool(stop == c.iterations and flags and (flags[-1][1] or flags[-1][2]))
            # an uncertified cold solve (a congested member) is no optimum to
            # hold the service to: the reference's cold solve of the instance is
            cold_cost = (c.final_cost if certified or "cold" not in rows[t]
                         else float(rows[t]["cold"]["cost"]))
            if cold_parity == "run_trace":
                excess = (line["cost"] - cold_cost) / max(1.0, abs(cold_cost))
                limit = cold_limit
            else:
                excess, limit = line["cost"] / cold_cost - 1, cold_parity[t]
            line.update(cold_cost=c.final_cost, cold_iterations=c.iterations,
                        cold_certified=certified, cold_bound=cold_cost, cold_excess=excess,
                        cold_limit=limit)
            worst_excess = max(worst_excess, excess)
            if not excess <= limit:
                breaches.append(f"{(key0, t)}: served {line['cost']}, {excess} above the "
                                f"cold solve's {cold_cost} (limit {limit}; the port's "
                                f"{c.final_cost}, certified {certified})")
    final = solver.verify_fleet()
    for h in final:
        if h.corrupt or not np.isfinite(h.cost):
            breaches.append(f"{key0}: member {h.member} ends corrupt or non-finite: {h}")

    def statuses(reps):
        return dict(collections.Counter(reps))
    inj = solver.fault_injector
    return {"lines": lines, "cold": cold, "breaches": breaches,
            "diverged": {int(k): v for k, v in diverged.items()},
            "totals": {"event_iters": solver.event_iters, "cold_iters":
                       [int(x) for x in solver.cold_iters],
                       "statuses": statuses(r.status for r in solver.reports),
                       "ladder_hits": dict(solver.ladder_hits),
                       "quarantines": solver.quarantines,
                       "rollbacks": sum(r.rolled_back for r in solver.reports),
                       "injections": None if inj is None else len(inj.log),
                       "cold_excess_max": worst_excess if cold_parity else None,
                       "cold_limit": cold_limit if cold_parity == "run_trace" else None},
            "reference": {"event_iters": js["event_iters"], "cold_iters": js["cold_iters"],
                          "statuses": statuses(r["report"]["status"] for r in rows),
                          "ladder_hits": js["ladder_hits"], "quarantines": js["quarantines"],
                          "rollbacks": sum(r["report"]["rolled_back"] for r in rows),
                          "injections": len(js.get("injections", []))},
            "seconds": {"cold_start": cold_start_s, "events": run_s},
            "solver": solver, "final": final}


# ---------------------------------------------------------------------------
# Card digests of the dense route's kernels
# (tests/data/torch_card_dense_digests.json, made on the card by
# tests/data/make_torch_card_digests.py)
# ---------------------------------------------------------------------------

DIGEST_LU_V = (1, 11, 22, 31, 32, 69, 100, 127, 128, 129, 130, 240)
DIGEST_CHAIN_V = (11, 22, 100, 130, 239)
CHAIN_VARIANTS = ((1, False, False), (0, True, True), (1, True, False), (0, False, True))


def dense_digest_cases():
    """The digest cases, as JSON-ready dicts.

    ``lu_factor``: seven members at each V in ``DIGEST_LU_V``, member 3
    singular (row and column min(5, V-1) zero) and member 5 scaled by
    1e-32 (finite, every pivot below ``PIVOT_TINY``); then 1080 members at
    V=100 (more than one wave of thread blocks) with members 17 and 500
    singular.  ``chain_solve``: nine chains of three stages at each V in
    ``DIGEST_CHAIN_V``, in the four trans/reverse/clamp variants, chain 4
    loopy in its middle stage; then 720 chains at V=100 (more than one
    wave) with chains 3 and 400 loopy, in the traffic and marginal
    variants.  The chain's largest V is 239: at V=240 its factor, right-hand
    side and iterate need 233,280 B of shared memory, above the card's
    232,448 B per block, and the wrapper raises.
    """
    cases = []
    for V in DIGEST_LU_V:
        cases.append({"kernel": "lu_factor", "V": V, "B": 7, "seed": 1500 + V,
                      "singular": [3], "tiny": [5]})
    cases.append({"kernel": "lu_factor", "V": 100, "B": 1080, "seed": 1599,
                  "singular": [17, 500], "tiny": []})
    for V in DIGEST_CHAIN_V:
        for n, (trans, reverse, clamp) in enumerate(CHAIN_VARIANTS):
            cases.append({"kernel": "chain_solve", "V": V, "B": 9, "K": 3,
                          "seed": 1700 + 10 * V + n, "loopy": [4], "trans": trans,
                          "reverse": reverse, "clamp": clamp})
    for trans, reverse, clamp in CHAIN_VARIANTS[:2]:
        cases.append({"kernel": "chain_solve", "V": 100, "B": 720, "K": 3,
                      "seed": 1799, "loopy": [3, 400], "trans": trans,
                      "reverse": reverse, "clamp": clamp})
    return cases


# The dense route above the shared-memory limits (the sizes of
# benchmarks/gp_scaling.py's dense leg, and V=1000): seeded cases held to
# the plain versions, no digests (``check_dense_digest(case, None)``).
DENSE_SCALE_V = (300, 600, 1000)


def dense_scale_cases():
    """``lu_factor``: seven members at each V in ``DENSE_SCALE_V``, member 3
    singular and member 5 tiny, as in :func:`dense_digest_cases`;
    ``chain_solve``: three chains of three stages, chain 1 loopy in its
    middle stage, in the four trans/reverse/clamp variants (one seed per V,
    so the variants share their inputs)."""
    cases = []
    for V in DENSE_SCALE_V:
        cases.append({"kernel": "lu_factor", "V": V, "B": 7, "seed": 3100 + V,
                      "singular": [3], "tiny": [5]})
        for trans, reverse, clamp in CHAIN_VARIANTS:
            cases.append({"kernel": "chain_solve", "V": V, "B": 3, "K": 3,
                          "seed": 3300 + V, "loopy": [1], "trans": trans,
                          "reverse": reverse, "clamp": clamp})
    return cases


def dense_scale_digest_cases():
    """The cases of ``tests/data/torch_card_dense_scale_digests.json``: every
    case of :func:`dense_scale_cases`; at each V in ``DENSE_SCALE_V``
    ``lu_solve`` by strips on four members, member 2 loopy, trans 1 and 0
    (one seed per V, so the two share their inputs); ``lu_factor`` at
    V = 1100 and 1614 (four CTAs a cluster, up to the largest V it takes)
    on three members, member 1 singular and member 2 tiny; and
    ``chain_solve`` at V = 2049 (one block a chain by strips, the first V
    above the clusters) on two chains of two stages, chain 1 loopy in its
    last stage, in the four trans/reverse/clamp variants."""
    cases = dense_scale_cases()
    for V in DENSE_SCALE_V:
        for trans in (1, 0):
            cases.append({"kernel": "lu_solve", "V": V, "B": 4, "seed": 3500 + V,
                          "loopy": [2], "trans": trans})
    for V in (1100, 1614):
        cases.append({"kernel": "lu_factor", "V": V, "B": 3, "seed": 3100 + V,
                      "singular": [1], "tiny": [2]})
    for trans, reverse, clamp in CHAIN_VARIANTS:
        cases.append({"kernel": "chain_solve", "V": 2049, "B": 2, "K": 2, "seed": 3300 + 2049,
                      "loopy": [1], "trans": trans, "reverse": reverse, "clamp": clamp})
    return cases


def case_id(case) -> str:
    """A short name of a digest case, for test ids and report lines."""
    if case["kernel"] == "lu_factor":
        return f"lu_factor-V{case['V']}-B{case['B']}"
    if case["kernel"] == "lu_solve":
        return f"lu_solve-V{case['V']}-B{case['B']}-t{case['trans']}"
    return (f"chain_solve-V{case['V']}-B{case['B']}-t{case['trans']}"
            f"{'r' if case['reverse'] else ''}{'c' if case['clamp'] else ''}")


def np_lu_factor(mats):
    """The unpivoted elimination in numpy float32 (a chain case's factors:
    fixed by numpy alone, whatever kernel is under test)."""
    a = np.array(mats, dtype=np.float32)
    V = a.shape[-1]
    with np.errstate(all="ignore"):
        for k in range(V - 1):
            l = a[:, k + 1:, k] / a[:, k, k, None]
            a[:, k + 1:, k] = l
            a[:, k + 1:, k + 1:] -= l[:, :, None] * a[:, k, None, k + 1:]
    return a


_INPUT_KEYS = ("kernel", "V", "B", "K", "seed", "singular", "tiny", "loopy")


def digest_key(case):
    """What a digest case's inputs depend on (cases differing only in
    trans/reverse/clamp share them), hashable."""
    return tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in case.items() if k in _INPUT_KEYS)


def digest_inputs(case):
    """{name: float32 array} of a digest case, from its seed (cached: the
    two large chain cases share their inputs; do not write to them)."""
    return _digest_inputs(digest_key(case))


@functools.lru_cache(maxsize=2)
def _digest_inputs(key):
    case = dict(key)
    rng = np.random.default_rng(case["seed"])
    V = case["V"]
    if case["kernel"] == "lu_factor":
        mats = stage_mats(rng, case["B"], V)
        z = min(5, V - 1)
        for b in case["singular"]:
            mats[b, :, z] = 0.0
            mats[b, z, :] = 0.0
        for b in case["tiny"]:
            mats[b] *= np.float32(1e-32)
        return {"mats": mats}
    if case["kernel"] == "lu_solve":
        mats = stage_mats(rng, case["B"], V, loopy=tuple(case["loopy"]))
        rhs = rng.uniform(-1.0, 2.0, (case["B"], V)).astype(np.float32)
        return {"lu": np_lu_factor(mats), "rhs": rhs}
    B, K = case["B"], case["K"]
    mats = stage_mats(rng, B * K, V, loopy=tuple(b * K + 1 for b in case["loopy"]))
    lu = np_lu_factor(mats).reshape(B, K, V, V)
    base = rng.uniform(-0.5, 2.0, (B, K, V)).astype(np.float32)
    mult = rng.uniform(0.0, 1.0, (B, K, V)).astype(np.float32)
    return {"lu": lu, "base": base, "mult": mult}


def sha256(a) -> str:
    """sha256 of an array's bytes, C order."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def check_dense_digest(case, ref, device="cuda", inputs=None):
    """Run one digest case through the port's kernels on ``device`` and
    hold it to ``ref`` (the case's entry of the digest file; None for a
    case without digests, which is held to the plain version alone);
    ``inputs``: the case's ``digest_inputs``, where made beforehand.

    Returns a report: ``inputs_equal`` (the numpy inputs' digests),
    ``outputs_equal`` (the kernel's output bytes against the card's
    digests: the factors and flags, the chain's iterates or ``lu_solve``'s
    solutions), ``ok_equal``
    (lu_factor: the kernel's flags against ``factor_ok`` of its factors),
    ``max_abs_diff`` and ``max_rel_err`` against the plain version on the
    same device (finite members; relative to max(|plain|, 1)), and the
    digests that differ.
    """
    import torch
    from repro_torch.kernels import batched_solve as bs

    inputs = digest_inputs(case) if inputs is None else inputs
    rep = {"case": case_id(case), "inputs_equal": ref is None or all(
        sha256(v) == ref["inputs"][k] for k, v in inputs.items())}
    t = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    if case["kernel"] == "lu_factor":
        got, ok = bs.lu_factor(t["mats"], with_ok=True)
        want = bs.lu_factor_plain(t["mats"])
        outputs = {"lu": got.cpu().numpy(), "ok": ok.cpu().numpy().astype(np.uint8)}
        rep["ok_equal"] = bool(torch.equal(ok, bs.factor_ok(got)))
        fin = torch.isfinite(want).all(dim=-1).all(dim=-1)
    elif case["kernel"] == "lu_solve":
        got = bs.lu_solve(t["lu"], t["rhs"], trans=case["trans"])
        want = bs.lu_solve_plain(t["lu"], t["rhs"], trans=case["trans"])
        outputs = {"x": got.cpu().numpy()}
        fin = torch.isfinite(want).all(dim=-1)
    else:
        kw = {k: case[k] for k in ("trans", "reverse", "clamp")}
        got = bs.chain_solve(t["lu"], t["base"], t["mult"], **kw)
        want = bs.chain_solve_plain(t["lu"], t["base"], t["mult"], **kw)
        outputs = {"x": got.cpu().numpy()}
        fin = torch.isfinite(want).all(dim=-1).all(dim=-1)
    rep["finite_equal"] = bool(torch.equal(
        torch.isfinite(got).reshape(got.shape[0], -1).all(dim=-1), fin))
    d = (got[fin].double() - want[fin].double()).abs()
    rep["max_abs_diff"] = float(d.max()) if d.numel() else 0.0
    rep["max_rel_err"] = (float((d / want[fin].double().abs().clamp_min(1.0)).max())
                          if d.numel() else 0.0)
    rep["differ"] = ([] if ref is None else
                     sorted(k for k, v in outputs.items() if sha256(v) != ref["outputs"][k]))
    rep["outputs_equal"] = not rep["differ"]
    return rep


# ---------------------------------------------------------------------------
# Card digests of the sparse route's chain kernel
# (tests/data/torch_card_bsr_digests.json, made on the card by
# tests/data/make_torch_card_bsr_digests.py)
# ---------------------------------------------------------------------------

# (label, topology, V, members, trans, reverse, clamp, loops)
_BSR_CASES = (
    ("metro-sw-ladder", "sw", 1000, 36, 1, False, False, False),
    ("metro-sw-traffic", "sw", 1000, 3, 1, False, False, False),
    ("metro-sw-marginals", "sw", 1000, 3, 0, True, True, False),
    ("metro-sw-t1-reverse", "sw", 1000, 3, 1, True, False, False),
    ("metro-sw-t0-clamp", "sw", 1000, 3, 0, False, True, False),
    ("metro-geant-traffic", "geant", 1000, 3, 1, False, False, False),
    ("metro-geant-marginals", "geant", 1000, 3, 0, True, True, False),
    ("sw-queue-ladder-loopy", "sw", 100, 36, 1, False, False, True),
    ("sw-queue-marginals-loopy", "sw", 100, 36, 0, True, True, True),
)
# Loops put into stage 0 of members 1, 2 and 3 of a loopy case (as
# ``with_loops`` puts them into a ladder): a 2-cycle of gain 1 never
# settles (the sweep cap), 0.5 settles geometrically, 1e3 passes 1e12 (the
# latch at +inf).
BSR_LOOP_GAINS = (1.0, 0.5, 1e3)
BSR_LEVELS = 8


def bsr_digest_cases():
    """The ``bsr_chain`` digest cases, as JSON-ready dicts.

    Each is K=3 stages of ``B`` seeded random loop-free strategies on a
    metro topology's links (``network.small_world(V, seed=3)`` for "sw",
    the sw-queue graph at V=100; ``network.metro_geant(V, seed=11)`` for
    "geant", whose block rows are the widest, BD=27): every node draws a
    level in [0, ``BSR_LEVELS``) and splits 0.3..1 of its mass over its
    out-neighbors of a higher level, so the stage matrix is nilpotent and a
    chain settles after at most ``BSR_LEVELS`` + 1 sweeps.  The metro-sw
    ladder shape (36 members, NB=32, BD=18), the traffic, marginal and the
    other trans/reverse/clamp variants, and the congested sw-queue ladder
    with loops at the cap, the latch and between them.
    """
    return [{"kernel": "bsr_chain", "label": lab, "topo": topo, "V": V, "B": B, "K": 3,
             "seed": 2600 + n, "trans": trans, "reverse": reverse, "clamp": clamp,
             "loops": loops}
            for n, (lab, topo, V, B, trans, reverse, clamp, loops) in enumerate(_BSR_CASES)]


@functools.lru_cache(maxsize=4)
def bsr_topology(topo, V):
    """(out_nbr, out_mask, blk_nbr, blk_mask) numpy arrays of a metro graph."""
    from repro_torch.core import network

    adj = network.small_world(V, seed=3) if topo == "sw" else network.metro_geant(V, seed=11)
    out_nbr, out_mask, _, _ = network.sparse_neighbors(adj)
    blk_nbr, blk_mask = network.block_neighbors(adj)
    return out_nbr, out_mask, blk_nbr.astype(np.int64), blk_mask


def bsr_digest_inputs(case):
    """{name: array} of a ``bsr_chain`` digest case, from its seed: the
    strategies on the out-neighbor lists ``vals`` (B, K, V, D) float32,
    ``base``/``mult`` (B, K, V) float32, and the block list ``blk_nbr``."""
    rng = np.random.default_rng(case["seed"])
    B, K, V = case["B"], case["K"], case["V"]
    out_nbr, out_mask, blk_nbr, _ = bsr_topology(case["topo"], V)
    D = out_nbr.shape[1]
    level = rng.integers(0, BSR_LEVELS, (B, K, V))
    up = out_mask & (level[:, :, out_nbr] > level[..., None])
    w = rng.uniform(0.05, 1.0, (B, K, V, D)) * up
    tot = w.sum(-1, keepdims=True)
    share = rng.uniform(0.3, 1.0, (B, K, V, 1))
    vals = np.where(tot > 0, w / np.where(tot > 0, tot, 1.0) * share, 0.0).astype(np.float32)
    if case["loops"]:
        i = 0
        j = int(out_nbr[i, 0])
        back = int(np.flatnonzero(out_nbr[j] == i)[0])
        for b, gain in enumerate(BSR_LOOP_GAINS, start=1):
            vals[b, 0, i] = vals[b, 0, j] = 0.0
            vals[b, 0, i, 0] = gain
            vals[b, 0, j, back] = 1.0
    base = rng.uniform(-0.5, 2.0, (B, K, V)).astype(np.float32)
    mult = rng.uniform(0.0, 1.0, (B, K, V)).astype(np.float32)
    return {"vals": vals, "base": base, "mult": mult, "blk_nbr": blk_nbr}


def bsr_dense_phi(case, vals, device):
    """The (B, K, V, V) stage strategies of a digest case on ``device``:
    ``vals`` scattered onto the out-neighbor lists (masked slots are 0)."""
    import torch

    out_nbr, out_mask, _, _ = bsr_topology(case["topo"], case["V"])
    v = torch.from_numpy(vals).to(device)
    idx = torch.from_numpy(out_nbr.astype(np.int64)).to(device).expand(v.shape)
    B, K, V, _ = v.shape
    return torch.zeros((B, K, V, V), device=device).scatter_(-1, idx, v).contiguous()


def bsr_case_inputs(case, device):
    """(phi_e, blk_nbr, blk_mask, base, mult) tensors of a digest case."""
    import torch

    inp = bsr_digest_inputs(case)
    _, _, blk_nbr, blk_mask = bsr_topology(case["topo"], case["V"])
    return (bsr_dense_phi(case, inp["vals"], device),
            torch.from_numpy(blk_nbr).to(device), torch.from_numpy(blk_mask).to(device),
            torch.from_numpy(inp["base"]).to(device), torch.from_numpy(inp["mult"]).to(device))


def check_bsr_digest(case, ref, device="cuda", plain=True):
    """Run one ``bsr_chain`` digest case through ``chain_solve_bsr`` on
    ``device`` and hold it to ``ref`` (the case's entry of the digest file).

    Returns a report: ``inputs_equal``, ``outputs_equal`` (the iterates and
    the sweep counts against the card's digests), and with ``plain`` the
    plain version on the same device: ``plain_equal`` (its output bytes and
    sweep counts equal to the kernel's: the two share one summation order),
    ``max_abs_diff``; the sweep counts' total and largest, and the digests
    that differ.
    """
    import torch
    from repro_torch.kernels import sparse_solve as ss

    inputs = bsr_digest_inputs(case)
    rep = {"case": case["label"], "inputs_equal": all(
        sha256(v) == ref["inputs"][k] for k, v in inputs.items())}
    phi_e, blk_nbr, blk_mask, base, mult = bsr_case_inputs(case, device)
    kw = {k: case[k] for k in ("trans", "reverse", "clamp")}
    x, sweeps = ss.chain_solve_bsr(phi_e, blk_nbr, blk_mask, base, mult,
                                   with_sweeps=True, **kw)
    outputs = {"x": x.cpu().numpy(), "sweeps": sweeps.cpu().numpy()}
    rep["sweeps_total"] = int(sweeps.sum())
    rep["sweeps_max"] = int(sweeps.max())
    rep["not_finite"] = int((~torch.isfinite(x)).any(dim=-1).sum())
    if plain:
        M = phi_e.transpose(-1, -2) if case["trans"] else phi_e
        want, want_sw = ss.chain_solve_bsr_plain(ss.block_values(M, blk_nbr, blk_mask),
                                                 blk_nbr, base, mult, with_sweeps=True,
                                                 reverse=case["reverse"], clamp=case["clamp"])
        rep["plain_equal"] = bool(torch.equal(x.view(torch.int32), want.view(torch.int32))
                                  and torch.equal(sweeps, want_sw))
        fin = torch.isfinite(want) & torch.isfinite(x)
        rep["max_abs_diff"] = (float((x[fin].double() - want[fin].double()).abs().max())
                               if bool(fin.any()) else 0.0)
    rep["differ"] = sorted(k for k, v in outputs.items() if sha256(v) != ref["outputs"][k])
    rep["outputs_equal"] = not rep["differ"]
    return rep
