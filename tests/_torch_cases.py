"""Seeded numpy inputs shared by the port's kernel tests (CPU and card)."""

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
    rel = np.abs(a[:n] - b[:n]) / np.maximum(np.abs(b[:n]), 1e-30)
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


def latch_replay(costs, residuals, *, tol, patience=40, max_iters=400):
    """Replay the solve loop's stop test (residual at most ``tol``, no
    improvement above 1e-6 relative for ``patience`` iterations, the
    budget) on a cost and residual history, in float32 as the loop tests
    it.  Returns ``(stop, flags)``: the iteration the test stops at, or
    None, and per iteration (improved, residual latched)."""
    h = np.asarray(costs, dtype=np.float32)
    res = np.asarray(residuals, dtype=np.float32)
    best, stall, flags = h[0], 0, []
    for i in range(1, len(h)):
        imp = bool(h[i] < best * np.float32(1 - 1e-6))
        hit = bool(res[i - 1] <= np.float32(tol))
        flags.append((imp, hit))
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
