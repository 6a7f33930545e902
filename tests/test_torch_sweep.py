"""PyTorch port vs JAX reference: the paper's evaluation sweeps, on the CPU.

Held here:

  * ``network.connected_er`` (the networkx G(n, m) sampler over Python's
    ``random``) and ``table_ii_instance("connected-er")``: bit-equal, seeds
    0-3;
  * ``batch.pad_instances`` / ``pad_phis`` / ``unpad_phi`` / ``valid_mask``
    on ``mixed-topology``: bit-equal;
  * ``baselines.spoc_masks`` / ``lcof_masks``: bit-equal to the
    reference's on the six ``SMALL_TABLE_II`` networks, and computed on the
    padded ``mixed-topology`` family, bit-equal on each real block to the
    unpadded member's;
  * one accelerated ``engine.scan_chunk`` from a carry shared with the
    reference (its Anderson window full): costs, residuals and strategy
    within 1e-5, the window and latches equal;
  * the port's batched sweep against its one-by-one solves, every latch
    off: final costs within 1e-4 (the reference's own bound,
    ``tests/test_blocked_sets.py``);
  * Fig. 6 (GP, GP with ``accel=True``, SPOC, LCOF) and the six small
    Fig. 5 members (GP, SPOC, LCOF) against the reference's golden runs
    (``tests/data/torch_ref_sweep.npz``, ``make_torch_ref_sweep.py``)
    under ``_torch_cases.sweep_parity``: histories within 1e-5 up to a
    parting; the port's first departure (decision flip, parting or other
    count) witnessed by a float32 tie (1e-5), the stall-latch replay, or a
    run of the reference's (other stage solver, batched vs one by one) or
    of the port's own (from a start moved by one ulp) that departs as
    early; every final cost at most max(1e-5, 2 x the reference's
    dense/sparse spread, its batched/serial spread) above the reference's
    and at most that below the lowest end point of the reference's own
    runs (its stall-latch-off run counting where the port runs longer),
    lower only as a certified better solution (``_torch_cases.certify``);
    and the paper's claim, GP's final cost at most SPOC's and LCOF's (1e-5
    relative), on every member;
  * Fig. 7 (``fig7-packetsize``), the 32-seed Abilene ensemble
    (``seed-ensemble``, plain and accelerated) and ``mixed-topology``,
    batched and one by one, under the same ``sweep_parity`` with the port's
    other runs (one by one, batched, from a jittered start) and its float64
    local steps as its own witnesses; the members of
    ``_torch_cases.SWEEP_KNOWN_FAULTS["cpu"]`` are strict expected failures
    (ROADMAP Queue 3).
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbl  # noqa: E402
from repro.core import batch as jbatch  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import gp as jgp  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import scenarios as jsc  # noqa: E402
from repro_torch.core import baselines as tbl  # noqa: E402
from repro_torch.core import batch as tbatch  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.core.traffic import Phi  # noqa: E402
from _torch_cases import (HELD_SWEEPS, SWEEP_KNOWN_FAULTS, certify,  # noqa: E402
                          golden_member, golden_witnesses, jittered, known_fault_holds,
                          local_steps, sweep_parity)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_ref_sweep.npz")
CLAIM_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_connected_er_bit_equal(seed):
    assert _same(tnet.connected_er(20, 40, seed=seed), jnet.connected_er(20, 40, seed=seed))
    ref = jnet.table_ii_instance("connected-er", seed=seed)
    port = tnet.table_ii_instance("connected-er", seed=seed, device="cpu")
    for f in tnet.DENSE_FIELDS:
        assert _same(getattr(port, f).numpy(), np.asarray(getattr(ref, f))), f


def test_padding_bit_equal_on_mixed_topology():
    jfam = jsc.expand("mixed-topology")
    tfam = tsc.expand("mixed-topology", device="cpu")
    jinsts = [sc.instance for sc in jfam]
    tinsts = [sc.instance for sc in tfam]
    jb, tb = jbatch.pad_instances(jinsts), tbatch.pad_instances(tinsts)
    for f in tnet.DENSE_FIELDS:
        assert _same(getattr(tb, f).numpy(), np.asarray(getattr(jb, f))), f
    assert tb.batch_shape == (12,)
    assert _same(tbatch.valid_mask(tb, tinsts), jbatch.valid_mask(jb, jinsts))
    # the same strategies into both: the port's init_phi of each member
    tphis = [tgp.init_phi(i) for i in tinsts]
    jphis = [jgp.Phi(e=jnp.asarray(p.e.numpy()), c=jnp.asarray(p.c.numpy()))
             for p in tphis]
    jp, tp = jbatch.pad_phis(jphis, jinsts), tbatch.pad_phis(tphis, tinsts)
    assert _same(tp.e.numpy(), jp.e) and _same(tp.c.numpy(), jp.c)
    for b, inst in enumerate(tinsts):
        back = tbatch.unpad_phi(Phi(e=tp.e[b], c=tp.c[b]), inst)
        assert torch.equal(back.e, tphis[b].e) and torch.equal(back.c, tphis[b].c)
        member = tbatch.instance_slice(tb, b)
        assert member.batch_shape == () and member.V == tb.V


def test_padding_refuses_what_is_not_ported():
    inst = tnet.with_sparse(tnet.table_ii_instance("abilene", device="cpu"))
    with pytest.raises(NotImplementedError,
                       match="Queue 1, Sparse batching and the metro leftovers"):
        tbatch.pad_instances([inst])
    with pytest.raises(NotImplementedError, match="Queue 1, Multi-device"):
        tsc.solve_family([tnet.table_ii_instance("abilene", device="cpu")], mesh=object())
    with pytest.raises(ValueError, match="cost families"):
        tbatch.pad_instances([tnet.table_ii_instance(n, device="cpu")
                              for n in ("sw-queue", "sw-linear")])


def test_lpr_sc_and_fallback_match_reference():
    """LPR-SC's cost and the degradation ladder's first finite baseline."""
    jinst = jnet.table_ii_instance("abilene", rate_scale=2.0)
    tinst = tnet.table_ii_instance("abilene", rate_scale=2.0, device="cpu")
    want, got = jbl.lpr_sc(jinst), tbl.lpr_sc(tinst)
    assert got.iterations == 0
    assert abs(got.final_cost - want.final_cost) <= 1e-5 * abs(want.final_cost)
    jname, *_, jcost = jbl.fallback_strategy(jinst)
    tname, ae, ac, p0, tcost = tbl.fallback_strategy(tinst)
    assert tname == jname == "SPOC" and ac.all()
    assert abs(tcost - jcost) <= 1e-5 * abs(jcost)


@pytest.mark.parametrize("solver", ["SPOC", "LCOF"])
def test_baseline_masks_bit_equal(solver):
    jfn, tfn = jbl.BASELINE_MASKS[solver], tbl.BASELINE_MASKS[solver]
    for name in tsc.SMALL_TABLE_II:
        rate = tsc.FIG5_RATE[name]
        want = jfn(jnet.table_ii_instance(name, rate_scale=rate))
        got = tfn(tnet.table_ii_instance(name, rate_scale=rate, device="cpu"))
        for w, g in zip((want[0], want[1], want[2].e, want[2].c),
                        (got[0], got[1], got[2].e, got[2].c)):
            assert _same(g.numpy(), w), (solver, name)
    # computed on the padded family (as run_sweep does), each real block is
    # the unpadded member's masks
    tinsts = [sc.instance for sc in tsc.expand("mixed-topology", device="cpu")]
    got = tfn(tbatch.pad_instances(tinsts))
    for b, inst in enumerate(tinsts):
        ae, ac, p0 = tfn(inst)
        A, K1, V = inst.A, inst.K1, inst.V
        assert torch.equal(got[0][b, :A, :K1, :V, :V], ae)
        assert torch.equal(got[1][b, :A, :K1, :V], ac)
        back = tbatch.unpad_phi(Phi(e=got[2].e[b], c=got[2].c[b]), inst)
        assert torch.equal(back.e, p0.e) and torch.equal(back.c, p0.c)


def test_accelerated_scan_chunk_matches_reference():
    """Six reference steps with ``accel=True`` fill the Anderson window; the
    next six (mixes accepted at steps 9 and 11 there) from that shared carry."""
    jinst = jnet.table_ii_instance("abilene", rate_scale=1.5)
    tinst = tnet.table_ii_instance("abilene", rate_scale=1.5, device="cpu")
    acc = jeng.DEFAULT_ACCEL
    f32, i32 = jnp.float32, jnp.int32
    args = (f32(0.1), f32(1e-4), i32(40), i32(300), None, None)
    c0 = jeng.init_carry(jinst, jgp.init_phi(jinst), accel=acc)
    c1, _ = jgp._scan_chunk(jinst, c0, *args, length=6, solver="dense", accel=acc)
    c2, (jcs, jrs) = jgp._scan_chunk(jinst, c1, *args, length=6, solver="dense",
                                     accel=acc)

    def t(x):
        return torch.from_numpy(np.array(x))

    carry = teng.SolveCarry(
        phi=Phi(e=t(c1.phi.e), c=t(c1.phi.c)), best_cost=t(c1.best_cost),
        stall=t(c1.stall).long(), done=t(c1.done), iters=t(c1.iters).long(),
        cost=t(c1.cost), residual=t(c1.residual), alpha=t(c1.alpha),
        ax=t(c1.ax), af=t(c1.af), ak=t(c1.ak).long())
    assert int(carry.ak) == 5
    got, cs, rs, rec = teng.scan_chunk(
        tinst, carry, torch.tensor(0.1), 1e-4, 40, 300, length=6,
        accel=teng.resolve_accel(True), record=True)
    assert (rec["anderson"] == 1).sum() >= 2
    assert np.max(np.abs(cs.numpy() - np.asarray(jcs)) / np.asarray(jcs)) <= 1e-5
    # a residual is a difference of marginals: its rounding scales with them
    assert np.max(np.abs(rs.numpy() - np.asarray(jrs))
                  / np.maximum(np.abs(np.asarray(jrs)), 1.0)) <= 1e-5
    assert np.max(np.abs(got.phi.e.numpy() - np.asarray(c2.phi.e))) <= 1e-5
    assert np.max(np.abs(got.ax.numpy() - np.asarray(c2.ax))) <= 1e-5
    assert np.max(np.abs(got.af.numpy() - np.asarray(c2.af))) <= 1e-5
    for f in ("ak", "iters", "stall", "done"):
        assert int(getattr(got, f)) == int(getattr(c2, f)), f


@pytest.mark.parametrize("accel", [None, True])
def test_solve_scan_matches_reference(accel):
    """``gp.solve_scan`` (one chunk of ``max_iters`` steps, dense histories)
    against the reference's ``solve_scan`` on Abilene at rate 1, 8 steps
    (at step 10 two rungs tie at one cost with different strategies):
    histories within 1e-5 relative, the same count, strategy within 1e-5."""
    jinst = jnet.table_ii_instance("abilene")
    tinst = tnet.table_ii_instance("abilene", device="cpu")
    want = jgp.solve_scan(jinst, alpha=0.1, max_iters=8, solver="dense", accel=accel)
    got = tgp.solve_scan(tinst, alpha=0.1, max_iters=8, accel=accel, device="cpu")
    wc = np.asarray(want.cost_history, dtype=np.float64)
    assert got.cost_history.shape == wc.shape == (9,)
    assert np.max(np.abs(got.cost_history.double().numpy() - wc) / wc) <= 1e-5
    assert int(got.iterations) == int(want.iterations)
    assert np.max(np.abs(got.phi.e.numpy() - np.asarray(want.phi.e))) <= 1e-5
    assert np.max(np.abs(got.phi.c.numpy() - np.asarray(want.phi.c))) <= 1e-5


@pytest.mark.parametrize("solver", ["GP", "SPOC", "LCOF"])
def test_batched_sweep_matches_serial(solver):
    """The six small Fig. 5 members as run_sweep groups them (two padded
    families) against one gp.solve each, 30 iterations, every latch off
    (the reference's own test, ``tests/test_blocked_sets.py``).
    (The accelerated solves are held to the reference's batched and serial
    golden runs instead: the reference's own two part on most Fig. 6
    members, ``test_accelerated_serial_sweep_matches_golden``.)"""
    fam = [sc for sc in tsc.expand("fig5", device="cpu")
           if sc.label in tsc.SMALL_TABLE_II]
    kw = dict(alpha=0.1, max_iters=30, tol=-1.0, patience=10**6,
              masks_fn=tbl.BASELINE_MASKS.get(solver))
    bat = tsc.run_sweep(fam, **kw)
    ser = tsc.run_sweep_serial(fam, **kw)
    assert bat.n_batches == 2 and ser.n_batches == 6
    for sc, b, s in zip(fam, bat.results, ser.results):
        assert b.iterations == s.iterations == 30, sc.label
        assert b.phi.e.shape == (sc.instance.A, sc.instance.K1, sc.instance.V,
                                 sc.instance.V)
        rel = abs(b.final_cost - s.final_cost) / abs(s.final_cost)
        assert rel <= 1e-4, (solver, sc.label, b.final_cost, s.final_cost)


def test_solve_batched_compaction_and_dense_histories():
    """Compaction changes no member's result; histories repeat each
    member's converged values past its stop, as the reference's do."""
    fam = tsc.expand("fig6-congestion", device="cpu", scales=(0.5, 1.0, 2.0))
    binst = tbatch.pad_instances([sc.instance for sc in fam])
    kw = dict(alpha=0.1, max_iters=40, device="cpu")
    a = tgp.solve_batched(binst, compact=True, **kw)
    b = tgp.solve_batched(binst, compact=False, **kw)
    assert torch.equal(a.iterations, b.iterations)
    assert torch.equal(a.cost_history, b.cost_history)
    assert torch.equal(a.phi.e, b.phi.e)
    assert a.cost_history.shape == (3, 41) and a.residual_history.shape == (3, 40)
    n = int(a.iterations[0])
    assert n < 40 and torch.all(a.cost_history[0, n:] == a.cost[0])


@functools.lru_cache(maxsize=None)
def _jittered_sweep(fig, solver):
    """The port's batched accelerated sweep of ``fig`` from a start moved by
    one ulp (``_torch_cases.jittered``): where the port's own accelerated
    trajectory stops being fixed by float32 arithmetic, the witness the
    card's ``sweep`` phase gives every member too."""
    z = _golden()
    params = json.loads(str(z["meta"]))[fig]
    return tsc.run_sweep(tsc.expand(params["sweep"], device="cpu"), alpha=params["alpha"],
                         max_iters=params["max_iters"], record=True, accel=True,
                         masks_fn=jittered())


@functools.lru_cache(maxsize=None)
def _port_sweep(fig, solver):
    """The port's batched sweep of ``fig`` (the golden file's settings,
    Fig. 5's six small members) and each member's parity report; an
    accelerated member also has the port's run from a jittered start as its
    own witness."""
    z = _golden()
    params = json.loads(str(z["meta"]))[fig]
    kw = dict(alpha=params["alpha"], max_iters=params["max_iters"], record=True,
              masks_fn=tbl.BASELINE_MASKS.get(solver),
              accel=True if solver == "GP-accel" else None)
    fam = tsc.expand(params["sweep"], device="cpu")
    if fig == "fig5":
        fam = [sc for sc in fam if sc.label in tsc.SMALL_TABLE_II]
    res = tsc.run_sweep(fam, **kw)
    own = _jittered_sweep(fig, solver).results if solver == "GP-accel" else None
    reports = {
        sc.label: sweep_parity(r, golden_member(z, fig, solver, sc.label),
                               max_iters=params["max_iters"],
                               own=[own[i]] if own else (),
                               certify=functools.partial(certify, sc.instance, r.phi,
                                                         kw["masks_fn"]),
                               **golden_witnesses(z, fig, solver, sc.label))
        for i, (sc, r) in enumerate(zip(res.scenarios, res.results))}
    return res, reports


@pytest.mark.parametrize("fig,solver", [("fig6", "GP"), ("fig6", "GP-accel"),
                                        ("fig6", "SPOC"), ("fig6", "LCOF"),
                                        ("fig5", "GP"), ("fig5", "SPOC"),
                                        ("fig5", "LCOF")])
def test_sweep_matches_golden(fig, solver):
    _, reports = _port_sweep(fig, solver)
    bad = {k: v for k, v in reports.items() if not v["ok"]}
    assert not bad, bad


def test_accelerated_serial_sweep_matches_golden():
    """Fig. 6 with ``accel=True`` one member at a time against the
    reference's serial accelerated runs (``GP-accel-serial``).  A member's
    accelerated step does not depend on the other members of its batch
    (``engine._anderson_mix``), so the port's batched run of a member is
    its serial run, bit for bit; the port's own witness is its run from a
    jittered start (at rate 1 it takes another Anderson decision at step
    20, the port against the reference at 21)."""
    z = _golden()
    fam = tsc.expand("fig6-congestion", device="cpu")
    res = tsc.run_sweep_serial(fam, alpha=0.1, max_iters=300, accel=True, record=True)
    bat, _ = _port_sweep("fig6", "GP-accel")
    jit = _jittered_sweep("fig6", "GP-accel")
    bad = {}
    for sc, r, b, j in zip(res.scenarios, res.results, bat.results, jit.results):
        assert torch.equal(r.cost_history, b.cost_history), sc.label
        rep = sweep_parity(r, golden_member(z, "fig6", "GP-accel-serial", sc.label),
                           max_iters=300, own=[j],
                           certify=functools.partial(certify, sc.instance, r.phi),
                           **golden_witnesses(z, "fig6", "GP-accel", sc.label, serial=True))
        if not rep["ok"]:
            bad[sc.label] = rep
    assert not bad, bad


def _as_port(ref, hist, n):
    """A port result that took the reference's every decision for ``n``
    steps and wrote ``hist``."""
    from types import SimpleNamespace
    rung = np.asarray(ref["rung"][:n]).astype(np.int64)
    return SimpleNamespace(
        cost_history=np.asarray(hist, dtype=np.float32), iterations=n,
        records={"rung": rung, "ladder_costs": np.ones((n, 12), np.float32),
                 "anderson": np.asarray(ref["anderson"][:n]),
                 "mix_cost": np.full(n, np.inf, np.float32)})


def test_sweep_parity_bounds_every_final():
    """The checker itself, on Fig. 6 SPOC at rate 2 (reference: 89
    iterations; its sparse run 70, finals 6.5e-6 apart; its budget run to
    300): a copy passes; a run that stops early, or parts without a
    witness, or ends below every reference end point without a
    certificate, fails."""
    z = _golden()
    ref = golden_member(z, "fig6", "SPOC", "abilene@r2")
    wit = golden_witnesses(z, "fig6", "SPOC", "abilene@r2")
    h = np.asarray(ref["cost_history"], dtype=np.float64)
    n = int(ref["iterations"])

    def check(hist, it, **kw):
        return sweep_parity(_as_port(ref, hist, it), ref, max_iters=300, **{**wit, **kw})

    assert check(h, n)["ok"]
    # stops at step 60 (before the reference's own runs part at 70), 1e-3 high
    early = h[:61].copy()
    early[-1] = h[-1] * (1 + 1e-3)
    rep = check(early, 60)
    assert not rep["ok"] and "above" in rep["why"][-1], rep["why"]
    # parts at step 30 with every decision the reference's: no witness
    off = h.copy()
    off[30:] *= 1 + 1e-4
    assert not check(off, n)["ok"]
    # ends 1e-3 below every reference end point
    low = h.copy()
    low[-1] *= 1 - 1e-3
    low[-2] *= 1 - 1e-3
    rep = check(low, n)
    assert not rep["ok"] and "not certified" in rep["why"][-1], rep["why"]
    assert not check(low, n, certify=lambda: float(h[-1]))["ok"]
    assert check(low, n, own=[_as_port(ref, low[:-1], n - 1)],
                 certify=lambda: float(low[-1]))["ok"]


@functools.lru_cache(maxsize=None)
def _held_sweep(fig, solver):
    """The port's sweep of one of ``HELD_SWEEPS``' figures (the golden
    file's settings) batched, one by one and from a jittered start, and
    {(way, member): parity report} of the batched and one-by-one runs, each
    with the port's other two runs as its own witnesses (and its float64
    local steps where plain), as the card's ``sweep`` phase holds them."""
    z = _golden()
    params = json.loads(str(z["meta"]))[fig]
    masks_fn = tbl.BASELINE_MASKS.get(solver)
    kw = dict(alpha=params["alpha"], max_iters=params["max_iters"], record=True,
              masks_fn=masks_fn, accel=True if solver == "GP-accel" else None)
    fam = tsc.expand(params["sweep"], device="cpu")
    bat = tsc.run_sweep(fam, **kw)
    ser = tsc.run_sweep_serial(fam, **kw)
    jit = tsc.run_sweep(fam, **{**kw, "masks_fn": jittered(masks_fn)})
    reports = {}
    for way, res, own in (("batched", bat, (jit, ser)), ("serial", ser, (bat, jit))):
        for i, (sc, r) in enumerate(zip(res.scenarios, res.results)):
            sref = way == "serial" and golden_member(z, fig, solver + "-serial", sc.label)
            reports[(way, sc.label)] = sweep_parity(
                r, sref or golden_member(z, fig, solver, sc.label),
                max_iters=params["max_iters"], own=[o.results[i] for o in own],
                certify=functools.partial(certify, sc.instance, r.phi, masks_fn),
                local=(None if solver == "GP-accel" else functools.partial(
                    local_steps, sc.instance, alpha=params["alpha"], masks_fn=masks_fn)),
                **golden_witnesses(z, fig, solver, sc.label, serial=bool(sref)))
    finals = {way: {sc.label: r.final_cost for sc, r in zip(res.scenarios, res.results)}
              for way, res in (("batched", bat), ("serial", ser))}
    return reports, finals


HELD = [(fig, solver) for fig, solvers in HELD_SWEEPS.items() for solver in solvers]
KNOWN = SWEEP_KNOWN_FAULTS["cpu"]


@pytest.mark.parametrize("fig,solver", HELD)
def test_held_sweeps_match_golden(fig, solver):
    """Fig. 7 (GP, SPOC, LCOF at five packet sizes), the 32-seed ensemble
    (GP, GP with ``accel=True``) and the mixed-topology family (GP, SPOC,
    LCOF; padded groups) against the reference's golden runs, batched and
    one by one, every member under ``sweep_parity`` as it stands, except
    the known faults (``_torch_cases.SWEEP_KNOWN_FAULTS``, held by
    ``test_held_sweep_known_faults_still_fail``); batched against one by
    one within 1e-4 (the reference's own bound) where not accelerated."""
    reports, finals = _held_sweep(fig, solver)
    bad = {k: v["why"] for k, v in reports.items()
           if not v["ok"] and (fig, solver) + k not in KNOWN}
    assert not bad, bad
    if solver != "GP-accel":
        for label, c in finals["serial"].items():
            assert abs(finals["batched"][label] - c) <= 1e-4 * abs(c), label


@pytest.mark.parametrize("key", [pytest.param(k, marks=pytest.mark.xfail(
    strict=True, reason=v["reason"]), id="-".join(k)) for k, v in sorted(KNOWN.items())])
def test_held_sweep_known_faults_still_fail(key):
    fig, solver, way, label = key
    rep = _held_sweep(fig, solver)[0][(way, label)]
    assert rep["ok"], rep["why"]


@pytest.mark.parametrize("key", sorted(KNOWN), ids="-".join)
def test_held_sweep_known_faults_fail_as_recorded(key):
    """A known fault fails ``sweep_parity`` for its recorded reason only,
    within its recorded final-cost bound (``_torch_cases.known_fault_holds``)."""
    fig, solver, way, label = key
    rep = _held_sweep(fig, solver)[0][(way, label)]
    assert not known_fault_holds(rep, KNOWN[key]), (known_fault_holds(rep, KNOWN[key]), rep)


def claim_gaps(finals):
    """{(label, baseline): (GP final - baseline final) / baseline final}."""
    return {(label, base): (c - finals[base][label]) / finals[base][label]
            for label, c in finals["GP"].items() for base in ("SPOC", "LCOF")}


@pytest.mark.parametrize("fig", ["fig6", "fig5"])
def test_gp_beats_the_baselines(fig):
    """The paper's claim on every member: GP's final cost at most SPOC's
    and LCOF's (1e-5 relative), for the port's sweeps above, wherever the
    reference's golden runs have it.  Where they do not (Fig. 5
    connected-er and geant: the reference's GP stops on its stall latch
    7e-5 and 2e-5 above SPOC, both at the same optimum), GP within 1e-4."""
    z = _golden()
    finals = {s: {sc.label: r.final_cost for sc, r in zip(res.scenarios, res.results)}
              for s in ("GP", "SPOC", "LCOF") for res in [_port_sweep(fig, s)[0]]}
    ref = {s: {label: float(z[f"{fig}/{s}/{label}/cost_history"][-1])
               for label in finals["GP"]} for s in finals}
    ref_gaps = claim_gaps(ref)
    for key, gap in claim_gaps(finals).items():
        bound = CLAIM_TOL if ref_gaps[key] <= CLAIM_TOL else 1e-4
        assert gap <= bound, (key, gap, ref_gaps[key])
