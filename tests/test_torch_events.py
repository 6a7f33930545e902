"""PyTorch port vs JAX reference: the event layer and the solver hooks under
it, on the CPU.

Held here, on the same numpy inputs:

  * ``events.apply_event`` for each of the six event types: every field
    bit-equal, the same ``EventEffect``, the input instance unwritten; each
    structurally invalid event raises the reference's exception type;
  * ``events.random_trace`` (seeds 0 and 1) event for event, ``replay`` and
    ``pad_fleet`` field for field; and the stored traces of
    ``tests/data/torch_ref_online.npz`` (the fig6 fleet's 50 events and the
    full-width sw-queue fleet's 16) with every post-event member;
  * ``traffic.repair_phi`` (with and without a seed strategy),
    ``strategy_violations``, ``capacity_slack``, ``marginals.dD_dphi``,
    ``conditions.per_app_residual`` and ``satisfies_kkt`` on Abilene before
    and after a ``LinkDown``: within 1e-5 of max(|reference|, 1);
  * ``engine.gp_step(app_mask=)`` from the reference's iterates (same rung,
    cost within 1e-5, the frozen applications' rows bit-equal to the
    incoming strategy's), and an accelerated ``scan_chunk(app_mask=)`` from
    a carry shared with the reference, its Anderson mixes accepted and the
    frozen rows unmoved at every step;
  * ``engine.reset_carry`` with ``keep_window`` both ways;
  * ``gp.solve_loop`` against ``gp.solve``, bit for bit;
  * the ``online-trace`` sweep over the fig6 fleet's first 6 events,
    batched and one by one, each member under ``_torch_cases.sweep_parity``
    against the reference's batched (one-by-one) cold solve with its own
    other runs (other stage solver, one by one or batched, stall latch off)
    as witnesses, batched against one by one within 1e-4; the members of
    ``_torch_cases.ONLINE_KNOWN_FAULTS["cpu"]`` must fail, and only as
    recorded (a ``TIE_BRANCH`` member with its run from a start moved by
    one ulp ending on the reference's branch);
  * the warm re-solves of the file: the port's ``repair_phi`` of the
    reference's live strategy, its gate (``per_app_residual > 1e-4``) on
    the reference's repaired strategy (``gate_parity``), the frozen rows
    unmoved, and the frozen solve under ``sweep_parity`` with the
    reference's own other runs of it (other stage solver, stall latch off)
    as witnesses; ``_torch_cases.WARM_KNOWN_FAULTS["cpu"]`` names the
    solves that must fail it, and only as recorded.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import conditions as jcond  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import gp as jgp  # noqa: E402
from repro.core import marginals as jmg  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import traffic as jtr  # noqa: E402
from repro_torch.core import conditions as tcond  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core import marginals as tmg  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.core import traffic as ttr  # noqa: E402
from repro_torch.core.traffic import Phi  # noqa: E402
from _torch_cases import (ONLINE_FIELDS, ONLINE_KNOWN_FAULTS, WARM_KNOWN_FAULTS,  # noqa: E402
                          gate_parity,
                          golden_member, golden_witnesses, jittered, known_fault_holds,
                          local_steps,
                          member_mismatches, online_meta, online_sweep_kwargs,
                          online_trace, same_event, sweep_parity, warm_case)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_ref_online.npz")
FIG6_SCALES = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}




def _fleets(scales=FIG6_SCALES, name="abilene"):
    jm = jev.pad_fleet([jnet.table_ii_instance(name, rate_scale=s) for s in scales], 2)
    tm = tev.pad_fleet([tnet.table_ii_instance(name, rate_scale=s, device="cpu")
                        for s in scales], 2)
    return jm, tm


def _same_fields(tinst, jinst):
    for f in ONLINE_FIELDS:
        got, want = getattr(tinst, f).numpy(), np.asarray(getattr(jinst, f))
        assert got.shape == want.shape, f
        if want.dtype.kind == "f":
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        else:
            assert np.array_equal(got, want), f


def _t(x):
    return torch.from_numpy(np.array(x))


def _tphi(phi):
    return Phi(e=_t(phi.e), c=_t(phi.c))


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------

def _event_cases(mod, inst):
    """One valid event of each type on the padded Abilene member ``inst``
    (the reference's): slot 3 is a spare, node 1 the first destination."""
    adj = np.asarray(inst.adj)
    i, j = (int(x) for x in np.argwhere(adj)[0])
    ni, nj = (int(x) for x in np.argwhere(~adj & ~np.eye(adj.shape[0], dtype=bool))[0])
    d0 = int(np.asarray(inst.dst)[0])
    return {
        "RateScale-app": [mod.RateScale(0, 1.5, app=1)],
        "RateScale-all": [mod.RateScale(0, 0.6)],
        "LinkDown": [mod.LinkDown(0, i, j)],
        "LinkUp": [mod.LinkDown(0, i, j), mod.LinkUp(0, i, j, capacity=12.5),
                   mod.LinkUp(0, ni, nj, capacity=3.0)],
        "NodeDown": [mod.NodeDown(0, 5), mod.NodeDown(0, d0)],
        "AppArrival": [mod.AppArrival(0, app=3, dst=4, rates=((0, 0.5), (7, 0.3)))],
        "AppDeparture": [mod.AppDeparture(0, app=0)],
    }


@pytest.mark.parametrize("kind", ["RateScale-app", "RateScale-all", "LinkDown", "LinkUp",
                                  "NodeDown", "AppArrival", "AppDeparture"])
def test_apply_event_matches_reference(kind):
    jm, tm = _fleets((1.5,))
    jinst, tinst = jm[0], tm[0]
    before = {f: getattr(tinst, f).clone() for f in ONLINE_FIELDS}
    for jev_, tev_ in zip(_event_cases(jev, jinst)[kind], _event_cases(tev, jinst)[kind]):
        jinst, jeff = jev.apply_event(jinst, jev_)
        tinst, teff = tev.apply_event(tinst, tev_)
        _same_fields(tinst, jinst)
        assert (teff.topology, teff.small, teff.dead_links, teff.shed) == \
            (jeff.topology, jeff.small, jeff.dead_links, jeff.shed)
        assert np.array_equal(teff.touched, jeff.touched)
    # the input member is not written
    for f in ONLINE_FIELDS:
        assert torch.equal(getattr(tm[0], f), before[f]), f


_INVALID = {
    "rate-zero": lambda m: [m.RateScale(0, 0.0)],
    "rate-nan": lambda m: [m.RateScale(0, float("nan"), app=0)],
    "rate-app-range": lambda m: [m.RateScale(0, 1.5, app=-1)],
    "rate-dead-slot": lambda m: [m.RateScale(0, 1.5, app=3)],
    "linkdown-missing": lambda m: [m.LinkDown(0, 0, 0)],
    "linkdown-range": lambda m: [m.LinkDown(0, 0, 11)],
    "linkup-exists": lambda m: [m.LinkUp(0, 0, 1, capacity=5.0)],
    "linkup-self": lambda m: [m.LinkUp(0, 2, 2, capacity=5.0)],
    "linkup-capacity": lambda m: [m.LinkDown(0, 0, 1), m.LinkUp(0, 0, 1, capacity=0.0)],
    "nodedown-dead": lambda m: [m.NodeDown(0, 5), m.NodeDown(0, 5)],
    "nodedown-range": lambda m: [m.NodeDown(0, 12)],
    "arrival-live-slot": lambda m: [m.AppArrival(0, app=0, dst=3)],
    "arrival-chain": lambda m: [m.AppArrival(0, app=3, dst=3, n_tasks=5)],
    "arrival-rate": lambda m: [m.AppArrival(0, app=3, dst=3, rates=((0, -1.0),))],
    "arrival-unreachable": lambda m: [m.NodeDown(0, 5), m.AppArrival(0, app=3, dst=4,
                                                                     rates=((5, 0.5),))],
    "departure-dead": lambda m: [m.AppDeparture(0, app=4)],
    "unknown-type": lambda m: ["RateScale"],
}


@pytest.mark.parametrize("case", sorted(_INVALID))
def test_invalid_events_raise_as_in_reference(case):
    jm, tm = _fleets((1.5,))
    jinst, tinst = jm[0], tm[0]
    errs = []
    for mod, inst in ((jev, jinst), (tev, tinst)):
        try:
            for ev in _INVALID[case](mod):
                inst, _ = mod.apply_event(inst, ev)
        except Exception as exc:     # noqa: BLE001  (the type is the test)
            errs.append(type(exc))
        else:
            errs.append(None)
    assert errs[0] is not None and errs[0] is errs[1], errs


@pytest.mark.parametrize("seed", [0, 1])
def test_random_trace_replay_and_pad_fleet_match_reference(seed):
    jm, tm = _fleets()
    for j, t in zip(jm, tm):
        _same_fields(t, j)
    jt = jev.random_trace(jm, n_events=25, seed=seed)
    tt = tev.random_trace(tm, n_events=25, seed=seed)
    assert len(tt) == 25 and all(same_event(a, b) for a, b in zip(tt, jt))
    for (ja, ji, jf), (ta, ti, tf) in zip(jev.replay(jm, jt), tev.replay(tm, tt)):
        _same_fields(ti, ji)
        assert np.array_equal(tf.touched, jf.touched) and tf.shed == jf.shed
    # replay keeps the earlier members as they were
    for j, t in zip(jm, tm):
        _same_fields(t, j)


@pytest.mark.parametrize("fleet", ["fig6", "sw"])
def test_stored_traces_and_members(fleet):
    z = _golden()
    kw, _ = online_sweep_kwargs(z, fleet)
    _, tm = _fleets(kw["scales"], kw["scenario"])
    trace = tev.random_trace(tm, n_events=kw["n_events"], seed=kw["seed"])
    stored = online_trace(z, fleet)
    assert len(trace) == len(stored) == kw["n_events"]
    assert all(same_event(a, b) for a, b in zip(trace, stored))
    assert member_mismatches(z, fleet, [i for _, i, _ in tev.replay(tm, trace)]) == []


def test_pad_fleet_refuses_a_sparse_member():
    inst = tnet.with_sparse(tnet.table_ii_instance("abilene", device="cpu"))
    with pytest.raises(NotImplementedError, match="Sparse batching"):
        tev.pad_fleet([inst], spare_apps=1)


# ---------------------------------------------------------------------------
# Strategy helpers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _solved():
    """The padded Abilene member (rate 2) and 30 reference GP iterations."""
    jm, _ = _fleets((2.0,))
    phi = jgp.solve(jm[0], alpha=0.1, max_iters=30, patience=10**6, tol=0.0,
                    solver="dense").phi
    return jm[0], phi


@pytest.mark.parametrize("when", ["before", "after-linkdown"])
def test_strategy_helpers_match_reference(when):
    jinst, jphi = _solved()
    _, tm = _fleets((2.0,))
    tinst, tphi = tm[0], _tphi(jphi)
    if when != "before":
        # the busiest link of application 0's first stage goes down
        i, j = np.unravel_index(np.argmax(np.asarray(jphi.e[0, 0])), jphi.e.shape[-2:])
        jinst, _ = jev.apply_event(jinst, jev.LinkDown(0, int(i), int(j)))
        tinst, _ = tev.apply_event(tinst, tev.LinkDown(0, int(i), int(j)))
    for seeded in (True, False):
        jr = jtr.repair_phi(jinst, jphi, jgp.init_phi(jinst) if seeded else None)
        tr = ttr.repair_phi(tinst, tphi, tgp.init_phi(tinst) if seeded else None)
        assert _rel(tr.e, jr.e) <= TOL and _rel(tr.c, jr.c) <= TOL
        assert float(ttr.feasibility_violation(tinst, tr)) <= 1e-6
    jv, tv = jtr.strategy_violations(jinst, jphi), ttr.strategy_violations(tinst, tphi)
    for name in jtr.StrategyViolations._fields:
        assert _rel(getattr(tv, name), getattr(jv, name)) <= TOL, name
    assert (float(tv.dead_link_mass) > 0) == (when != "before")
    jF = jtr.flows(jinst, jphi, solver="dense").F
    tF = ttr.flows(tinst, tphi).F
    assert _rel(ttr.capacity_slack(tinst, tF), jtr.capacity_slack(jinst, jF)) <= TOL
    assert _rel(ttr.capacity_slack(tinst, tF), jtr.capacity_slack(jinst, _t(tF).numpy())) <= TOL
    jge, jgc = jmg.dD_dphi(jinst, jphi)
    tge, tgc = tmg.dD_dphi(tinst, tphi)
    assert _rel(tge, jge) <= TOL and _rel(tgc, jgc) <= TOL
    jres = jcond.per_app_residual(jinst, jphi)
    tres = tcond.per_app_residual(tinst, tphi)
    assert tres.shape == (tinst.A,) and _rel(tres, jres) <= TOL
    assert float(tres[-1]) == 0.0 == float(tres[-2])      # the spare (dead) slots
    for tol in (1e-3, 1e-1, 10.0):
        assert tcond.satisfies_kkt(tinst, tphi, tol) == jcond.satisfies_kkt(jinst, jphi, tol)


def test_strategy_helpers_keep_member_dims():
    """A stacked family: each member's value is its one-member value."""
    from repro_torch.core import batch as tbatch

    _, tm = _fleets((0.5, 2.0))
    binst = tbatch.pad_instances(tm)
    phis = [tgp.init_phi(m) for m in tm]
    bphi = Phi(e=torch.stack([p.e for p in phis]), c=torch.stack([p.c for p in phis]))
    res = tcond.per_app_residual(binst, bphi)
    viol = ttr.strategy_violations(binst, bphi)
    slack = ttr.capacity_slack(binst, ttr.flows(binst, bphi).F)
    assert res.shape == (2, tm[0].A) and slack.shape == viol.simplex.shape == (2,)
    for b, (m, p) in enumerate(zip(tm, phis)):
        assert torch.equal(res[b], tcond.per_app_residual(m, p))
        assert float(slack[b]) == float(ttr.capacity_slack(m, ttr.flows(m, p).F))


# ---------------------------------------------------------------------------
# Frozen applications, reset_carry, solve_loop
# ---------------------------------------------------------------------------

MASK = np.array([True, False, True, False, False])
# at rate 2 the accelerated steps 7 and 12-14 take the Anderson mix
MASK_ACCEL = np.array([True, True, False, False, False])


def test_gp_step_app_mask_from_reference_iterates():
    jinst, _ = _solved()
    _, tm = _fleets((2.0,))
    tinst = tm[0]
    jstep = jax.jit(functools.partial(jeng.gp_step, solver="dense"))
    jmask, tmask = jnp.asarray(MASK), torch.from_numpy(MASK)
    phi, moved = jgp.init_phi(jinst), False
    for _ in range(8):
        js = jstep(jinst, phi, 0.1, app_mask=jmask)
        tphi = _tphi(phi)
        ts = teng.gp_step(tinst, tphi, torch.tensor(0.1), app_mask=tmask)
        assert int(ts.rung) == int(js.rung)
        assert _rel(ts.cost, js.cost) <= TOL and _rel(ts.residual, js.residual) <= TOL
        assert np.max(np.abs(ts.phi.e.numpy() - np.asarray(js.phi.e))) <= TOL
        # every rung's candidate keeps the frozen rows: so does the winner
        assert torch.equal(ts.phi.e[~tmask], tphi.e[~tmask])
        assert torch.equal(ts.phi.c[~tmask], tphi.c[~tmask])
        moved = moved or not torch.equal(ts.phi.e[tmask], tphi.e[tmask])
        phi = js.phi
    assert moved
    # the residual ignores the frozen apps' directions
    masked = teng.gp_step(tinst, _tphi(phi), torch.tensor(0.1), app_mask=tmask)
    free = teng.gp_step(tinst, _tphi(phi), torch.tensor(0.1))
    assert float(free.residual) >= float(masked.residual)


def test_accelerated_scan_chunk_app_mask_matches_reference():
    jinst, _ = _solved()
    _, tm = _fleets((2.0,))
    tinst = tm[0]
    acc = jeng.DEFAULT_ACCEL
    f32, i32 = jnp.float32, jnp.int32
    args = (f32(0.1), f32(1e-4), i32(40), i32(300), None, None)
    jmask, tmask = jnp.asarray(MASK_ACCEL), torch.from_numpy(MASK_ACCEL)
    c0 = jeng.init_carry(jinst, jgp.init_phi(jinst), accel=acc)
    c1, _ = jgp._scan_chunk(jinst, c0, *args, length=6, solver="dense", accel=acc,
                            app_mask=jmask)
    c2, (jcs, jrs) = jgp._scan_chunk(jinst, c1, *args, length=8, solver="dense",
                                     accel=acc, app_mask=jmask)
    carry = teng.SolveCarry(
        phi=_tphi(c1.phi), best_cost=_t(c1.best_cost), stall=_t(c1.stall).long(),
        done=_t(c1.done), iters=_t(c1.iters).long(), cost=_t(c1.cost),
        residual=_t(c1.residual), alpha=_t(c1.alpha), ax=_t(c1.ax), af=_t(c1.af),
        ak=_t(c1.ak).long())
    start = carry.phi
    costs, accepted = [], 0
    for _ in range(8):      # one step a chunk: every committed iterate seen
        carry, cs, _, rec = teng.scan_chunk(tinst, carry, torch.tensor(0.1), 1e-4, 40, 300,
                                            length=1, accel=teng.resolve_accel(True),
                                            app_mask=tmask, record=True)
        costs.append(float(cs[0]))
        accepted += int((rec["anderson"] == 1).sum())
        assert torch.equal(carry.phi.e[~tmask], start.e[~tmask])
        assert torch.equal(carry.phi.c[~tmask], start.c[~tmask])
    assert accepted >= 1
    assert _rel(costs, jcs) <= TOL
    assert np.max(np.abs(carry.phi.e.numpy() - np.asarray(c2.phi.e))) <= TOL


def test_app_mask_with_member_dims():
    """A stacked family with one mask row per member: each member's step is
    its one-member step, its own frozen rows kept."""
    from repro_torch.core import batch as tbatch

    _, tm = _fleets((1.0, 2.5))
    binst = tbatch.pad_instances(tm)
    masks = torch.tensor([[True, False, True, False, False],
                          [False, True, True, False, False]])
    phi = tgp.init_phi(binst)
    st = teng.gp_step(binst, phi, torch.tensor(0.1), app_mask=masks)
    for b, m in enumerate(tm):
        one = teng.gp_step(m, Phi(phi.e[b], phi.c[b]), torch.tensor(0.1), app_mask=masks[b])
        assert torch.equal(st.phi.e[b], one.phi.e) and torch.equal(st.cost[b], one.cost)
        assert torch.equal(st.phi.e[b][~masks[b]], phi.e[b][~masks[b]])


@pytest.mark.parametrize("keep_window", [False, True])
def test_reset_carry_matches_reference(keep_window):
    jinst, _ = _solved()
    _, tm = _fleets((2.0,))
    acc = jeng.DEFAULT_ACCEL
    f32, i32 = jnp.float32, jnp.int32
    c0 = jeng.init_carry(jinst, jgp.init_phi(jinst), accel=acc)
    c1, _ = jgp._scan_chunk(jinst, c0, f32(0.1), f32(1e-4), i32(40), i32(300), None, None,
                            length=7, solver="dense", accel=acc)
    ev = (0, 1.25, 0)
    jinst2, _ = jev.apply_event(jinst, jev.RateScale(*ev))
    tinst2, _ = tev.apply_event(tm[0], tev.RateScale(*ev))
    want = jeng.reset_carry(jinst2, c1.phi, c1, keep_window=keep_window, solver="dense")
    carry = teng.SolveCarry(
        phi=_tphi(c1.phi), best_cost=_t(c1.best_cost), stall=_t(c1.stall).long(),
        done=_t(c1.done), iters=_t(c1.iters).long(), cost=_t(c1.cost),
        residual=_t(c1.residual), alpha=_t(c1.alpha), ax=_t(c1.ax), af=_t(c1.af),
        ak=_t(c1.ak).long())
    assert int(carry.ak) == 5 and float(carry.alpha) == 0.0 and int(carry.iters) == 7
    got = teng.reset_carry(tinst2, carry.phi, carry, keep_window=keep_window)
    assert _rel(got.cost, want.cost) <= TOL and torch.equal(got.cost, got.best_cost)
    assert int(got.stall) == int(got.iters) == 0 and not bool(got.done)
    assert float(got.residual) == float("inf")
    for name in ("ax", "af", "ak", "alpha"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    assert bool((got.ax != 0).any()) == keep_window
    # the re-armed carry steps on
    nxt, cs, _ = teng.scan_chunk(tinst2, got, torch.tensor(0.1), 1e-4, 40, 300, length=2,
                                 accel=teng.resolve_accel(True))
    assert int(nxt.iters) == 2 and float(cs[-1]) <= float(got.cost)


@pytest.mark.parametrize("rate", [0.5, 2.0])
def test_solve_loop_is_solve_bit_for_bit(rate):
    inst = tnet.table_ii_instance("abilene", rate_scale=rate, device="cpu")
    kw = dict(alpha=0.1, max_iters=120, patience=15, device="cpu")
    a = tgp.solve(inst, **kw)
    b = tgp.solve_loop(inst, **kw)
    assert a.iterations == b.iterations < 120
    assert torch.equal(a.cost_history, b.cost_history)
    assert torch.equal(a.residual_history, b.residual_history)
    assert torch.equal(a.phi.e, b.phi.e) and torch.equal(a.phi.c, b.phi.c)


# ---------------------------------------------------------------------------
# The online-trace sweep and the warm re-solves
# ---------------------------------------------------------------------------

def test_online_trace_sweep_matches_reference():
    z = _golden()
    skw, gkw = online_sweep_kwargs(z, "fig6")
    skw["n_events"] = 6
    kw = dict(sweep_kwargs=skw, record=True, device="cpu", **gkw)
    bat = tsc.run_sweep("online-trace", **kw)
    ser = tsc.run_sweep_serial("online-trace", **kw)
    assert bat.n_batches == 1 and len(bat.scenarios) == 6
    stored = online_trace(z, "fig6")
    moved = {}
    for t, (sc, b, s) in enumerate(zip(bat.scenarios, bat.results, ser.results)):
        assert sc.label == f"abilene-ev{t:02d}-m{stored[t].member}"
        assert sc.meta["event"] == type(stored[t]).__name__
        assert sc.meta["base_scale"] == skw["scales"][stored[t].member]
        for way, run, own in (("batched", b, s), ("serial", s, b)):
            # a one-by-one run is held to the reference's one-by-one run
            serial = way == "serial"
            ref = golden_member(z, "fig6", "GP-serial" if serial else "GP", sc.label)
            rep = sweep_parity(run, ref, max_iters=gkw["max_iters"], own=[own],
                               local=functools.partial(local_steps, sc.instance,
                                                       alpha=gkw["alpha"]),
                               **golden_witnesses(z, "fig6", "GP", sc.label, serial=serial))
            known = ONLINE_KNOWN_FAULTS["cpu"].get(("fig6", "GP", way, sc.label))
            if known:
                # its run from a start moved by one ulp: on the CPU its
                # batched and one-by-one runs are one run, so one run
                # witnesses both lines of a TIE_BRANCH fault
                if known.get("branch_witness") and sc.label not in moved:
                    moved[sc.label] = tsc.run_sweep_serial(
                        [sc], masks_fn=jittered(), record=True, **gkw).results[0]
                wit = [sweep_parity(moved[sc.label], ref, max_iters=gkw["max_iters"],
                                    **golden_witnesses(z, "fig6", "GP", sc.label,
                                                       serial=serial))
                       ] if known.get("branch_witness") else []
                assert known_fault_holds(rep, known, wit) == [], (sc.label, way, rep, wit)
            else:
                assert rep["ok"], (sc.label, way, rep)
        assert abs(b.final_cost - s.final_cost) <= 1e-4 * abs(s.final_cost), sc.label


@pytest.mark.parametrize("t", range(12))
def test_warm_resolve_matches_reference(t):
    z = _golden()
    meta = online_meta(z)
    label = f"t{t:02d}"
    case = warm_case(z, t)
    stored = online_trace(z, "fig6")
    skw, _ = online_sweep_kwargs(z, "fig6")
    _, tm = _fleets(skw["scales"], skw["scenario"])
    members = list(tm)
    for ev in stored[: t + 1]:
        members[ev.member], _ = tev.apply_event(members[ev.member], ev)
    inst = members[stored[t].member]
    assert int(case["member"]) == stored[t].member
    live = Phi(e=torch.from_numpy(case["live_e"]), c=torch.from_numpy(case["live_c"]))
    phi0 = Phi(e=torch.from_numpy(case["phi0_e"]), c=torch.from_numpy(case["phi0_c"]))
    repaired = ttr.repair_phi(inst, live, tgp.init_phi(inst))
    assert _rel(repaired.e, phi0.e) <= TOL and _rel(repaired.c, phi0.c) <= TOL
    gate = gate_parity(tcond.per_app_residual(inst, phi0), case["residual0"], case["mask"],
                       meta["gate_tol"])
    assert gate["ok"], gate
    mask = torch.tensor(gate["mask"], dtype=torch.bool)
    kw = dict(alpha=meta["warm"]["alpha"], max_iters=meta["warm"]["max_iters"])
    res = tgp.solve(inst, phi0, app_mask=mask, record=True, device="cpu", **kw)
    frozen = ~mask
    assert torch.equal(res.phi.e[frozen], phi0.e[frozen])
    assert torch.equal(res.phi.c[frozen], phi0.c[frozen])
    rep = sweep_parity(res, case, max_iters=kw["max_iters"],
                       **golden_witnesses(z, "warm", "GP", label))
    known = WARM_KNOWN_FAULTS["cpu"].get(label)
    if known:
        assert known_fault_holds(rep, known) == [], rep
    else:
        assert rep["ok"], rep
