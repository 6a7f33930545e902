"""PyTorch port vs JAX reference: the sparse metro path, on the CPU.

On the CPU the two metro kernels run their plain versions
(``chain_solve_bsr_plain``, ``tagged_nbr_plain``), which are held here to
the reference's own routes on the same numpy inputs:

  * topology: neighbor lists, partition, block lists and the metro
    builders bit-equal to the reference's;
  * the blocked chain solve against the neighbor-list ``chain_solve_nbr``
    and, on the marginal chain and the loopy ladder, the Pallas
    ``chain_solve_bsr`` in interpret mode (the same blocked sweeps), within
    1e-5 relative with the same +inf entries, on congested Table II
    iterates (rate_scale 2) at ``init_phi``, at a 10-iteration iterate,
    and on that iterate's 12-rung ladder candidates, also with routing
    loops put into three of them (the divergence latch and the sweep cap);
  * the neighbor-list tagged sweep bit-equal to the reference's, to the
    dense sweep and to the packed-bitset sweep;
  * flows, ``dD/dt`` and blocked sets of the sparse route against the
    reference's sparse and dense routes (1e-5; blocked sets exact);
  * dispatch: metro instances take the sparse route and never factor;
  * whole solves on ``metro_instance(..., 128)`` and on a congested
    Table II instance forced onto the sparse route: the same iteration
    count with the stall latch off and cost histories within 1e-5.

The reference's ``batched_lu`` route aborts in XLA on this jax, so it is
never an oracle here.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import gp as jgp  # noqa: E402
from repro.core import marginals as jmg  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import traffic as jtr  # noqa: E402
from repro.kernels import sparse_solve as jss  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core import marginals as tmg  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import traffic as ttr  # noqa: E402
from repro_torch.kernels import blocked_sets as tbset  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sparse_solve as tss  # noqa: E402
from _torch_cases import with_loops  # noqa: E402

SCENARIOS = ["abilene", "geant", "sw-queue"]
FIELDS = ["adj", "link_param", "comp_param", "L", "w", "wnode", "r", "dst",
          "n_tasks", "stage_mask"]
SPARSE = ["out_nbr", "out_mask", "in_nbr", "in_mask", "node_part", "blk_nbr",
          "blk_mask"]


def _rel(got, want):
    """Max |got - want| / |want| over finite entries, after checking that
    both have +inf (and no NaN) in the same places."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert not np.isnan(got).any() and not np.isnan(want).any()
    assert np.array_equal(np.isinf(got), np.isinf(want)), "inf positions"
    fin = np.isfinite(want)
    if not fin.any():
        return 0.0
    g, w = got[fin], want[fin]
    return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-9)))


def _same_fields(ref, port, names):
    for f in names:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype == np.float32:
            assert b.dtype == np.float32, f
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), f
        else:
            assert np.array_equal(a, b), f


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------

TOPO_CASES = ["metro-sw-128", "metro-sw-300", "metro-geant-128",
              "metro-geant-300"] + SCENARIOS


def _topo_pair(case):
    if case.startswith("metro-"):
        _, topo, V = case.split("-")
        return (jnet.metro_instance(topo, int(V)),
                tnet.metro_instance(topo, int(V), device="cpu"))
    return (jnet.with_sparse(jnet.table_ii_instance(case)),
            tnet.with_sparse(tnet.table_ii_instance(case, device="cpu")))


@pytest.mark.parametrize("case", TOPO_CASES)
def test_sparse_topology_bit_equal(case):
    ref, port = _topo_pair(case)
    adj = np.asarray(ref.adj)
    for a, b in zip(jnet.sparse_neighbors(adj), tnet.sparse_neighbors(adj)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jnet.graph_partition(adj), tnet.graph_partition(adj))
    for a, b in zip(jnet.block_neighbors(adj), tnet.block_neighbors(adj)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _same_fields(ref, port, FIELDS + SPARSE)
    assert port.has_sparse and port.max_degree == ref.max_degree
    assert tnet.n_edges(port) == jnet.n_edges(ref)
    bare = tnet.without_sparse(port)
    assert not bare.has_sparse and bare.max_degree == 0
    assert all(getattr(bare, f) is None for f in SPARSE)


def test_metro_adjacency_bit_equal_at_1000():
    assert np.array_equal(jnet.metro_geant(1000), tnet.metro_geant(1000))
    assert np.array_equal(jnet.small_world(1000, seed=3),
                          tnet.small_world(1000, seed=3))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("topo", ["sw", "geant"])
def test_metro_instance_bit_equal(topo, seed):
    ref = jnet.metro_instance(topo, 128, seed=seed)
    port = tnet.metro_instance(topo, 128, seed=seed, device="cpu")
    _same_fields(ref, port, FIELDS + SPARSE)
    carried = convert.instance_from_numpy(
        {f: np.asarray(getattr(ref, f)) for f in FIELDS + SPARSE},
        ref.link_kind, ref.comp_kind, device="cpu")
    _same_fields(ref, carried, FIELDS + SPARSE)


# ---------------------------------------------------------------------------
# Congested Table II iterates (the non-trivial kernel inputs)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _case(name, point):
    """(reference instance, port instance, reference phi, port phi) for a
    with_sparse Table II instance at twice its rates, at ``init_phi`` (the
    port's, bit-equal to the reference's) or after 10 steps of the
    reference's sparse-route ``gp_step`` from there (its dense route gives
    the same iterate to 1e-5 and takes four times longer to compile; ten
    jitted steps compile several times faster than the solve's chunk
    program and give its iterate).  Both sides get the same strategy, bit
    for bit."""
    ref = jnet.with_sparse(jnet.table_ii_instance(name, seed=0, rate_scale=2.0))
    port = convert.instance_from_numpy(
        {f: np.asarray(getattr(ref, f)) for f in FIELDS + SPARSE},
        ref.link_kind, ref.comp_kind, device="cpu")
    phi = tgp.init_phi(port)
    e, c = phi.e.numpy(), phi.c.numpy()
    if point == "mid10":
        step = jax.jit(functools.partial(jeng.gp_step, solver="sparse"))
        jphi = jtr.Phi(e=jnp.asarray(e), c=jnp.asarray(c))
        for _ in range(10):
            jphi = step(ref, jphi, 0.1).phi
        e, c = np.asarray(jphi.e), np.asarray(jphi.c)
    return (ref, port, jtr.Phi(e=jnp.asarray(e), c=jnp.asarray(c)),
            convert.phi_from_numpy(e, c, device="cpu"))


def _chain_inputs(name, point, variant):
    """(phi_e, base, mult, trans, reverse, clamp) of one chain call of a GP
    step, as port tensors: the traffic sweep, the marginal sweep, or the
    ladder candidates' traffic sweep (12 * A members), with routing loops
    put into three of them for "loopy" (the blocked sets keep the real
    candidates loop-free)."""
    _, port, _, phi = _case(name, point)
    if variant in ("ladder", "loopy"):
        phi, _, _ = teng.ladder_candidates(port, phi, 0.1)
    if variant == "loopy":
        phi = phi._replace(e=with_loops(phi.e, port.r, port.out_nbr))
    if variant == "marginals":
        fl = ttr.flows(port, phi)
        base = tmg.pdt_base(port, phi, ttr.link_marginals(port, fl.F),
                            ttr.comp_marginals(port, fl.G))
        return phi.e, base, phi.c, 0, True, True
    base, mult = ttr.chain_inputs(port, phi)
    return phi.e, base, mult, 1, False, False


@pytest.mark.parametrize("point,variant", [("init", "traffic"),
                                           ("init", "marginals"),
                                           ("mid10", "traffic"),
                                           ("mid10", "marginals"),
                                           ("mid10", "ladder"),
                                           ("mid10", "loopy")])
@pytest.mark.parametrize("name", SCENARIOS)
def test_chain_solve_bsr_plain_matches_reference(name, point, variant):
    _, port, _, _ = _case(name, point)
    phi_e, base, mult, trans, reverse, clamp = _chain_inputs(name, point, variant)
    K, V = base.shape[-2:]
    pe = phi_e.reshape(-1, K, V, V)
    b2, m2 = base.reshape(-1, K, V), mult.reshape(-1, K, V)
    M = pe.transpose(-1, -2) if trans else pe
    blk_nbr, blk_mask = port.blk_nbr, port.blk_mask

    bvals = tss.block_values(M, blk_nbr, blk_mask)
    want_bvals = jss.block_values(jnp.asarray(M.numpy()), jnp.asarray(blk_nbr.numpy()),
                                  jnp.asarray(blk_mask.numpy()), jss.SPARSE_BLOCK)
    assert np.array_equal(bvals.numpy(), np.asarray(want_bvals))

    kw = dict(reverse=reverse, clamp=clamp)
    got, sweeps = tss.chain_solve_bsr_plain(bvals, blk_nbr, b2, m2, with_sweeps=True, **kw)
    # the wrapper (phi_e and the block lists) gathers the same blocks
    wrapped = tss.chain_solve_bsr(pe, blk_nbr, blk_mask, b2, m2, trans=trans,
                                  with_sweeps=True, **kw)
    assert torch.equal(wrapped[0], got) and torch.equal(wrapped[1], sweeps)
    if point == "mid10" and variant in ("marginals", "loopy"):
        # the Pallas interpreter runs member by member (about 50 ms each
        # here), so it checks one case of each flag set: the reverse clamped
        # marginal chain, and application 0 at rungs 0-3 of the loopy
        # ladder, the members that hold its loops; the neighbor-list route
        # below checks every case and member
        sel = (np.arange(4) * port.A if variant == "loopy"
               else np.arange(len(b2)))
        pallas = jss.chain_solve_bsr(want_bvals[sel], jnp.asarray(blk_nbr.numpy()),
                                     jnp.asarray(b2[sel].numpy()),
                                     jnp.asarray(m2[sel].numpy()), interpret=True, **kw)
        assert _rel(got[sel].numpy(), pallas) <= 1e-5

    nbr, mask = ((port.out_nbr, port.out_mask) if trans == 0
                 else (port.in_nbr, port.in_mask))
    vals = jss.neighbor_values(jnp.asarray(pe.numpy()), jnp.asarray(nbr.numpy()),
                               jnp.asarray(mask.numpy()), trans=trans)
    by_nbr = np.asarray(jss.chain_solve_nbr(vals, jnp.asarray(nbr.numpy()),
                                            jnp.asarray(b2.numpy()),
                                            jnp.asarray(m2.numpy()), **kw))
    # +inf spreads through 0 * inf along edges (neighbor lists) or blocks
    # until the sweep stops changing, so on a connected graph a diverged
    # member ends all +inf on both routes
    assert _rel(got.numpy(), by_nbr) <= 1e-5
    fin_got = np.isfinite(got.numpy()).all(axis=(-2, -1))

    if variant in ("traffic", "marginals"):
        # the ops entry point: gather + kernel wrapper in one call
        via_ops = tops.sparse_chain_solve(phi_e, base, mult, blk_nbr, blk_mask,
                                          trans=trans, **kw)
        assert torch.equal(via_ops.reshape(got.shape), got)
    assert (sweeps >= 1).all() and (sweeps <= V + 2).all()
    if variant == "loopy":
        # rung 1 runs to the cap, rung 3 latches at +inf
        A = port.A
        assert (sweeps[A] == V + 2).any() and np.isfinite(got[A].numpy()).all()
        assert not fin_got[3 * A] and fin_got.sum() == len(fin_got) - 1


def test_chain_solve_bsr_latch_and_cap():
    """A 2-cycle that carries all of its mass never settles (its values grow
    by b each sweep): it runs to the cap V + 2.  A 2-cycle of gain 1e7
    passes 1e12 in its third sweep and latches at +inf, over its whole
    32-row block (0 * inf), which ends its loop early."""
    V = 5
    phi = np.zeros((3, 1, V, V), dtype=np.float32)
    phi[0, 0, 0, 1] = 1.0                       # loop-free chain 0 -> 1
    phi[1, 0, 0, 1] = phi[1, 0, 1, 0] = 1.0     # 2-cycle, gain 1
    phi[2, 0, 0, 1] = phi[2, 0, 1, 0] = 1e7     # 2-cycle, diverges
    nb, bm = tnet.block_neighbors(phi.sum(axis=(0, 1)) > 0)
    blk_nbr, blk_mask = torch.from_numpy(nb.astype(np.int64)), torch.from_numpy(bm)
    base = torch.ones((3, 1, V))
    mult = torch.zeros((3, 1, V))
    bvals = tss.block_values(torch.from_numpy(phi), blk_nbr, blk_mask)
    x, sweeps = tss.chain_solve_bsr(torch.from_numpy(phi), blk_nbr, blk_mask, base, mult,
                                    with_sweeps=True)
    assert torch.equal(x[0, 0], torch.tensor([2.0, 1.0, 1.0, 1.0, 1.0]))
    assert sweeps[0, 0] == 3                     # depth 1, +1 to settle, +1 first
    assert sweeps[1, 0] == V + 2 and torch.isfinite(x[1]).all()
    assert torch.isinf(x[2, 0, :2]).all() and sweeps[2, 0] < V + 2
    want = jss.chain_solve_bsr(jnp.asarray(bvals.numpy()), jnp.asarray(blk_nbr.numpy()),
                               jnp.asarray(base.numpy()), jnp.asarray(mult.numpy()),
                               interpret=True)
    assert _rel(x.numpy(), want) == 0.0


# ---------------------------------------------------------------------------
# The neighbor-list tagged sweep
# ---------------------------------------------------------------------------

def _tagged_inputs(name, point):
    """route/improper (A, K1, V, V) of an iterate under the port's
    marginals; "stale" pairs the 10-iteration routes with the marginals of
    ``init_phi``, which makes improper links that propagate."""
    _, port, _, phi = _case(name, "init" if point == "init" else "mid10")
    pdt_phi = _case(name, "init")[3] if point == "stale" else phi
    pdt = tmg.marginals(port, pdt_phi).pdt
    route = phi.e > 0.0
    worse = pdt[:, :, None, :] > pdt[:, :, :, None] + teng.BLOCK_EPS
    return port, route, route & worse, phi.e, pdt


@pytest.mark.parametrize("point", ["init", "mid10", "stale"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_tagged_nbr_plain_bit_equal(name, point):
    port, route, improper, phi_e, pdt = _tagged_inputs(name, point)
    V = port.V
    r2, i2 = route.reshape(-1, V, V), improper.reshape(-1, V, V)
    nbr, mask = port.out_nbr, port.out_mask
    idx = nbr.expand((r2.shape[0],) + nbr.shape)
    rv = torch.gather(r2, -1, idx) & mask
    iv = torch.gather(i2, -1, idx)
    got, rounds = tss.tagged_nbr_plain(rv, iv, nbr, with_rounds=True)
    want, want_rounds = jss.tagged_nbr(jnp.asarray(rv.numpy()), jnp.asarray(iv.numpy()),
                                       jnp.asarray(nbr.numpy()), with_rounds=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the reference sweeps the whole batch until its last member settles
    assert int(rounds.max()) == int(want_rounds)
    assert torch.equal(got, tbset.tagged_scan_dense(r2, i2))
    assert torch.equal(got, tops.blocked_tagged(r2, i2))
    assert torch.equal(tops.blocked_tagged_nbr(route, improper, nbr, mask),
                       got.reshape(route.shape[:-1]))
    # the sparse kernel's plain version: the same flags and round counts
    # inside the whole blocked mask
    phi_e, pdt = phi_e.reshape(-1, V, V), pdt.reshape(-1, V)
    mask_b, flags, rounds_b = tss.blocked_nbr(phi_e, pdt, port.adj[None], nbr, mask,
                                              eps=teng.BLOCK_EPS, with_rounds=True)
    assert torch.equal(flags, got) and torch.equal(rounds_b, rounds)
    assert torch.equal(mask_b, tbset.blocked_dense(phi_e, pdt, port.adj[None],
                                                   eps=teng.BLOCK_EPS))
    if point == "stale" and name != "abilene":
        assert got.any()                       # the case propagates


# ---------------------------------------------------------------------------
# Flows, marginals and blocked sets on the sparse route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", ["init", "mid10"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_flows_pdt_blocked_sets_sparse(name, point):
    ref, port, jphi, phi = _case(name, point)
    fl = ttr.flows(port, phi, solver="sparse")
    for solver in ("sparse", "dense"):
        jfl = jtr.flows(ref, jphi, solver=solver)
        for f in ("t", "g", "F", "G"):
            assert _rel(getattr(fl, f).numpy(), getattr(jfl, f)) <= 1e-5, (solver, f)
    Dp, Cp = ttr.link_marginals(port, fl.F), ttr.comp_marginals(port, fl.G)
    pdt = tmg.pdt_recursion(port, phi, Dp, Cp, solver="sparse")
    jfl = jtr.flows(ref, jphi, solver="dense")
    jDp, jCp = jmg.link_marginals(ref, jfl.F), jmg.comp_marginals(ref, jfl.G)
    for solver in ("sparse", "dense"):
        want = jmg.pdt_recursion(ref, jphi, jDp, jCp, solver=solver)
        assert _rel(pdt.numpy(), want) <= 1e-5, solver

    same_pdt = torch.tensor(np.asarray(
        jmg.pdt_recursion(ref, jphi, jDp, jCp, solver="sparse")))
    nbr = teng.blocked_sets(port, phi, same_pdt, method="nbr")
    assert torch.equal(nbr, teng.blocked_sets(port, phi, same_pdt, method="scan"))
    want = np.asarray(jeng.blocked_sets(ref, jphi, jnp.asarray(same_pdt.numpy()),
                                        method="nbr"))
    assert np.array_equal(nbr.numpy(), want)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def _forbid(monkeypatch, module, name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{name} called on the sparse route")

    monkeypatch.setattr(module, name, refuse)


def test_metro_step_takes_the_sparse_route(monkeypatch):
    inst = tnet.metro_instance("sw", 128, device="cpu")
    assert ttr.resolve_solver("auto", inst) == "sparse"
    assert ttr.resolve_solver("dense", inst) == "dense"
    with monkeypatch.context() as m:
        m.setattr(ttr, "SPARSE_MIN_V", inst.V + 1)
        assert ttr.resolve_solver("auto", inst) == "batched_lu"
    phi = tgp.init_phi(inst)
    for mod, name in ((ttr, "stage_factors"), (tops, "batched_factor"),
                      (tops, "fused_chain_solve"), (tops, "blocked_set"),
                      (tbset, "blocked_dense_plain")):
        _forbid(monkeypatch, mod, name)
    chains = _count_calls(monkeypatch, tss, "chain_solve_bsr_plain")
    tagged = _count_calls(monkeypatch, tss, "blocked_nbr_plain")
    state = tgp.gp_step(inst, phi, 0.1)
    assert torch.isfinite(state.cost)
    # traffic, marginals and the ladder: three chain launches; one sweep
    assert (len(chains), len(tagged)) == (3, 1)


def test_without_sparse_and_table_ii_stay_dense():
    inst = tnet.metro_instance("sw", 128, device="cpu")
    bare = tnet.without_sparse(inst)
    assert ttr.resolve_solver("auto", bare) == "batched_lu"
    swq = tnet.with_sparse(tnet.table_ii_instance("sw-queue", device="cpu"))
    assert swq.V < ttr.SPARSE_MIN_V
    assert ttr.resolve_solver("auto", swq) == "batched_lu"
    with pytest.raises(ValueError, match="no sparse topology"):
        ttr.flows(bare, tgp.init_phi(bare), solver="sparse")


# ---------------------------------------------------------------------------
# Whole solves
# ---------------------------------------------------------------------------

KW = dict(alpha=0.1, patience=10**6, tol=0.0)


@pytest.mark.parametrize("topo", ["sw", "geant"])
def test_metro_solve_matches_reference(topo):
    """``init_phi`` bit-equal; the stall latch off over one 32-step chunk
    (the reference compiles one chunk program for both solves), then the
    default solve: the same count, histories within 1e-5."""
    ref = jnet.metro_instance(topo, 128)
    port = tnet.metro_instance(topo, 128, device="cpu")
    jphi, phi = jgp.init_phi(ref), tgp.init_phi(port)
    assert np.array_equal(np.asarray(jphi.e), phi.e.numpy())
    assert np.array_equal(np.asarray(jphi.c), phi.c.numpy())
    want = jgp.solve(ref, jphi, max_iters=32, **KW)
    got = tgp.solve(port, phi, max_iters=32, device="cpu", **KW)
    assert got.iterations == want.iterations
    assert _rel(got.cost_history.numpy(), want.cost_history) <= 1e-5
    want = jgp.solve(ref, jphi, alpha=0.1, max_iters=400)
    got = tgp.solve(port, phi, alpha=0.1, max_iters=400, device="cpu")
    assert got.iterations == want.iterations
    assert _rel(got.cost_history.numpy(), want.cost_history) <= 1e-5


@pytest.mark.parametrize("name", ["abilene", "geant"])
def test_congested_solve_on_the_sparse_route(name, monkeypatch):
    """A congested Table II instance sent down the sparse route (threshold
    lowered below its V) against the reference's ``solver="sparse"``: 20
    iterations with the stall latch off, loopy ladder candidates and all."""
    ref, port, jphi, phi = _case(name, "init")
    monkeypatch.setattr(ttr, "SPARSE_MIN_V", 0)
    _forbid(monkeypatch, ttr, "stage_factors")
    want = jgp.solve(ref, jphi, max_iters=20, solver="sparse", blocked="nbr", **KW)
    got = tgp.solve(port, phi, max_iters=20, device="cpu", **KW)
    assert got.iterations == want.iterations == 20
    assert _rel(got.cost_history.numpy(), want.cost_history) <= 1e-5
