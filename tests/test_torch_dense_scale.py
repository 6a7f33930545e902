"""The dense route above the shared-memory limits, on the CPU side.

The dense kernels keep a stage's V x V factor in one block's shared memory
up to V = 239-241; above that each wrapper launches a variant that reads it
from global memory (``lu_factor`` by 32-column panels and ``chain_solve``
by 32-row strips, each on a cluster of CTAs, ``lu_solve`` by strips in one
block).  The blocked-set kernels take a cluster of CTAs a row batch above
V = 128, a CTA for each 32-row word of the bitset.  Which variant runs, its cluster size and
the shared memory it takes are host logic, held here at V = 100 to 2049
(the card test ``test_launch_plans_match_the_kernels`` holds the bytes and
cluster sizes to the CUDA sources); a plan raises only where even the
global-memory layout does not fit.  And the dense route agrees with the
sparse route on one ladder step of ``metro_instance("sw", 300)`` (the
smallest size of ``benchmarks/gp_scaling.py``'s dense leg), through the
plain versions: rung costs, chosen rung, residual and every candidate's
flows within 1e-5; and, at V=300, with the reference's ``solver="dense"`` solve
(``tests/data/torch_ref_dense_sw300.npz``): traffic and marginals at
``init_phi`` and the first two steps of a latch-off solve within 1e-5.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially

from repro_torch.core import engine, gp, marginals, network, traffic  # noqa: E402
from repro_torch.kernels import batched_solve as bs  # noqa: E402
from repro_torch.kernels import blocked_sets as bset  # noqa: E402

LIMIT = 232_448
# V: (lu_factor, chain_solve, lu_solve) variants and the blocked-set
# kernel's CTAs a row batch
VARIANTS = {
    100: ("registers", "shared", "shared", 1),
    239: ("shared", "shared", "shared", 8),
    240: ("shared", "clusters", "shared", 8),
    241: ("shared", "clusters", "strips", 8),
    300: ("clusters", "clusters", "strips", 16),
    600: ("clusters", "clusters", "strips", 16),
    1000: ("clusters", "clusters", "strips", 16),
}
# V: (lu_factor's, chain_solve's) CTAs a cluster
CLUSTERS = {240: (None, 2), 241: (None, 2), 256: (2, 2), 257: (2, 2), 300: (2, 2),
            512: (2, 2), 513: (2, 4), 600: (2, 4), 1000: (2, 4), 1024: (2, 4),
            1025: (4, 8), 1614: (4, 8), 2048: (None, 8), 2049: (None, None)}
# lu_factor's clusters: 128 staged rows of L (36 floats each), sixteen U12
# blocks and the 32 x 33 L11 block
LU_UPDATE_BYTES = 4 * (128 * 36 + 16 * 32 * 32 + 32 * 33)


@pytest.mark.parametrize("V", sorted(VARIANTS))
def test_dense_launch_plans_by_node_count(V):
    lu_v, chain_v, solve_v, tag_c = VARIANTS[V]
    tile = 4 * V * (V | 1)
    plan = bs.lu_factor_plan(V)
    assert plan["variant"] == lu_v and plan["threads"] == 256
    assert plan["smem_bytes"] == {"registers": 2048 + tile, "shared": tile,
                                  "clusters": LU_UPDATE_BYTES}[lu_v]
    plan = bs.chain_solve_plan(V)
    assert plan["variant"] == chain_v
    assert plan == ({"variant": "shared", "threads": 128, "chunks": -(-V // 32),
                     "cluster": None, "smem_bytes": 4 * (64 + V * (V | 1) + 2 * V)}
                    if chain_v == "shared"
                    else {"variant": "clusters", "threads": 256, "chunks": None,
                          "cluster": plan["cluster"],
                          "smem_bytes": 4 * (2 * V + 32 + 8 * 32 * 33)})
    plan = bs.lu_solve_plan(V)
    assert plan["variant"] == solve_v
    assert plan["smem_bytes"] == (4 * (V * (V | 1) + V) if solve_v == "shared"
                                  else 4 * (V + 32 * 33))
    _, W = bset.padded_nodes(V)
    plan = bset.blocked_dense_plan(V)
    wr = -(-W // tag_c)
    assert plan == {"cluster": tag_c, "words": wr, "threads": 512,
                    "smem_bytes": 4 * (-(-V // 4) * 4 + 2 * W * 32 * wr + wr + 2 * W + 2)}
    # one CTA up to V = 128, else a CTA a bitset word, at most 16
    assert (tag_c == 1) == (V <= 128) and (V <= 128 or tag_c * 32 >= V or tag_c == 16)
    for p in (bs.lu_factor_plan(V), bs.chain_solve_plan(V), bs.lu_solve_plan(V),
              bset.blocked_dense_plan(V)):
        assert p["smem_bytes"] <= LIMIT


@pytest.mark.parametrize("V", sorted(CLUSTERS))
def test_cluster_plans_by_node_count(V):
    """A cluster of CTAs a member (``lu_factor``: every CTA owns at most 16
    of the ceil(V / 32) panels; 2 CTAs up to V = 1024, 4 above) and a chain
    (``chain_solve``: the least power of two from 2 that gives each 32-row
    strip one of a CTA's 8 warps, up to V = 2048; above, one block a chain
    by strips)."""
    lu_c, chain_c = CLUSTERS[V]
    if V <= 1614:
        plan = bs.lu_factor_plan(V)
        assert plan["cluster"] == lu_c
        if lu_c is not None:
            assert lu_c * 16 >= -(-V // 32) and (lu_c == 2 or lu_c * 8 < -(-V // 32))
            assert plan["smem_bytes"] == LU_UPDATE_BYTES
    plan = bs.chain_solve_plan(V)
    assert plan["cluster"] == chain_c
    if chain_c is not None:
        assert plan["variant"] == "clusters" and plan["threads"] == 256
        assert chain_c * 8 >= -(-V // 32) and (chain_c == 2 or chain_c * 4 < -(-V // 32))
    else:
        assert plan["variant"] in ("shared", "strips")
        if V > 2048:
            assert plan == {"variant": "strips", "threads": 256, "chunks": None,
                            "cluster": None, "smem_bytes": 4 * (2 * V + 32 * 33)}


def test_each_variant_takes_over_where_the_last_stops_fitting():
    """The shared-memory variants run wherever they fit, to the byte."""
    assert bs.lu_factor_plan(241)["smem_bytes"] <= LIMIT < 4 * 242 * 243
    assert bs.chain_solve_plan(239)["smem_bytes"] <= LIMIT < 4 * (64 + 240 * 241 + 480)
    assert bs.lu_solve_plan(240)["smem_bytes"] <= LIMIT < 4 * (241 * 241 + 241)
    assert bset.blocked_dense_plan(128)["cluster"] == 1
    assert bset.blocked_dense_plan(129)["cluster"] == 8


@pytest.mark.parametrize("fn,V", [(bs.lu_factor_plan, 1615), (bs.chain_solve_plan, 28_529),
                                  (bs.lu_solve_plan, 57_057), (bset.blocked_dense_plan, 3585)])
def test_plans_raise_only_where_the_global_layout_does_not_fit(fn, V):
    fn(V - 1)
    with pytest.raises(ValueError, match="shared memory"):
        fn(V)


def test_dense_and_sparse_routes_agree_on_a_v300_ladder_step():
    """One GP step of metro-sw V=300 at ``init_phi`` through the dense
    route (``without_sparse``: factors, chain solves and the bitset tagged
    sweep at V=300) and the sparse route (blocked sweeps, neighbor-list
    tagged sweep), plain versions on the CPU: the same rung, rung costs and
    residual within 1e-5, and every ladder candidate's stage traffic and
    flows through either route's stage solver within 1e-5."""
    sparse = network.metro_instance("sw", 300, device="cpu")
    dense = network.without_sparse(sparse)
    assert traffic.resolve_solver("auto", dense) == "batched_lu"
    assert traffic.resolve_solver("auto", sparse) == "sparse"
    phi = gp.init_phi(sparse)
    a = torch.tensor(0.1)
    sd, ss = engine.gp_step(dense, phi, a), engine.gp_step(sparse, phi, a)

    def rel(x, y):
        x, y = x.double(), y.double()
        fin = torch.isfinite(y)
        assert torch.equal(fin, torch.isfinite(x))
        return float(((x[fin] - y[fin]).abs() / y[fin].abs().clamp_min(1.0)).max())

    assert torch.equal(sd.rung, ss.rung)
    assert rel(sd.ladder_costs, ss.ladder_costs) <= 1e-5
    assert rel(sd.residual, ss.residual) <= 1e-5
    cands, _, _ = engine.ladder_candidates(sparse, phi, a)
    fd = traffic.flows(dense.lifted, cands, solver="batched_lu")
    fs = traffic.flows(sparse.lifted, cands, solver="sparse")
    for f in ("t", "g", "F", "G"):
        assert rel(getattr(fd, f), getattr(fs, f)) <= 1e-5, f


def test_dense_route_at_v300_matches_the_reference_dense_solve():
    z = np.load(os.path.join(os.path.dirname(__file__), "data", "torch_ref_dense_sw300.npz"))
    inst = network.without_sparse(network.metro_instance("sw", int(z["V"]), device="cpu"))
    phi0 = gp.init_phi(inst)
    t0, _ = traffic.stage_traffic(inst, phi0)
    pdt0 = marginals.marginals(inst, phi0).pdt
    for got, want in ((t0, z["t0"]), (pdt0, z["pdt0"])):
        want = torch.from_numpy(want).double()
        assert float(((got.double() - want).abs() / want.abs().clamp_min(1.0)).max()) <= 1e-5
    off = gp.solve(inst, phi0, alpha=0.1, max_iters=2, patience=10**6, tol=-1.0,
                   device="cpu")
    want = z["latch_off_cost_history"][:3].astype(np.float64)
    got = off.cost_history.numpy().astype(np.float64)
    assert off.iterations == 2 and np.max(np.abs(got - want) / np.abs(want)) <= 1e-5
