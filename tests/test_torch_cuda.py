"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card: it carries the ``gpu`` marker and
skips where ``torch.cuda.is_available()`` is False.  The file imports no
JAX, so it runs on a machine with PyTorch and CUDA alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  The kernels are
built from ``src/repro_torch/kernels/csrc`` with ``nvcc`` at first use.
Tolerances: 1e-5 relative for the dense float32 kernels (they sum in
another order than the plain versions and fuse multiply-adds); bit-exact
for the blocked-set kernels (mask, tagged flags, round counts) and the sweep
counts of the blocked chain solve, whose kernel and plain version share
one summation order (its values are held to 1e-5 with the same +inf
entries, and their largest difference is printed).  The attention and SSD
kernels: 2e-5 relative to the plain version's largest |value|; a forward
of a whole (reduced) model through the kernels against the same forward
through the plain versions: 1e-4.  ``lu_solve`` and ``propagate_step``:
1e-5 relative (another summation order, fused multiply-adds), a singular
member's inf/nan kept in that member.  The member-batched sweep against
the one-by-one solves on the card: final costs within 1e-4 (the
reference's own bound, ``tests/test_blocked_sets.py``).  The event layer:
a fleet on the card replays the CPU fleet's trace to the same bits;
frozen applications (``app_mask``, plain and accelerated) keep their rows
bit for bit on every committed iterate, the history within 1e-5 of the
CPU's; ``gp.solve_loop`` is ``gp.solve`` bit for bit on the card.  A
stacked sparse family's per-member lists: one launch of ``bsr_chain`` /
``tagged_nbr`` bit-equal to a stride-0 launch a member and to the plain
versions; ``tagged``'s round count equal to its plain version's, the mask
unchanged by asking for it.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gp, network  # noqa: E402
from repro_torch.kernels import batched_solve as bs  # noqa: E402
from repro_torch.kernels import blocked_sets as bset  # noqa: E402
from repro_torch.kernels import chain_propagate as cp  # noqa: E402
from repro_torch.core import engine, marginals, traffic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sparse_solve as ss  # noqa: E402
from _torch_cases import (BLOCKED_SET_V, blocked_set_inputs, bsr_digest_cases,  # noqa: E402
                          case_id, check_bsr_digest, check_dense_digest, dense_digest_cases,
                          dense_scale_cases, dense_scale_digest_cases, stage_mats,
                          three_term_mask, with_loops)

METRO_GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                            "torch_ref_metro_sw1000.npz")
DENSE_DIGESTS = os.path.join(os.path.dirname(__file__), "data",
                             "torch_card_dense_digests.json")
SCALE_DIGESTS = os.path.join(os.path.dirname(__file__), "data",
                             "torch_card_dense_scale_digests.json")
BSR_DIGESTS = os.path.join(os.path.dirname(__file__), "data", "torch_card_bsr_digests.json")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


@pytest.mark.parametrize("V", [22, 69, 100, 130])
def test_lu_factor_kernel_matches_plain(cuda, V):
    rng = np.random.default_rng(V)
    mats = stage_mats(rng, 7, V)
    bad = 3
    mats[bad, :, 5] = 0.0
    mats[bad, 5, :] = 0.0
    m = torch.from_numpy(mats).to(cuda)
    got = bs.lu_factor(m)
    want = bs.lu_factor_plain(m)
    torch.cuda.synchronize()
    good = torch.arange(7) != bad
    assert _rel(got[good], want[good]) <= 1e-5
    ok = bs.factor_ok(got).cpu()
    assert torch.equal(ok, bs.factor_ok(want).cpu())
    assert not ok[bad] and ok[good].all()


@pytest.mark.parametrize("trans,reverse,clamp", [(1, False, False),
                                                 (0, True, True),
                                                 (1, True, False),
                                                 (0, False, True)])
@pytest.mark.parametrize("V", [22, 100])
def test_chain_solve_kernel_matches_plain(cuda, V, trans, reverse, clamp):
    rng = np.random.default_rng(V + 7 * trans)
    B, K, loopy = 9, 3, 4
    mats = stage_mats(rng, B * K, V, loopy=(loopy * K + 1,))
    lu = bs.lu_factor_plain(torch.from_numpy(mats).to(cuda)).reshape(B, K, V, V)
    base = torch.from_numpy(rng.uniform(-0.5, 2.0, (B, K, V)).astype(np.float32)).to(cuda)
    mult = torch.from_numpy(rng.uniform(0.0, 1.0, (B, K, V)).astype(np.float32)).to(cuda)
    kw = dict(trans=trans, reverse=reverse, clamp=clamp)
    got = bs.chain_solve(lu.contiguous(), base, mult, **kw)
    want = bs.chain_solve_plain(lu, base, mult, **kw)
    torch.cuda.synchronize()
    good = torch.arange(B) != loopy
    assert _rel(got[good], want[good]) <= 1e-5
    assert not torch.isfinite(got[loopy]).all()
    assert torch.equal(torch.isnan(got[loopy]), torch.isnan(want[loopy]))


@pytest.mark.parametrize("case", dense_digest_cases(), ids=case_id)
def test_dense_kernels_bit_equal_to_card_digests(cuda, case):
    """``lu_factor`` (factors and ``ok``) and ``chain_solve`` write the
    bytes the card's digest file records (the kernels they were redesigned
    from), within 1e-5 of their plain versions, the kernel's ``ok`` equal to
    ``factor_ok`` of its factors."""
    with open(DENSE_DIGESTS) as fh:
        ref = {case_id(c): c for c in json.load(fh)["cases"]}[case_id(case)]
    rep = check_dense_digest(case, ref, cuda)
    print(json.dumps(rep))
    assert rep["inputs_equal"], "the numpy inputs drifted"
    assert rep["outputs_equal"], (f"{rep['case']}: {rep['differ']} differ, max abs diff "
                                  f"against the plain version {rep['max_abs_diff']}")
    assert rep.get("ok_equal", True) and rep["finite_equal"]
    assert rep["max_rel_err"] <= 1e-5


@pytest.mark.parametrize("case", dense_scale_digest_cases(), ids=case_id)
def test_large_v_kernels_bit_equal_to_card_digests(cuda, case):
    """Above the shared-memory limits, ``lu_factor`` on its clusters (V =
    300 to 1614), ``chain_solve`` on its clusters (V = 300 to 1000) and by
    strips (V = 2049) and ``lu_solve`` by strips write the bytes that the
    card digests of their single-block variants record (commit 8ee676d,
    before the redesign), within 1e-5 of their plain versions, the kernel's
    ``ok`` equal to ``factor_ok`` of its factors."""
    with open(SCALE_DIGESTS) as fh:
        ref = {case_id(c): c for c in json.load(fh)["cases"]}[case_id(case)]
    rep = check_dense_digest(case, ref, cuda)
    print(json.dumps(rep))
    assert rep["inputs_equal"], "the numpy inputs drifted"
    assert rep["outputs_equal"], (f"{rep['case']}: {rep['differ']} differ, max abs diff "
                                  f"against the plain version {rep['max_abs_diff']}")
    assert rep.get("ok_equal", True) and rep["finite_equal"]
    assert rep["max_rel_err"] <= 1e-5


def test_launch_plans_match_the_kernels(cuda):
    """The wrappers' launch plans agree with the CUDA sources: the shared
    memory each variant takes, the cluster sizes, the register variant
    refused above V=128 and the cluster variant above V=1614."""
    import ctypes

    from repro_torch.kernels import _build

    def c_int(name, symbol, *args):
        return _build.function(name, symbol, [ctypes.c_int] * len(args))(*args)

    for V in (1, 16, 17, 100, 128, 129, 200, 240, 241, 242, 300, 512, 513, 600, 1000, 1024,
              1025, 1614):
        plan = bs.lu_factor_plan(V)
        variant = ("registers", "shared", "clusters").index(plan["variant"])
        assert c_int("batched_lu", "repro_lu_factor_smem_bytes", V, variant) == plan["smem_bytes"]
        if plan["cluster"] is not None:
            assert c_int("batched_lu", "repro_lu_factor_cluster", V) == plan["cluster"]
    for V in (1, 32, 33, 100, 239, 240, 256, 257, 300, 512, 513, 1000, 1024, 1025, 2048, 2049,
              28_528):
        plan = bs.chain_solve_plan(V)
        variant = ("shared", "strips", "clusters").index(plan["variant"])
        assert (c_int("chain_solve", "repro_chain_solve_smem_bytes", V, variant)
                == plan["smem_bytes"])
        if plan["cluster"] is not None:
            assert c_int("chain_solve", "repro_chain_solve_cluster", V) == plan["cluster"]
        plan = bs.lu_solve_plan(V)
        variant = ("shared", "strips").index(plan["variant"])
        assert c_int("lu_solve", "repro_lu_solve_smem_bytes", V, variant) == plan["smem_bytes"]
    for V in BLOCKED_SET_V + (129, 3584):
        plan = bset.blocked_dense_plan(V)
        assert (c_int("tagged", "repro_tagged_dense_smem_bytes", V, plan["words"])
                == plan["smem_bytes"])
        for D in (1, 10, 33):
            plan = ss.blocked_nbr_plan(V, D)
            assert (c_int("tagged_nbr", "repro_tagged_nbr_smem_bytes", V, D, plan["words"])
                    == plan["smem_bytes"])
    fn = _build.function("batched_lu", "repro_lu_factor",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    assert fn(None, None, None, 0, 129, 0, None) != 0
    assert fn(None, None, None, 0, 128, 0, None) == 0
    assert fn(None, None, None, 0, bs.LU_MAX_V + 1, 2, None) != 0
    assert fn(None, None, None, 0, bs.LU_MAX_V, 2, None) == 0


def test_chain_clamp_keeps_nan_on_card(cuda):
    lu = torch.ones((3, 2, 1, 1), device=cuda)
    base = torch.tensor([[1.0, 0.5], [-2.0, -1.0], [float("nan"), 1.0]],
                        device=cuda)[..., None]
    x = bs.chain_solve(lu, base.contiguous(), torch.zeros_like(base), trans=0,
                       reverse=True, clamp=True).cpu()
    assert torch.equal(x[:2], torch.tensor([[1.0, 0.5], [0.0, 0.0]])[..., None])
    assert torch.isnan(x[2, 0]).all() and x[2, 1].item() == 1.0


def _on(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("special", [False, True], ids=["plain", "special"])
@pytest.mark.parametrize("V", BLOCKED_SET_V)
def test_tagged_kernel_bit_equal_to_plain(cuda, V, special):
    """The dense blocked-set kernel (its cluster plan at V) writes the mask
    and tagged flags of its plain version, on the card and on the CPU, and
    of the numpy contract: two members of three row batches, NaN, +-inf and
    -0.0 in phi and pdt with ``special``."""
    phi, pdt, adj = blocked_set_inputs(V + 11 * special, V, members=2, special=special)
    got, tagged = bset.blocked_dense(*_on(cuda, phi, pdt, adj), eps=engine.BLOCK_EPS,
                                     with_tagged=True)
    want, want_tagged = bset.blocked_dense_plain(*_on(cuda, phi, pdt, adj),
                                                 eps=engine.BLOCK_EPS, with_tagged=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(tagged, want_tagged)
    cpu, cpu_tagged = bset.blocked_dense(*_on("cpu", phi, pdt, adj), eps=engine.BLOCK_EPS,
                                         with_tagged=True)
    assert torch.equal(got.cpu(), cpu) and torch.equal(tagged.cpu(), cpu_tagged)
    three, three_tagged = three_term_mask(phi, pdt, adj)
    assert np.array_equal(got.cpu().numpy(), three)
    assert np.array_equal(tagged.cpu().numpy(), three_tagged)


@pytest.mark.parametrize("special", [False, True], ids=["plain", "special"])
@pytest.mark.parametrize("V", BLOCKED_SET_V)
def test_tagged_nbr_kernel_at_node_counts(cuda, V, special):
    """The neighbor-list blocked-set kernel against its plain version (mask,
    tagged flags, round counts) on the lists of a seeded adjacency."""
    phi, pdt, adj = blocked_set_inputs(V + 13 * special, V, members=1, per=4,
                                       special=special)
    nbr, mask, _, _ = network.sparse_neighbors(adj[0])
    nbr, mask = _on(cuda, nbr.astype(np.int64), mask)
    t = _on(cuda, phi, pdt, adj)
    got = ss.blocked_nbr(*t, nbr, mask, eps=engine.BLOCK_EPS, with_rounds=True)
    want = ss.blocked_nbr_plain(*t, nbr, mask, eps=engine.BLOCK_EPS, with_rounds=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    three, _ = three_term_mask(phi, pdt, adj)
    assert np.array_equal(got[0].cpu().numpy(), three)


def test_blocked_sets_kernels_on_a_batched_sweep(cuda):
    """``engine.blocked_sets`` on the Fig. 5 sw-queue group and the Fig. 6
    family, padded and stacked (one adjacency a member), at a 3-iteration
    iterate under ``init_phi``'s marginals: the card's mask equals the
    CPU's (plain version) and the scan's, in one launch."""
    from repro_torch.core import batch, scenarios

    for fam in (scenarios.expand("fig6-congestion"),
                [sc for sc in scenarios.expand("fig5") if sc.label == "sw-queue"]):
        insts = [sc.instance for sc in fam]
        binst = batch.pad_instances(insts)
        phis = [gp.solve(i, alpha=0.1, max_iters=3, patience=10**6, tol=0.0).phi
                for i in insts]
        bphi = batch.pad_phis(phis, insts)
        pdt = marginals.marginals(binst, batch.pad_phis([gp.init_phi(i) for i in insts],
                                                        insts)).pdt
        ops.reset_launch_counts()
        got = engine.blocked_sets(binst, bphi, pdt)
        assert ops.launch_counts()["tagged"] == 1
        assert torch.equal(got, engine.blocked_sets(binst, bphi, pdt, method="scan"))
        cpu = dataclasses.replace(binst, **{
            f.name: getattr(binst, f.name).cpu() for f in dataclasses.fields(binst)
            if torch.is_tensor(getattr(binst, f.name))})
        want = engine.blocked_sets(cpu, bphi._replace(e=bphi.e.cpu(), c=bphi.c.cpu()),
                                   pdt.cpu())
        assert torch.equal(got.cpu(), want)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    m = torch.eye(8, device=cuda).repeat(2, 1, 1)
    with pytest.raises(TypeError):
        bs.lu_factor(m.double())
    with pytest.raises(ValueError):
        bs.lu_factor(m.transpose(1, 2))
    with pytest.raises(ValueError, match="shared memory"):
        bs.lu_factor(torch.eye(1615, device=cuda)[None].contiguous())
    lu = m.reshape(1, 2, 8, 8)
    with pytest.raises(ValueError):
        bs.chain_solve(lu, torch.zeros((1, 2, 7), device=cuda),
                       torch.zeros((1, 2, 7), device=cuda))
    adj = torch.ones((2, 8, 8), dtype=torch.bool, device=cuda)
    pdt = torch.zeros((3, 8), device=cuda)
    with pytest.raises(ValueError):                  # 3 row batches, 2 members
        bset.blocked_dense(m.repeat(2, 1, 1)[:3].contiguous(), pdt, adj, eps=1e-7)
    with pytest.raises(ValueError):
        bset.blocked_dense(m.double(), pdt[:2], adj, eps=1e-7)
    with pytest.raises(ValueError):                  # no kernel takes route/improper
        ops.blocked_tagged(adj, adj)


@pytest.mark.parametrize("case", dense_scale_cases(), ids=case_id)
def test_large_v_dense_variants_match_plain(cuda, case):
    """Above the shared-memory limits: ``lu_factor`` by 32-column panels
    and ``chain_solve`` by 32-row strips from global memory, each on a
    cluster of CTAs, at V = 300, 600 and 1000, within 1e-5 of their plain
    versions, the same ``ok`` flags (a singular and a tiny member) and the
    same non-finite chains (a loopy one)."""
    rep = check_dense_digest(case, None, cuda)
    print(json.dumps(rep))
    plan = (bs.lu_factor_plan if case["kernel"] == "lu_factor" else bs.chain_solve_plan)(case["V"])
    assert plan["variant"] == "clusters"
    assert rep.get("ok_equal", True) and rep["finite_equal"]
    assert rep["max_rel_err"] <= 1e-5


@pytest.mark.parametrize("V", [130, 200, 241])
def test_lu_factor_global_variant_bit_equal_to_shared(cuda, V):
    """The cluster variant takes each entry's updates in the same order as
    the shared-memory variant, so where both fit they write the same
    bytes."""
    import ctypes

    from repro_torch.kernels import _build

    mats = stage_mats(np.random.default_rng(V), 5, V, loopy=(2,))
    m = torch.from_numpy(mats).to(cuda)
    lu, ok = bs.lu_factor(m, with_ok=True)
    assert bs.lu_factor_plan(V)["variant"] == "shared"
    fn = _build.function("batched_lu", "repro_lu_factor",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out, ok2 = torch.empty_like(m), torch.empty_like(ok)
    assert fn(m.data_ptr(), out.data_ptr(), ok2.data_ptr(), 5, V, 2,
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(lu.view(torch.int32), out.view(torch.int32))
    assert torch.equal(ok, ok2) and ok.tolist() == [True, True, False, True, True]


@pytest.mark.parametrize("V", [300, 1000])
def test_large_v_lu_solve_and_tagged_match_plain(cuda, V):
    """``lu_solve`` by strips (trans 0 and 1) within 1e-5 of its plain
    version, a singular member's inf/nan kept in it; the dense blocked-set
    kernel (a cluster of 8 or 16 CTAs a row batch) bit-equal to its plain
    version, its tagged flags to the dense sweep."""
    rng = np.random.default_rng(V + 5)
    mats = stage_mats(rng, 4, V, loopy=(2,))
    lu = bs.lu_factor_plain(torch.from_numpy(mats).to(cuda)).contiguous()
    rhs = torch.from_numpy(rng.uniform(-1.0, 2.0, (4, V)).astype(np.float32)).to(cuda)
    ok = bs.factor_ok(lu)
    assert bs.lu_solve_plan(V)["variant"] == "strips"
    for trans in (0, 1):
        got = bs.lu_solve(lu, rhs, trans=trans)
        want = bs.lu_solve_plain(lu, rhs, trans=trans)
        assert _rel(got[ok], want[ok]) <= 1e-5
        assert not torch.isfinite(got[2]).all()
    phi, pdt, adj = blocked_set_inputs(V + 5, V, members=2, per=2, special=True)
    t = _on(cuda, phi, pdt, adj)
    got, tagged = bset.blocked_dense(*t, eps=engine.BLOCK_EPS, with_tagged=True)
    assert bset.blocked_dense_plan(V)["cluster"] >= 8
    want, want_tagged = bset.blocked_dense_plain(*t, eps=engine.BLOCK_EPS, with_tagged=True)
    assert torch.equal(got, want) and torch.equal(tagged, want_tagged)
    route = t[0] > 0
    worse = t[1][:, None, :] > t[1][:, :, None] + engine.BLOCK_EPS
    assert torch.equal(tagged, bset.tagged_scan_dense(route, route & worse))
    assert tagged.any()


def test_solve_on_card_matches_cpu(cuda):
    """Abilene, 40 iterations with the stall latch off: the card's
    trajectory (kernels) against the CPU's (plain versions), 1e-5."""
    kw = dict(alpha=0.1, max_iters=40, patience=10**6, tol=0.0)
    ops.reset_launch_counts()
    on_card = gp.solve(network.table_ii_instance("abilene", rate_scale=2.0), **kw)
    counts = ops.launch_counts()
    on_cpu = gp.solve(network.table_ii_instance("abilene", rate_scale=2.0,
                                                device="cpu"),
                      device="cpu", **kw)
    assert on_card.iterations == on_cpu.iterations == 40
    assert _rel(on_card.cost_history, on_cpu.cost_history) <= 1e-5
    assert counts["lu_factor"] >= 2 * 40 and counts["chain_solve"] >= 3 * 40
    assert counts["tagged"] >= 40


def _sparse_cases(cuda):
    """(label, instance, phi) on the card: congested Table II iterates
    (rate_scale 2, 10 iterations of the card's solve) and metro-sw V=1000
    at ``init_phi``."""
    out = []
    for name in ("geant", "sw-queue"):
        inst = network.with_sparse(network.table_ii_instance(name, rate_scale=2.0))
        phi = gp.solve(inst, alpha=0.1, max_iters=10, patience=10**6, tol=0.0).phi
        out.append((name, inst, phi))
    metro = network.metro_instance("sw", 1000)
    out.append(("metro-sw-1000", metro, gp.init_phi(metro)))
    return out


def _check_bsr(inst, phi_e, base, mult, trans, **kw):
    K, V = base.shape[-2:]
    M = phi_e.reshape(-1, K, V, V)
    M = M.transpose(-1, -2) if trans else M
    bvals = ss.block_values(M, inst.blk_nbr, inst.blk_mask).contiguous()
    b2, m2 = base.reshape(-1, K, V).contiguous(), mult.reshape(-1, K, V).contiguous()
    got, sw = ss.chain_solve_bsr(phi_e.reshape(-1, K, V, V).contiguous(), inst.blk_nbr,
                                 inst.blk_mask, b2, m2, trans=trans, with_sweeps=True, **kw)
    want, sw_want = ss.chain_solve_bsr_plain(bvals, inst.blk_nbr, b2, m2,
                                             with_sweeps=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sw, sw_want)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert not torch.isnan(got).any()
    fin = torch.isfinite(want)
    if fin.any():
        assert _rel(got[fin], want[fin]) <= 1e-5
        print("bsr_chain max abs diff", float((got[fin] - want[fin]).abs().max()))
    return got, sw


def test_bsr_chain_kernel_matches_plain(cuda):
    for label, inst, phi in _sparse_cases(cuda):
        fl = traffic.flows(inst, phi, solver="sparse")
        pdt_b = marginals.pdt_base(inst, phi, traffic.link_marginals(inst, fl.F),
                                   traffic.comp_marginals(inst, fl.G))
        _check_bsr(inst, phi.e, *traffic.chain_inputs(inst, phi), 1)
        _check_bsr(inst, phi.e, pdt_b, phi.c, 0, reverse=True, clamp=True)
        cands, _, _ = engine.ladder_candidates(inst, phi, 0.1)
        _check_bsr(inst, cands.e, *traffic.chain_inputs(inst, cands), 1)
        loopy = cands._replace(e=with_loops(cands.e, inst.r, inst.out_nbr))
        got, sw = _check_bsr(inst, loopy.e, *traffic.chain_inputs(inst, loopy), 1)
        A = inst.A
        assert (sw[A] == inst.V + 2).any(), label
        assert not torch.isfinite(got[3 * A]).all(), label


@pytest.mark.parametrize("case", bsr_digest_cases(), ids=lambda c: c["label"])
def test_bsr_chain_bit_equal_to_card_digests(cuda, case):
    """The cluster ``bsr_chain`` writes the iterates and sweep counts that
    the earlier kernel wrote on the card (the digest file), and the plain
    version's bytes, on every digest case: the metro-sw ladder shape, the
    streamed metro-geant blocks, the loopy sw-queue ladder (cap and latch)
    and every trans/reverse/clamp variant."""
    with open(BSR_DIGESTS) as fh:
        ref = {c["label"]: c for c in json.load(fh)["cases"]}[case["label"]]
    rep = check_bsr_digest(case, ref, cuda)
    print(json.dumps(rep))
    assert rep["inputs_equal"], "the numpy inputs drifted"
    assert rep["outputs_equal"], f"{rep['case']}: {rep['differ']} differ"
    assert rep["plain_equal"], rep
    assert rep["sweeps_total"] == ref["sweeps_total"]


@pytest.mark.parametrize("NB,BD", [(132, 3), (200, 9)])
def test_bsr_chain_more_block_rows_than_warps(cuda, NB, BD):
    """Above NB = 128 a CTA owns more block rows than it has warps (9 at
    V=4200; 13 at V=6400, whose blocks are streamed): every row is summed,
    bit-equal to the plain version, in both orientations.  Seeded strategies
    on a banded block list (row I: blocks I, I+1, ..., I+BD-1 mod NB, one
    slot masked in every fifth row), nonzero only from a lower to a higher
    of 8 levels, so a stage settles within 9 sweeps."""
    rng = np.random.default_rng(4100 + NB)
    B, K, V = 2, 2, NB * 32 - 24
    nbr = (np.arange(NB)[:, None] + np.arange(BD)[None, :]) % NB
    mask = np.ones((NB, BD), dtype=bool)
    mask[::5, BD - 1] = False
    level = rng.integers(0, 8, (B, K, V))
    phi = torch.zeros((B, K, V, V), device=cuda)
    for b in range(B):
        for k in range(K):
            r = rng.integers(0, V, 12 * V)
            c = (nbr[r // 32, rng.integers(0, BD, r.size)] * 32 + rng.integers(0, 32, r.size))
            keep = (c < V) & mask[r // 32, (c // 32 - r // 32) % NB] \
                & (level[b, k, np.minimum(c, V - 1)] > level[b, k, r])
            val = rng.uniform(0.01, 0.08, r.size)[keep].astype(np.float32)
            phi[b, k].index_put_((torch.from_numpy(r[keep]).to(cuda),
                                  torch.from_numpy(c[keep]).to(cuda)),
                                 torch.from_numpy(val).to(cuda))
    base = torch.from_numpy(rng.uniform(-0.5, 2.0, (B, K, V)).astype(np.float32)).to(cuda)
    mult = torch.from_numpy(rng.uniform(0.0, 1.0, (B, K, V)).astype(np.float32)).to(cuda)
    blk_nbr = torch.from_numpy(nbr.astype(np.int64)).to(cuda)
    blk_mask = torch.from_numpy(mask).to(cuda)
    plan = ss.bsr_chain_plan(NB, BD)
    assert plan["rows"] > 8
    for trans in (0, 1):
        M = phi.transpose(-1, -2) if trans else phi
        want, want_sw = ss.chain_solve_bsr_plain(ss.block_values(M, blk_nbr, blk_mask),
                                                 blk_nbr, base, mult, with_sweeps=True)
        got, sw = ss.chain_solve_bsr(phi, blk_nbr, blk_mask, base, mult, trans=trans,
                                     with_sweeps=True)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(want).all()) and int(want_sw.max()) <= 9, (trans, want_sw)
        assert torch.equal(sw, want_sw), (trans, sw, want_sw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (trans, plan, float((got - want).abs().max()))


def test_tagged_nbr_kernel_bit_equal_to_plain(cuda):
    """The neighbor-list blocked-set kernel on congested Table II iterates
    and metro-sw V=1000, under fresh and stale marginals: mask, tagged flags
    and round counts of its plain version, the flags the dense sweep's, the
    mask the dense kernel's (phi routes along listed edges only)."""
    for label, inst, phi in _sparse_cases(cuda):
        stale = marginals.marginals(inst, gp.init_phi(inst)).pdt
        fresh = marginals.marginals(inst, phi).pdt
        V = inst.V
        pe = phi.e.reshape(-1, V, V).contiguous()
        for pdt in (fresh, stale):
            pd = pdt.reshape(-1, V).contiguous()
            args = (pe, pd, inst.adj[None], inst.out_nbr, inst.out_mask)
            got = ss.blocked_nbr(*args, eps=engine.BLOCK_EPS, with_rounds=True)
            want = ss.blocked_nbr_plain(*args, eps=engine.BLOCK_EPS, with_rounds=True)
            for g, w in zip(got, want):
                assert torch.equal(g, w), label
            route = pe > 0
            worse = pd[:, None, :] > pd[:, :, None] + engine.BLOCK_EPS
            assert torch.equal(got[1], bset.tagged_scan_dense(route, route & worse)), label
            assert torch.equal(got[0], bset.blocked_dense(pe, pd, inst.adj[None],
                                                          eps=engine.BLOCK_EPS)), label


@pytest.mark.parametrize("route", ["dense", "sparse"])
def test_blocked_sets_one_launch_on_card(cuda, route):
    """``engine.blocked_sets`` on the card: one kernel in the profiler's
    trace, the route's blocked-set kernel, and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    inst = (network.table_ii_instance("sw-queue") if route == "dense"
            else network.metro_instance("sw", 1000))
    phi = gp.init_phi(inst)
    pdt = marginals.marginals(inst, phi).pdt
    engine.blocked_sets(inst, phi, pdt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            engine.blocked_sets(inst, phi, pdt)
        torch.cuda.synchronize()
    kernels = {ev.key: ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
    symbol = "tagged_dense_kernel" if route == "dense" else "tagged_nbr_mask_kernel"
    assert len(kernels) == 1 and symbol in next(iter(kernels)), kernels
    assert next(iter(kernels.values())) == 3


def test_metro_solve_on_card(cuda):
    """Two latch-off steps of metro-sw V=1000 through the sparse kernels
    only, against the reference's history (tests/data, 1e-5)."""
    ref = np.load(METRO_GOLDEN)
    inst = network.metro_instance("sw", 1000)
    ops.reset_launch_counts()
    res = gp.solve(inst, alpha=0.1, max_iters=2, patience=10**6, tol=0.0)
    counts = ops.launch_counts()
    assert res.iterations == 2
    assert _rel(res.cost_history, torch.from_numpy(
        ref["latch_off_cost_history"][:3].astype(np.float64))) <= 1e-5
    assert counts["lu_factor"] == counts["chain_solve"] == counts["tagged"] == 0
    assert counts["bsr_chain"] >= 3 * 2 and counts["tagged_nbr"] >= 2


def test_sparse_wrappers_reject_what_the_kernels_do_not_take(cuda):
    nbr = torch.zeros((1, 1), dtype=torch.int64, device=cuda)
    mask = torch.ones((1, 1), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        ss.chain_solve_bsr(torch.zeros((1, 1, 20, 20), device=cuda), nbr.int(), mask,
                           torch.zeros((1, 1, 20), device=cuda),
                           torch.zeros((1, 1, 20), device=cuda))
    with pytest.raises(ValueError):
        ss.chain_solve_bsr(torch.zeros((1, 1, 40, 40), device=cuda), nbr, mask,
                           torch.zeros((1, 1, 40), device=cuda),
                           torch.zeros((1, 1, 40), device=cuda))
    phi = torch.zeros((2, 5, 5), device=cuda)
    pdt = torch.zeros((2, 5), device=cuda)
    adj = torch.ones((1, 5, 5), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):                  # lists of another node count
        ss.blocked_nbr(phi, pdt, adj, torch.zeros((4, 2), dtype=torch.int64, device=cuda),
                       torch.ones((4, 2), dtype=torch.bool, device=cuda), eps=1e-7)
    with pytest.raises(ValueError):
        ss.blocked_nbr(phi, pdt, adj, torch.zeros((5, 2), dtype=torch.int32, device=cuda),
                       torch.ones((5, 2), dtype=torch.bool, device=cuda), eps=1e-7)
    with pytest.raises(ValueError):                  # no kernel takes route/improper
        ops.blocked_tagged_nbr(adj, adj, torch.zeros((5, 2), dtype=torch.int64, device=cuda),
                               torch.ones((5, 2), dtype=torch.bool, device=cuda))


# ---------------------------------------------------------------------------
# the model kernels: flash attention and the SSD chunk
# ---------------------------------------------------------------------------

def _max_rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("S,H,KV,hd,causal,window", [
    (256, 4, 2, 64, True, None),
    (256, 4, 4, 64, True, 64),
    (130, 4, 2, 64, True, None),          # padded to 256, true length 130
    (200, 4, 2, 64, False, None),         # non-causal, padded keys masked
    (512, 8, 2, 128, True, None),
    (512, 8, 8, 128, True, 200),          # window not a tile multiple
])
def test_flash_attention_kernel_matches_plain(cuda, monkeypatch, S, H, KV, hd, causal,
                                              window):
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(S + H + hd)
    q = torch.randn((2, S, H, hd), generator=g, device=cuda)
    k = torch.randn((2, S, KV, hd), generator=g, device=cuda)
    v = torch.randn((2, S, KV, hd), generator=g, device=cuda)
    kernel = fa.flash_attention_fwd
    before = kernel.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(fa, "flash_attention_fwd", fa.flash_attention_plain)
    want = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (2, S, H, hd) and bool(torch.isfinite(got).all())
    assert _max_rel(got, want) <= 2e-5


@pytest.mark.parametrize("nc,H,P,N,G", [(2, 4, 32, 32, 1), (1, 6, 64, 128, 2),
                                        (3, 4, 64, 64, 4),
                                        (2, 8, 64, 16, 1)])     # Jamba's (P, N)
def test_ssd_chunk_kernel_matches_plain(cuda, nc, H, P, N, G):
    from repro_torch.kernels import ssd_chunk as sc

    g = torch.Generator(device=cuda).manual_seed(nc * H + P + N)
    B, Q = 2, 128
    xh = torch.randn((B, nc, Q, H, P), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((B, nc, Q, H), generator=g, device=cuda))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=cuda)
    cum = torch.cumsum(dt * A, dim=2)
    Bc = 0.3 * torch.randn((B, nc, Q, G, N), generator=g, device=cuda)
    Cc = 0.3 * torch.randn((B, nc, Q, G, N), generator=g, device=cuda)
    before = sc.ssd_chunk_fwd.launches
    y, st = sc.ssd_chunk_fwd(xh, dt, cum, Bc, Cc)
    assert sc.ssd_chunk_fwd.launches == before + 1
    yw, sw = sc.ssd_chunk_plain(xh, dt, cum, Bc, Cc)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert _max_rel(y, yw) <= 2e-5 and _max_rel(st, sw) <= 2e-5


@pytest.mark.parametrize("S,H,KV,hd,window,seq_len", [
    (64, 4, 2, 128, None, None),          # one query tile, one key tile
    (128, 4, 2, 64, None, None),
    (256, 4, 2, 128, 1, None),            # each row sees itself only
    (256, 4, 4, 64, 63, None),            # a window under one tile
    (1024, 4, 2, 128, None, 1000),        # seq_len 1000 padded to 1024
    (512, 32, 4, 64, None, None),         # hd 64, 8 heads per KV head
])
def test_flash_attention_kernel_tilings(cuda, S, H, KV, hd, window, seq_len):
    """The tensor-core kernel's tilings against the plain version, on the
    kernel's own layout: single tiles, windows under a tile, padded rows."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(S + H + hd + (window or 0))
    q = torch.randn((2, H, S, hd), generator=g, device=cuda)
    k = torch.randn((2, KV, S, hd), generator=g, device=cuda)
    v = torch.randn((2, KV, S, hd), generator=g, device=cuda)
    n = S if seq_len is None else seq_len
    got = fa.flash_attention_fwd(q, k, v, causal=True, window=window, seq_len=n)[:, :, :n]
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window, seq_len=n)[:, :, :n]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _max_rel(got, want) <= 2e-5


@pytest.mark.parametrize("B,nc,H,P,N,G,a_scale", [
    (4, 11, 20, 64, 128, 1, 1.0),         # 132 blocks on the H100: head tiles 7, 7, 6
    (4, 11, 20, 64, 128, 2, 1.0),         # two groups: tiles 4, 4, 2
    (2, 3, 8, 32, 32, 4, 1.0),
    (2, 1, 6, 32, 64, 2, 1.0),            # one chunk
    (1, 2, 12, 64, 128, 4, 50.0),         # A = -(1..H) x 50: cum very negative
    (4, 3, 128, 64, 16, 1, 1.0),          # Jamba's heads and (P, N), 3 chunks
    (2, 2, 128, 64, 16, 1, 50.0),
])
def test_ssd_chunk_kernel_tilings(cuda, B, nc, H, P, N, G, a_scale):
    """The tensor-core kernel's head tiles and groups against the plain
    version; outputs finite where the decay underflows."""
    from repro_torch.kernels import ssd_chunk as sc

    g = torch.Generator(device=cuda).manual_seed(B * nc * H + P + N + G)
    Q = 128
    xh = torch.randn((B, nc, Q, H, P), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((B, nc, Q, H), generator=g, device=cuda))
    A = -a_scale * torch.arange(1, H + 1, dtype=torch.float32, device=cuda)
    cum = torch.cumsum(dt * A, dim=2)
    Bc = torch.randn((B, nc, Q, G, N), generator=g, device=cuda)
    Cc = torch.randn((B, nc, Q, G, N), generator=g, device=cuda)
    y, st = sc.ssd_chunk_fwd(xh, dt, cum, Bc, Cc)
    yw, sw = sc.ssd_chunk_plain(xh, dt, cum, Bc, Cc)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert _max_rel(y, yw) <= 2e-5 and _max_rel(st, sw) <= 2e-5


@pytest.mark.parametrize("Q,G", [(32, 1), (100, 2)])
def test_ssd_chunk_short_chunk_padded_on_card(cuda, Q, G):
    """A prefill shorter than the kernel's 128 rows: ``ops.ssd_chunk`` pads
    the chunk, launches the kernel once and matches the plain version on
    the unpadded chunk."""
    from repro_torch.kernels import ssd_chunk as sc

    g = torch.Generator(device=cuda).manual_seed(Q + G)
    B, nc, H, P, N = 2, 1, 4, 64, 128
    xh = torch.randn((B, nc, Q, H, P), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((B, nc, Q, H), generator=g, device=cuda))
    cum = torch.cumsum(dt * -torch.arange(1, H + 1, dtype=torch.float32, device=cuda), dim=2)
    Bc = 0.3 * torch.randn((B, nc, Q, G, N), generator=g, device=cuda)
    Cc = 0.3 * torch.randn((B, nc, Q, G, N), generator=g, device=cuda)
    before = sc.ssd_chunk_fwd.launches
    y, st = ops.ssd_chunk(xh, dt, cum, Bc, Cc)
    yw, sw = sc.ssd_chunk_plain(xh, dt, cum, Bc, Cc)
    torch.cuda.synchronize()
    assert sc.ssd_chunk_fwd.launches == before + 1
    assert y.shape == (B, nc, Q, H, P) and st.shape == (B, nc, H, P, N)
    assert _max_rel(y, yw) <= 2e-5 and _max_rel(st, sw) <= 2e-5


def test_model_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc

    q = torch.zeros((1, 2, 128, 96), device=cuda)           # hd 96
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 2, 100, 64), device=cuda)           # S not a tile multiple
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q, q)
    x = torch.zeros((1, 1, 64, 2, 32), device=cuda)         # Q = 64
    d = torch.zeros((1, 1, 64, 2), device=cuda)
    b = torch.zeros((1, 1, 64, 1, 32), device=cuda)
    with pytest.raises(ValueError):
        sc.ssd_chunk_fwd(x, d, d, b, b)
    x = torch.zeros((1, 1, 128, 2, 32), device=cuda)        # (P, N) = (32, 16)
    d = torch.zeros((1, 1, 128, 2), device=cuda)
    b = torch.zeros((1, 1, 128, 1, 16), device=cuda)
    before = sc.ssd_chunk_fwd.launches
    with pytest.raises(ValueError, match=r"\(P, N\) in"):
        sc.ssd_chunk_fwd(x, d, d, b, b)
    assert sc.ssd_chunk_fwd.launches == before


def _plain_forward(monkeypatch, model, batch, **kw):
    """``model``'s forward (``Model.apply``'s keywords ``kw``) with the model
    kernels' wrappers swapped for their plain versions (``ops`` looks them
    up at each call)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc

    with monkeypatch.context() as m:
        m.setattr(fa, "flash_attention_fwd", fa.flash_attention_plain)
        m.setattr(sc, "ssd_chunk_fwd", sc.ssd_chunk_plain)
        return model.apply(batch, **kw)


def _forward_on_card(monkeypatch, cuda, name, S):
    """A reduced model's forward on 2 x S tokens through the kernels against
    the same forward through the plain versions, and the split forward
    bit-equal to the monolithic one."""
    from repro_torch.core import chain
    from repro_torch.models import transformer

    model = transformer.make_model(name, reduced=True).init(3)
    toks = torch.randint(0, model.cfg.vocab, (2, S),
                         generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    batch = {"tokens": toks}
    ops.reset_launch_counts()
    logits = model.apply(batch)
    counts = ops.launch_counts()
    kernel = "flash_attention" if name.startswith("internlm2") else "ssd_chunk"
    assert counts[kernel] == model.cfg.n_layers
    lo, mid, hi = (int(b) for b in chain.segment_bounds(model.cfg.n_layers, 2))
    split = model.head(model.apply_layers(model.apply_layers(model.embed(batch), lo, mid),
                                          mid, hi))
    plain = _plain_forward(monkeypatch, model, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert torch.equal(split, logits)
    assert _max_rel(logits, plain) <= 1e-4


@pytest.mark.parametrize("name", ["internlm2-1.8b", "mamba2-780m"])
def test_reduced_model_forward_on_card(cuda, monkeypatch, name):
    """The whole path at a tiny size (S = 256)."""
    _forward_on_card(monkeypatch, cuda, name, 256)


@pytest.mark.parametrize("S", [32, 100])
def test_short_prefill_forward_on_card(cuda, monkeypatch, S):
    """An SSM prefill shorter than one 128-token chunk, which the SSD wrapper
    pads: S = 32 is the edge-serving example's packet."""
    _forward_on_card(monkeypatch, cuda, "mamba2-780m", S)


@pytest.mark.parametrize("S", [100, 256])
def test_cached_ssm_prefill_on_card(cuda, monkeypatch, S):
    """A reduced mamba2's cached prefill, from an empty cache and again from
    the state it left (h0), goes through ``ssd_chunk`` once a layer a
    prefill and agrees with the same prefills through the plain versions;
    a decode step after it too."""
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import transformer

    model = transformer.make_model("mamba2-780m", reduced=True).init(5)
    gen = torch.Generator(device=cuda).manual_seed(6)
    toks = torch.randint(0, model.cfg.vocab, (2, 2 * S + 1), generator=gen, device=cuda)

    def run():
        cache = model.init_cache(2, 2 * S + 1, dtype=torch.float32)
        outs = []
        for lo, hi in ((0, S), (S, 2 * S), (2 * S, 2 * S + 1)):
            logits, cache = model.apply({"tokens": toks[:, lo:hi]}, cache=cache,
                                        cache_index=lo)
            outs.append(logits)
        return outs, cache

    ops.reset_launch_counts()
    outs, cache = run()
    assert ops.launch_counts()["ssd_chunk"] == 2 * model.cfg.n_layers
    with monkeypatch.context() as m:
        m.setattr(sc, "ssd_chunk_fwd", sc.ssd_chunk_plain)
        plain, plain_cache = run()
    torch.cuda.synchronize()
    for got, want in zip(outs, plain):
        assert bool(torch.isfinite(got).all())
        assert _max_rel(got, want) <= 1e-4
    for got, want in zip(cache, plain_cache):
        assert _max_rel(got[1], want[1]) <= 1e-4


# ---------------------------------------------------------------------------
# the MoE FFN (mixtral-8x22b): a layer and its drops at full width, the
# forward at reduced size, the flash kernel at mixtral's heads and window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S", [(4, 2048), (1, 4352)])
def test_flash_attention_at_mixtral_heads(cuda, B, S):
    """48 query heads over 8 KV heads (a GQA group of 6), hd 128, the
    4,096-token window: not binding at S = 2048, binding at 4,352."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(S + B)
    q = torch.randn((B, 48, S, 128), generator=g, device=cuda)
    k = torch.randn((B, 8, S, 128), generator=g, device=cuda)
    v = torch.randn((B, 8, S, 128), generator=g, device=cuda)
    got = fa.flash_attention_fwd(q, k, v, causal=True, window=4096, seq_len=S)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=4096, seq_len=S)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _max_rel(got, want) <= 2e-5


@pytest.fixture(scope="module")
def mixtral_layer():
    """mixtral-8x22b's MoE layer at full width (d 6144, 8 experts of f
    16384; 10 GB of float32 weights) from a seeded generator on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get("mixtral-8x22b")
    g = torch.Generator(device="cuda").manual_seed(11)
    params = {k: torch.empty(s, device="cuda") for k, s in moe.param_shapes(cfg).items()}
    moe.init(params, g)
    yield cfg, params, g
    del params
    torch.cuda.empty_cache()


def test_moe_layer_matches_per_expert_route_on_card(mixtral_layer):
    """``moe.apply`` on 2 x 1024 tokens against the per-expert route: within
    1e-5 of it in float32 and 2e-5 of it in float64 (relative to the largest
    |value|), the aux loss within 1e-6, the same kept choices."""
    from _torch_moe_cases import per_expert_route
    from repro_torch.models import moe

    cfg, p, g = mixtral_layer
    x = torch.randn((2, 1024, cfg.d_model), generator=g, device="cuda")
    out, aux = moe.apply(p, cfg, x)
    T, m = 2048, cfg.moe
    ids = moe.route(p["router"], x.reshape(T, -1), m.top_k)[1].reshape(-1)
    _, keep = moe.slots(ids, m.n_experts, moe.capacity(T, cfg))
    want, raux, kept = per_expert_route(p, cfg, x)
    exact, _, _ = per_expert_route(p, cfg, x, torch.float64)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and torch.equal(keep, kept)
    assert _max_rel(out, want) <= 1e-5 and _max_rel(out, exact) <= 2e-5
    assert abs(float(aux) - raux) <= 1e-6 * raux


def test_moe_drops_first_choices_on_card(mixtral_layer):
    """The reference test's 2 x 32 identical tokens: C = 24, both experts of
    the pair get all 64 choices and keep their first 24; the output that of
    the per-expert route."""
    from _torch_moe_cases import first_choices, per_expert_route
    from repro_torch.models import moe

    cfg, p, g = mixtral_layer
    m = cfg.moe
    x = torch.randn((1, 1, cfg.d_model), generator=g, device="cuda").expand(
        2, 32, cfg.d_model).contiguous()
    C = moe.capacity(64, cfg)
    out, _ = moe.apply(p, cfg, x)
    ids = moe.route(p["router"], x.reshape(64, -1), m.top_k)[1].reshape(-1)
    _, keep = moe.slots(ids, m.n_experts, C)
    want, _, kept = per_expert_route(p, cfg, x)
    torch.cuda.synchronize()
    assert C == 24
    assert sorted(torch.bincount(ids, minlength=m.n_experts).tolist())[-2:] == [64, 64]
    assert torch.equal(keep, first_choices(ids, m.n_experts, C)) and torch.equal(keep, kept)
    assert int(keep.sum()) == 2 * C
    assert bool(torch.isfinite(out).all()) and _max_rel(out, want) <= 1e-5


@pytest.mark.parametrize("S", [256, 320])
def test_reduced_mixtral_forward_on_card(cuda, monkeypatch, S):
    """Reduced mixtral (2 layers, window 64: binding at both lengths) on 2 x S
    tokens: ``flash_attention`` once a layer, and the forward within 1e-4
    of the one through the plain versions, which takes the first run's
    expert choices where its own differ by a tie (1e-4 in probability)."""
    from _torch_moe_cases import forced_routes, recorded_routes
    from repro_torch.models import transformer

    model = transformer.make_model("mixtral-8x22b", reduced=True).init(7)
    toks = torch.randint(0, model.cfg.vocab, (2, S),
                         generator=torch.Generator(device=cuda).manual_seed(8), device=cuda)
    ops.reset_launch_counts()
    with recorded_routes() as routes:
        logits, aux = model.apply({"tokens": toks}, return_aux=True)
    assert ops.launch_counts()["flash_attention"] == model.cfg.n_layers
    with forced_routes(routes, 1e-4):
        plain, plain_aux = _plain_forward(monkeypatch, model, {"tokens": toks},
                                          return_aux=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert _max_rel(logits, plain) <= 1e-4
    assert abs(float(aux) - float(plain_aux)) <= 1e-6 * float(plain_aux)


# ---------------------------------------------------------------------------
# the Jamba hybrid: attention and Mamba-2 layers, MoE every second layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [100, 256])
def test_reduced_hybrid_forward_on_card(cuda, monkeypatch, S):
    """Reduced Jamba (SSM + MoE, attention + dense) at the full config's SSM
    shape (d_state 16, head_dim 64: the kernel's (64, 16) pair) on 2 x S
    tokens: ``ssd_chunk`` and ``flash_attention`` once each, and the forward
    within 1e-4 of the one through the plain versions, which takes the
    first run's expert choices where its own differ by a tie (1e-4 in
    probability).  The cached prefill of the same tokens: ``ssd_chunk``
    once (its SSM layer), no flash launch, within 1e-4 of the forward."""
    from _torch_moe_cases import forced_routes, recorded_routes
    from repro_torch import configs
    from repro_torch.models import transformer

    red = configs.get("jamba-v0.1-52b", reduced=True)
    cfg = dataclasses.replace(red, ssm=dataclasses.replace(red.ssm, d_state=16, head_dim=64))
    model = transformer.Model(cfg).init(9)
    toks = torch.randint(0, cfg.vocab, (2, S),
                         generator=torch.Generator(device=cuda).manual_seed(10), device=cuda)
    ops.reset_launch_counts()
    with recorded_routes() as routes:
        logits, aux = model.apply({"tokens": toks}, return_aux=True)
    counts = ops.launch_counts()
    assert counts["ssd_chunk"] == 1 and counts["flash_attention"] == 1
    assert sum(counts.values()) == 2
    with forced_routes(routes, 1e-4):
        plain, plain_aux = _plain_forward(monkeypatch, model, {"tokens": toks},
                                          return_aux=True)
    ops.reset_launch_counts()
    with forced_routes(routes, 1e-4):
        cached, _ = model.apply({"tokens": toks},
                                cache=model.init_cache(2, S + 8, dtype=torch.float32),
                                cache_index=0)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    assert counts["ssd_chunk"] == 1 and sum(counts.values()) == 1
    assert bool(torch.isfinite(logits).all())
    assert _max_rel(logits, plain) <= 1e-4 and _max_rel(cached, logits) <= 1e-4
    assert abs(float(aux) - float(plain_aux)) <= 1e-6 * float(plain_aux)


# ---------------------------------------------------------------------------
# lu_solve, propagate_step and the member-batched solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trans", [0, 1])
@pytest.mark.parametrize("V", [1, 31, 100, 240])
def test_lu_solve_kernel_matches_plain(cuda, V, trans):
    rng = np.random.default_rng(V + 1000 * trans)
    B = 6
    mats = stage_mats(rng, B, V, loopy=(2,) if V > 1 else ())
    lu = bs.lu_factor_plain(torch.from_numpy(mats).to(cuda)).contiguous()
    rhs = torch.from_numpy(rng.uniform(-1.0, 2.0, (B, V)).astype(np.float32)).to(cuda)
    got = bs.lu_solve(lu, rhs, trans=trans)
    want = bs.lu_solve_plain(lu, rhs, trans=trans)
    torch.cuda.synchronize()
    ok = bs.factor_ok(lu)
    assert _rel(got[ok], want[ok]) <= 1e-5
    assert torch.equal(torch.isfinite(got).all(-1), torch.isfinite(want).all(-1))
    if V > 1:
        assert not ok[2] and not torch.isfinite(got[2]).all()


def test_batched_solve_flags_a_singular_member_on_card(cuda):
    rng = np.random.default_rng(11)
    mats = stage_mats(rng, 6, 23, loopy=(2,))
    m = torch.from_numpy(mats).to(cuda)
    rhs = torch.from_numpy(rng.uniform(0.0, 1.0, (6, 23)).astype(np.float32)).to(cuda)
    for trans in (0, 1):
        ops.reset_launch_counts()
        x, resid = ops.batched_solve(m, rhs, trans=trans)
        assert ops.launch_counts()["lu_solve"] == 1
        good = torch.arange(6, device=cuda) != 2
        a = m.transpose(-1, -2) if trans else m
        want = torch.linalg.solve(a[good], rhs[good])
        assert _rel(x[good], want) <= 1e-5
        assert torch.isinf(resid[2]) and (resid[good] < 1e-5).all()


@pytest.mark.parametrize("V", [1, 31, 100, 240])
def test_propagate_step_kernel_matches_plain(cuda, V):
    rng = np.random.default_rng(V)
    S = 9
    t = torch.from_numpy(rng.uniform(0, 1, (S, V)).astype(np.float32)).to(cuda)
    M = torch.from_numpy(rng.uniform(0, 0.2, (S, V, V)).astype(np.float32)).to(cuda)
    src = torch.from_numpy(rng.uniform(0, 1, (S, V)).astype(np.float32)).to(cuda)
    got = cp.propagate_step(t, M, src)
    want = cp.propagate_step_plain(t, M, src)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5
    fp = ops.solve_fixed_point(M * (1.0 / max(V, 1)), src, sweeps=8)
    want_fp = src.clone() * 0
    for _ in range(8):
        want_fp = cp.propagate_step_plain(want_fp, M * (1.0 / max(V, 1)), src)
    assert _rel(fp, want_fp) <= 1e-5


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    # V=241 no longer fits shared memory: the strips variant solves it
    rhs = torch.arange(241, dtype=torch.float32, device=cuda)[None]
    assert torch.equal(bs.lu_solve(torch.eye(241, device=cuda)[None].contiguous(), rhs), rhs)
    with pytest.raises(ValueError):
        bs.lu_solve(torch.eye(8, device=cuda)[None].contiguous(),
                    torch.zeros((1, 7), device=cuda))
    with pytest.raises(TypeError):
        cp.propagate_step(torch.zeros((2, 4), device=cuda, dtype=torch.float64),
                          torch.zeros((2, 4, 4), device=cuda),
                          torch.zeros((2, 4), device=cuda))
    with pytest.raises(ValueError):
        cp.propagate_step(torch.zeros((2, 4), device=cuda),
                          torch.zeros((2, 4, 5), device=cuda),
                          torch.zeros((2, 4), device=cuda))


@pytest.mark.parametrize("solver", ["GP", "SPOC", "LCOF"])
def test_batched_sweep_matches_serial_on_card(cuda, solver):
    """The Table II six as run_sweep groups them (padded, member-batched)
    against one gp.solve per member, 30 iterations with every latch off:
    final costs within 1e-4."""
    from repro_torch.core import baselines, scenarios

    fam = [sc for sc in scenarios.expand("fig5")
           if sc.label in scenarios.SMALL_TABLE_II]
    kw = dict(alpha=0.1, max_iters=30, tol=-1.0, patience=10**6,
              masks_fn=baselines.BASELINE_MASKS.get(solver))
    bat = scenarios.run_sweep(fam, **kw)
    ser = scenarios.run_sweep_serial(fam, **kw)
    assert bat.n_batches == 2
    for sc, b, s in zip(fam, bat.results, ser.results):
        assert b.iterations == s.iterations == 30, sc.label
        rel = abs(b.final_cost - s.final_cost) / abs(s.final_cost)
        assert rel <= 1e-4, (sc.label, b.final_cost, s.final_cost)


# ---------------------------------------------------------------------------
# The event layer and frozen applications on the card
# ---------------------------------------------------------------------------

def _padded_abilene(device, rate=2.0):
    from repro_torch.core import events

    return events.pad_fleet([network.table_ii_instance("abilene", rate_scale=rate,
                                                       device=device)], 2)[0]


def test_events_on_card_equal_cpu(cuda):
    """A fleet on the card replays the CPU fleet's trace to the same bits."""
    from repro_torch.core import events

    fleets = {d: events.pad_fleet([network.table_ii_instance("abilene", rate_scale=s,
                                                             device=d)
                                   for s in (0.5, 1.5, 3.0)], 2) for d in ("cpu", "cuda")}
    traces = {d: events.random_trace(m, n_events=30, seed=3) for d, m in fleets.items()}
    assert traces["cpu"] == traces["cuda"]
    for (_, a, ea), (_, b, eb) in zip(events.replay(fleets["cpu"], traces["cpu"]),
                                      events.replay(fleets["cuda"], traces["cuda"])):
        for f in network.DENSE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
        assert np.array_equal(ea.touched, eb.touched) and ea.shed == eb.shed


@pytest.mark.parametrize("accel", [False, True])
def test_app_mask_solve_on_card_matches_cpu(cuda, accel):
    """Frozen applications on the card: 14 iterations with the stall latch
    off, the card's history within 1e-5 of the CPU's, the frozen rows
    bit-equal to the start's on every committed iterate, the dense route's
    kernels launched."""
    mask = torch.tensor([True, True, False, False, False])
    alpha = torch.tensor(0.1)
    acc = engine.resolve_accel(accel)
    hist, phis = {}, {}
    for dev in ("cpu", "cuda"):
        inst = _padded_abilene(dev)
        phi0 = gp.init_phi(inst)
        carry = engine.init_carry(inst, phi0, acc)
        m = mask.to(dev)
        ops.reset_launch_counts()
        costs = []
        for _ in range(14):
            carry, cs, _ = engine.scan_chunk(inst, carry, alpha.to(dev), 0.0, 10**6, 10**6,
                                             length=1, accel=acc, app_mask=m)
            costs.append(cs[0])
            assert torch.equal(carry.phi.e[~m], phi0.e[~m])
            assert torch.equal(carry.phi.c[~m], phi0.c[~m])
        hist[dev], phis[dev] = torch.stack(costs), carry.phi
        if dev == "cuda":
            counts = ops.launch_counts()
            assert all(counts[k] >= 14 for k in ("lu_factor", "chain_solve", "tagged"))
    assert _rel(hist["cuda"], hist["cpu"]) <= 1e-5
    assert float((phis["cuda"].e.cpu() - phis["cpu"].e).abs().max()) <= 1e-5


def test_solve_loop_on_card_is_solve(cuda):
    inst = network.table_ii_instance("abilene", rate_scale=2.0)
    kw = dict(alpha=0.1, max_iters=80, patience=15)
    a, b = gp.solve(inst, **kw), gp.solve_loop(inst, **kw)
    assert a.iterations == b.iterations
    assert torch.equal(a.cost_history, b.cost_history)
    assert torch.equal(a.phi.e, b.phi.e)


def test_online_trace_sweep_on_card_matches_serial(cuda):
    """The online-trace family's first 8 events, batched against one by
    one, 30 iterations with every latch off: final costs within 1e-4."""
    from repro_torch.core import scenarios

    kw = dict(alpha=0.1, max_iters=30, tol=-1.0, patience=10**6,
              sweep_kwargs={"n_events": 8})
    bat = scenarios.run_sweep("online-trace", **kw)
    ser = scenarios.run_sweep_serial("online-trace", **kw)
    assert bat.n_batches == 1 and len(bat.results) == 8
    for sc, b, s in zip(bat.scenarios, bat.results, ser.results):
        assert b.iterations == s.iterations == 30, sc.label
        assert abs(b.final_cost - s.final_cost) <= 1e-4 * abs(s.final_cost), sc.label


def test_online_service_seq_on_card(cuda):
    """The service's four-event sequence of ``tests/test_online.py`` on the
    card, free-running from its own cold start, against the reference's run
    (``tests/data/torch_ref_service.npz``): every member event under the
    service's parity contract up to its first departure, which needs a
    witness (``_torch_cases.departure_witness``), the survival claims on
    every event and the reference test's cold bounds; the dense route's
    kernels launch."""
    from _torch_cases import SEQ_COLD_BOUNDS, service_free_run
    from repro_torch.serve import OnlineSolver

    path = os.path.join(os.path.dirname(__file__), "data", "torch_ref_service.npz")
    with np.load(path) as f:
        z = {k: f[k] for k in f.files}
    inst = network.table_ii_instance("abilene", seed=0, rate_scale=0.5)
    ops.reset_launch_counts()
    run = service_free_run(z, "seq", lambda: OnlineSolver([inst], alpha=0.1, tol=1e-4,
                                                          accel=True),
                           cold_parity=SEQ_COLD_BOUNDS)
    assert not run["breaches"], run["breaches"]
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("lu_factor", "chain_solve", "tagged")), counts
    assert run["solver"].device.type == "cuda"


# ---------------------------------------------------------------------------
# Per-member lists (a sparse family) and the dense kernel's round count
# ---------------------------------------------------------------------------

def _mixed_family(device, V=130):
    """sw, geant, sw members at V nodes, padded: their lists differ."""
    from repro_torch.core import batch
    from _torch_cases import sparse_family

    fam = sparse_family(network, (("sw", 0), ("geant", 0), ("sw", 1)), V=V, device=device)
    return batch.pad_instances(fam, hetero_degree="pad")


@pytest.mark.parametrize("trans,reverse,clamp", [(1, False, False), (0, True, True)])
def test_bsr_chain_member_lists_bit_equal_to_a_launch_a_member(cuda, trans, reverse, clamp):
    """One launch with a block list a member equals a stride-0 launch a
    member on the same inputs, bit for bit (iterates and sweep counts), and
    the plain version with the same lists."""
    binst = _mixed_family(cuda)
    assert not torch.equal(binst.blk_mask[0], binst.blk_mask[1])
    cands = engine.ladder_candidates(binst, gp.init_phi(binst), 0.1)[0]
    B, V, K = binst.batch_shape[0], binst.V, binst.K1
    pe = cands.e.reshape(-1, K, V, V).contiguous()
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.uniform(0.0, 2.0, (pe.shape[0], K, V)).astype(np.float32)).to(cuda)
    mult = torch.from_numpy(rng.uniform(0.0, 1.0, (pe.shape[0], K, V)).astype(np.float32)).to(cuda)
    kw = dict(trans=trans, reverse=reverse, clamp=clamp, with_sweeps=True)
    got, sw = ss.chain_solve_bsr(pe, binst.blk_nbr, binst.blk_mask, base, mult, **kw)
    per = pe.shape[0] // B
    for b in range(B):
        rows = slice(b * per, (b + 1) * per)
        one, one_sw = ss.chain_solve_bsr(pe[rows], binst.blk_nbr[b], binst.blk_mask[b],
                                         base[rows], mult[rows], **kw)
        assert torch.equal(got[rows].view(torch.int32), one.view(torch.int32)), b
        assert torch.equal(sw[rows], one_sw), b
    M = pe.transpose(-1, -2) if trans else pe
    want, want_sw = ss.chain_solve_bsr_plain(ss.block_values(M, binst.blk_nbr, binst.blk_mask),
                                             binst.blk_nbr, base, mult, reverse=reverse,
                                             clamp=clamp, with_sweeps=True)
    assert torch.equal(sw, want_sw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_tagged_nbr_member_lists_bit_equal_to_a_launch_a_member(cuda):
    """The neighbor-list blocked-set kernel with a list pair a member: mask,
    tagged flags and rounds equal to a stride-0 launch a member and to the
    plain version with the same lists."""
    binst = _mixed_family(cuda)
    phi = gp.init_phi(binst)
    pdt = marginals.marginals(binst, phi).pdt
    B, V = binst.batch_shape[0], binst.V
    pe, pd = phi.e.reshape(-1, V, V).contiguous(), pdt.reshape(-1, V).contiguous()
    args = (pe, pd, binst.adj, binst.out_nbr, binst.out_mask)
    got = ss.blocked_nbr(*args, eps=engine.BLOCK_EPS, with_rounds=True)
    want = ss.blocked_nbr_plain(*args, eps=engine.BLOCK_EPS, with_rounds=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    per = pe.shape[0] // B
    for b in range(B):
        rows = slice(b * per, (b + 1) * per)
        one = ss.blocked_nbr(pe[rows], pd[rows], binst.adj[b:b + 1], binst.out_nbr[b],
                             binst.out_mask[b], eps=engine.BLOCK_EPS, with_rounds=True)
        for g, w in zip(got, one):
            assert torch.equal(g[rows], w), b


@pytest.mark.parametrize("V", [4, 33, 100, 241, 600])
def test_tagged_rounds_output_equals_plain_count(cuda, V):
    """The dense blocked-set kernel's round count equals its plain
    version's, and asking for it leaves the mask and flags bit-equal."""
    phi, pdt, adj = blocked_set_inputs(V, V, members=2, per=3, special=False)
    t = _on(cuda, phi, pdt, adj)
    mask, tagged, rounds = bset.blocked_dense(*t, eps=engine.BLOCK_EPS, with_tagged=True,
                                              with_rounds=True)
    plain = bset.blocked_dense_plain(*t, eps=engine.BLOCK_EPS, with_tagged=True,
                                     with_rounds=True)
    bare, bare_tagged = bset.blocked_dense(*t, eps=engine.BLOCK_EPS, with_tagged=True)
    assert torch.equal(rounds, plain[2]), (rounds, plain[2])
    assert torch.equal(mask, plain[0]) and torch.equal(tagged, plain[1])
    assert torch.equal(mask, bare) and torch.equal(tagged, bare_tagged)
    assert int(rounds.min()) >= 1
