"""PyTorch port vs JAX reference: batching sparse families, on the CPU.

A stacked family of sparse instances (``batch.pad_instances`` over members
with ``network.with_sparse``) carries its neighbor and block lists with a
member dim, and the sparse route reads each member's own lists (on the
card, one launch of ``bsr_chain`` / ``tagged_nbr`` with a member stride;
here their plain versions).  Held here:

  * the padding policies of the reference's ``tests/test_sparse.py``
    (a degree-12 star with degree-2 rings: "raise", "pad", "strip"; a
    sparse-dense mix refused; a padded member's topology re-derived), and
    every padded field, sparse ones too, bit-equal to the reference's;
  * the plain versions' per-member lists equal to a loop over the members,
    each with its own list, bit for bit;
  * ``gp.solve_batched`` on two families at V = 100 (three sw members; sw,
    geant and sw, so the lists differ) on the sparse route, against the
    reference's batched sparse solve (``tests/data/
    torch_ref_sparse_batch.npz``): cost histories within 1e-5, and within
    1e-4 of the port's one-by-one solves (bit-equal on the CPU), also
    through the compaction of members that stop early.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
jax = pytest.importorskip("jax")

from repro.core import batch as jbatch  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro_torch.core import batch as tbatch  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core import marginals as tmg  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import traffic as ttr  # noqa: E402
from repro_torch.kernels import sparse_solve as tss  # noqa: E402
from _torch_cases import sparse_family  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_ref_sparse_batch.npz")
FAMILIES = {"sw100": (("sw", 0), ("sw", 1), ("sw", 2)),
            "mixed": (("sw", 0), ("geant", 0), ("sw", 1))}
KW = dict(alpha=0.1, max_iters=16, patience=10**6, tol=0.0, device="cpu")
FIELDS = tnet.DENSE_FIELDS + tnet.SPARSE_FIELDS


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def sparse_route(monkeypatch):
    """Send every sparse instance down the sparse route (the reference's
    ``solver="sparse"``), whatever its V."""
    monkeypatch.setattr(ttr, "SPARSE_MIN_V", 0)


def _star(n_leaves):
    adj = np.zeros((n_leaves + 1, n_leaves + 1), dtype=bool)
    adj[0, 1:] = adj[1:, 0] = True
    return adj


def _ring(V):
    adj = np.zeros((V, V), dtype=bool)
    for i in range(V):
        adj[i, (i + 1) % V] = adj[(i + 1) % V, i] = True
    return adj


def _pair(adj, seed):
    return (jnet.with_sparse(jnet.build_instance(adj, n_apps=2, seed=seed)),
            tnet.with_sparse(tnet.build_instance(adj, n_apps=2, seed=seed, device="cpu")))


def _same_fields(ref, port, names=FIELDS):
    for f in names:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.shape == b.shape, f
        assert np.array_equal(a, b), f


def test_pad_instances_hetero_degree():
    """A degree-12 star with degree-2 rings: "raise" refuses, "pad" pads to
    the star's degree (fields bit-equal to the reference's), "strip" drops
    the topology; a sparse-dense mix raises; near-equal degrees stay sparse
    under the default."""
    star_j, star = _pair(_star(12), 0)
    ring_j, ring = _pair(_ring(13), 1)
    assert star.max_degree > tbatch._HETERO_DEGREE_RATIO * ring.max_degree

    with pytest.raises(ValueError, match="degree"):
        tbatch.pad_instances([star, ring])
    padded = tbatch.pad_instances([star, ring], hetero_degree="pad")
    assert padded.has_sparse and padded.out_nbr.shape[0] == 2
    assert padded.out_nbr.shape[-1] >= star.max_degree
    _same_fields(jbatch.pad_instances([star_j, ring_j], hetero_degree="pad"), padded)

    stripped = tbatch.pad_instances([star, ring], hetero_degree="strip")
    assert not stripped.has_sparse
    _same_fields(jbatch.pad_instances([star_j, ring_j], hetero_degree="strip"), stripped,
                 tnet.DENSE_FIELDS)

    with pytest.raises(ValueError):
        tbatch.pad_instances([star, tnet.without_sparse(ring)])
    with pytest.raises(ValueError):
        tbatch.pad_instances([star, ring], hetero_degree="dense")

    ring2_j, ring2 = _pair(_ring(13), 2)
    ok = tbatch.pad_instances([ring, ring2])
    assert ok.has_sparse
    _same_fields(jbatch.pad_instances([ring_j, ring2_j]), ok)


def test_pad_instance_rederives_sparse():
    """Padding one member re-derives its topology on the padded adjacency:
    dead nodes isolated (self-pointing, masked), live rows unchanged."""
    ref = jnet.with_sparse(jnet.table_ii_instance("abilene"))
    inst = tnet.with_sparse(tnet.table_ii_instance("abilene", device="cpu"))
    out = tbatch.pad_instance(inst, inst.V + 5, inst.A, inst.K1)
    assert out.has_sparse and out.out_nbr.shape[0] == inst.V + 5
    assert not bool(out.out_mask[inst.V:].any())
    assert torch.equal(out.out_nbr[inst.V:, 0], torch.arange(inst.V, inst.V + 5))
    assert torch.equal(out.out_mask[:inst.V], inst.out_mask)
    _same_fields(jbatch.pad_instance(ref, inst.V + 5, inst.A, inst.K1), out)


@pytest.mark.parametrize("part", sorted(FAMILIES))
def test_family_fields_and_slices(part):
    """The V = 100 families padded as the reference pads them, bit for
    bit; ``instance_slice`` returns a member with its own lists."""
    ref = jbatch.pad_instances(sparse_family(jnet, FAMILIES[part]))
    binst = tbatch.pad_instances(sparse_family(tnet, FAMILIES[part], device="cpu"))
    _same_fields(ref, binst)
    for b in range(3):
        one = tbatch.instance_slice(binst, b)
        assert one.batch_shape == () and one.blk_nbr.shape == binst.blk_nbr.shape[1:]
        assert torch.equal(one.out_nbr, binst.out_nbr[b])
    if part == "mixed":
        assert not torch.equal(binst.out_mask[0], binst.out_mask[1])


def test_plain_versions_member_lists_equal_a_loop():
    """The plain blocked chain solve, neighbor-list sweep and blocked mask
    with a list a member equal each member run alone on its own list (and
    the shared-list call where the lists are one)."""
    binst = tbatch.pad_instances(sparse_family(tnet, FAMILIES["mixed"], V=70, device="cpu"))
    B, V, K = 3, binst.V, binst.K1
    phi = tgp.init_phi(binst)
    cands = teng.ladder_candidates(binst, phi, 0.1)[0]            # (B, R, A, K1, V, V)
    pe = cands.e.reshape(-1, K, V, V)
    per = pe.shape[0] // B
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.uniform(0, 2, (pe.shape[0], K, V)).astype(np.float32))
    mult = torch.from_numpy(rng.uniform(0, 1, (pe.shape[0], K, V)).astype(np.float32))
    for trans, reverse, clamp in ((1, False, False), (0, True, True)):
        kw = dict(trans=trans, reverse=reverse, clamp=clamp, with_sweeps=True)
        got, sw = tss.chain_solve_bsr(pe, binst.blk_nbr, binst.blk_mask, base, mult, **kw)
        for b in range(B):
            rows = slice(b * per, (b + 1) * per)
            one, one_sw = tss.chain_solve_bsr(pe[rows], binst.blk_nbr[b], binst.blk_mask[b],
                                              base[rows], mult[rows], **kw)
            assert torch.equal(got[rows].view(torch.int32), one.view(torch.int32)), b
            assert torch.equal(sw[rows], one_sw), b
    pdt = tmg.marginals(binst, phi).pdt
    pe3, pd2 = phi.e.reshape(-1, V, V), pdt.reshape(-1, V)
    per = pe3.shape[0] // B
    got = tss.blocked_nbr(pe3, pd2, binst.adj, binst.out_nbr, binst.out_mask,
                          eps=teng.BLOCK_EPS, with_rounds=True)
    for b in range(B):
        rows = slice(b * per, (b + 1) * per)
        one = tss.blocked_nbr(pe3[rows], pd2[rows], binst.adj[b:b + 1], binst.out_nbr[b],
                              binst.out_mask[b], eps=teng.BLOCK_EPS, with_rounds=True)
        for g, w in zip(got, one):
            assert torch.equal(g[rows], w), b
    same = binst.out_nbr[:1].expand(B, V, -1).contiguous()
    same_mask = binst.out_mask[:1].expand(B, V, -1).contiguous()
    for g, w in zip(tss.blocked_nbr(pe3, pd2, binst.adj, same, same_mask, eps=teng.BLOCK_EPS,
                                    with_rounds=True),
                    tss.blocked_nbr(pe3, pd2, binst.adj, binst.out_nbr[0], binst.out_mask[0],
                                    eps=teng.BLOCK_EPS, with_rounds=True)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("part", sorted(FAMILIES))
def test_solve_batched_sparse_matches_reference(part, golden, sparse_route, monkeypatch):
    """The batched sparse solve against the reference's: histories within
    1e-5; the one-by-one solves within 1e-4 of the batched (bit-equal on the
    CPU); no stage factored."""
    def refuse(*a, **k):
        raise AssertionError("the sparse route factored a stage")

    monkeypatch.setattr(ttr, "stage_factors", refuse)
    binst = tbatch.pad_instances(sparse_family(tnet, FAMILIES[part], device="cpu"))
    res = tgp.solve_batched(binst, **KW)
    ref = golden[f"{part}/batched/cost"].astype(np.float64)
    got = res.cost_history.double().numpy()
    assert np.array_equal(res.iterations.numpy(), golden[f"{part}/batched/iterations"])
    assert float((np.abs(got - ref) / np.abs(ref)).max()) <= 1e-5
    for b in range(3):
        one = tgp.solve(tbatch.instance_slice(binst, b), **KW).cost_history.double().numpy()
        assert float((np.abs(one - got[b]) / np.abs(got[b])).max()) <= 1e-4, b


def test_solve_batched_sparse_compacts_members(sparse_route):
    """Members that stop early leave the batch with their lists: each
    member's history and count equal its run alone, and its final cost."""
    binst = tbatch.pad_instances(sparse_family(tnet, FAMILIES["mixed"], V=70, device="cpu"))
    kw = dict(alpha=0.1, max_iters=24, tol=1e-3, device="cpu")
    res = tgp.solve_batched(binst, **kw)
    assert len(set(res.iterations.tolist())) > 1, res.iterations
    for b in range(3):
        one = tgp.solve(tbatch.instance_slice(binst, b), **kw)
        assert one.iterations == int(res.iterations[b]), b
        n = one.iterations + 1
        assert torch.equal(res.cost_history[b, :n], one.cost_history), b
