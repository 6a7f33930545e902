"""The blocked node sets' plain versions against the reference, on the CPU.

On the card ``engine.blocked_sets`` is one launch of a blocked-set kernel
(``csrc/tagged.cu`` on the dense route, ``csrc/tagged_nbr.cu`` on the
sparse one) that takes ``phi_e``, ``pdt`` and ``adj`` and writes the whole
mask.  Their plain versions (``blocked_sets.blocked_dense_plain``,
``sparse_solve.blocked_nbr_plain``: the composition the kernels replace)
are held here, bit for bit, against the reference's ``engine.blocked_sets``
on seeded inputs at V = 1 to 100 (with NaN, +-inf and -0.0 in phi and pdt),
on a pdt pair whose threshold ``pdt_p + 1e-7`` rounds otherwise in float32
than in float64, and on a padded batch of three Table II instances (one
adjacency a member, dead nodes); the kernels' three-term contract
``~adj | worse | tagged[q]`` (numpy, ``_torch_cases.three_term_mask``)
against the four-term composition; and the glue around the kernels:
``engine.blocked_sets`` calls the kernel wrapper once and runs no other
tensor operation, on either route.  The card tests hold the kernels to
these plain versions (``tests/test_torch_cuda.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import traffic as jtr  # noqa: E402
from repro_torch.core import batch, gp as tgp, marginals as tmg  # noqa: E402
from repro_torch.core import engine as teng, network as tnet  # noqa: E402
from repro_torch.kernels import blocked_sets as tbset  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sparse_solve as tss  # noqa: E402
from _torch_cases import (BLOCK_EPS, blocked_set_inputs, rounding_pair,  # noqa: E402
                          three_term_mask)

EPS = teng.BLOCK_EPS


def _reference(phi, pdt, adj, method="bitset"):
    """The reference's ``engine.blocked_sets`` member by member (each
    member's row batches as (A=1, K1=per)): numpy (B, V, V) bool."""
    B, V = pdt.shape
    per = B // adj.shape[0]
    out = []
    for m in range(adj.shape[0]):
        rows = slice(m * per, (m + 1) * per)
        inst = SimpleNamespace(adj=jnp.asarray(adj[m]), has_sparse=False, V=V)
        ph = jtr.Phi(e=jnp.asarray(phi[rows].reshape(1, per, V, V)),
                     c=jnp.zeros((1, per, V), jnp.float32))
        got = jeng.blocked_sets(inst, ph, jnp.asarray(pdt[rows].reshape(1, per, V)),
                                method=method)
        out.append(np.asarray(got).reshape(per, V, V))
    return np.concatenate(out)


def _neighbors(adj):
    nbr, mask, _, _ = tnet.sparse_neighbors(adj)
    return torch.from_numpy(nbr.astype(np.int64)), torch.from_numpy(mask)


@pytest.mark.parametrize("special", [False, True], ids=["plain", "special"])
@pytest.mark.parametrize("V", [1, 31, 33, 45, 100])
def test_blocked_set_plain_matches_reference(V, special):
    phi, pdt, adj = blocked_set_inputs(V + 7 * special, V, members=2, special=special)
    want = _reference(phi, pdt, adj)
    assert np.array_equal(want, _reference(phi, pdt, adj, method="scan"))
    t_phi, t_pdt, t_adj = (torch.from_numpy(x) for x in (phi, pdt, adj))
    got, tagged = tbset.blocked_dense(t_phi, t_pdt, t_adj, eps=EPS, with_tagged=True)
    assert np.array_equal(got.numpy(), want)
    # the kernels' three-term contract equals the four-term composition
    three, three_tagged = three_term_mask(phi, pdt, adj)
    assert np.array_equal(three, want)
    assert np.array_equal(tagged.numpy(), three_tagged)
    route = t_phi > 0
    worse = t_pdt[:, None, :] > t_pdt[:, :, None] + EPS
    assert torch.equal(tagged, tbset.tagged_scan_dense(route, route & worse))
    # the neighbor-list version, one member at a time (phi routes inside adj)
    for m in range(2):
        nbr, mask = _neighbors(adj[m])
        rows = slice(3 * m, 3 * m + 3)
        got_n, tagged_n, _ = tss.blocked_nbr(t_phi[rows], t_pdt[rows], t_adj[m:m + 1],
                                             nbr, mask, eps=EPS, with_rounds=True)
        assert np.array_equal(got_n.numpy(), want[rows])
        assert torch.equal(tagged_n, tagged[rows])
    if V >= 31 and special:
        assert 0 < int(tagged.sum()) < tagged.numel()     # the case propagates


def test_worse_rounds_as_one_float32_add():
    """pdt_p + 1e-7 is one float32 add in the reference, the plain versions
    and the kernels' contract; through float64 the pair below would give
    the other answer."""
    x, lo, hi = rounding_pair(np.random.default_rng(0))
    f32 = np.float32(x + np.float32(BLOCK_EPS))
    f64 = np.float32(np.float64(x) + BLOCK_EPS)
    assert f32 != f64 and EPS == BLOCK_EPS
    # node 0 routes to node 1 (improper only under the float32 rule)
    V = 2
    phi = np.zeros((1, V, V), np.float32)
    phi[0, 0, 1] = 1.0
    pdt = np.array([[x, hi]], np.float32)
    adj = np.ones((1, V, V), bool)
    worse32 = bool(hi > f32)
    assert worse32 != bool(hi > f64)
    want = _reference(phi, pdt, adj)
    assert bool(want[0, 0, 1]) == worse32
    t = [torch.from_numpy(a) for a in (phi, pdt, adj)]
    got, tagged = tbset.blocked_dense(*t, eps=EPS, with_tagged=True)
    assert np.array_equal(got.numpy(), want)
    assert bool(tagged[0, 0]) == worse32
    nbr, mask = _neighbors(adj[0])
    assert np.array_equal(tss.blocked_nbr(*t, nbr, mask, eps=EPS).numpy(), want)
    assert np.array_equal(three_term_mask(phi, pdt, adj)[0], want)
    # the rule PyTorch itself follows for a float32 tensor plus a scalar
    assert (torch.tensor([x]) + EPS).item() == float(f32)


def test_batched_instance_with_dead_nodes():
    """A padded family (Abilene, GEANT, fog at twice their rates: 11, 22
    and more nodes, one adjacency a member, dead nodes without links):
    3-iteration routes under ``init_phi``'s marginals (stale, so improper
    links), through ``engine.blocked_sets`` on the stacked instance, against
    the reference member by member and the port's scan."""
    insts = [tnet.table_ii_instance(n, rate_scale=2.0, device="cpu")
             for n in ("abilene", "geant", "fog")]
    binst = batch.pad_instances(insts)
    phis = [tgp.solve(i, alpha=0.1, max_iters=3, patience=10**6, tol=0.0,
                      device="cpu").phi for i in insts]
    bphi = batch.pad_phis(phis, insts)
    pdt = tmg.marginals(binst, batch.pad_phis([tgp.init_phi(i) for i in insts],
                                              insts)).pdt
    got = teng.blocked_sets(binst, bphi, pdt)
    assert got.shape == bphi.e.shape
    assert torch.equal(got, teng.blocked_sets(binst, bphi, pdt, method="scan"))
    Mb, A, K1, V = pdt.shape
    want = _reference(bphi.e.reshape(-1, V, V).numpy(), pdt.reshape(-1, V).numpy(),
                      binst.adj.numpy())
    assert np.array_equal(got.reshape(-1, V, V).numpy(), want)
    three, tagged = three_term_mask(bphi.e.reshape(-1, V, V).numpy(),
                                    pdt.reshape(-1, V).numpy(), binst.adj.numpy())
    assert np.array_equal(three, want) and tagged.any()
    for b, inst in enumerate(insts):            # dead nodes: every entry blocked
        assert bool(got[b, :, :, inst.V:, :].all()) and bool(got[b, :, :, :, inst.V:].all())


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every ATen operation that is not a view."""

    def __init__(self):
        super().__init__()
        self.seen, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and not func.is_view:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("route", ["dense", "sparse"])
def test_blocked_sets_are_one_kernel_call(monkeypatch, route):
    """Around the kernel wrapper ``engine.blocked_sets`` runs no tensor
    operation (views aside): on the card the mask is one launch."""
    if route == "dense":
        inst = tnet.table_ii_instance("sw-queue", device="cpu")
        module, name = tbset, "blocked_dense"
    else:
        inst = tnet.metro_instance("sw", 128, device="cpu")
        module, name = tss, "blocked_nbr"
    phi = tgp.init_phi(inst)
    pdt = tmg.marginals(inst, phi).pdt
    want = teng.blocked_sets(inst, phi, pdt, method="scan")
    mode, calls = _Ops(), []
    real = getattr(module, name)

    def kernel(*args, **kwargs):
        calls.append(name)
        mode.paused = True
        try:
            return real(*args, **kwargs)
        finally:
            mode.paused = False

    monkeypatch.setattr(module, name, kernel)
    with mode:
        got = teng.blocked_sets(inst, phi, pdt)
    assert calls == [name] and mode.seen == []
    assert torch.equal(got, want)
