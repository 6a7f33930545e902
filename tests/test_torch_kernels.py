"""PyTorch port vs JAX reference: the plain versions of the three kernels.

On the CPU each kernel wrapper runs its plain PyTorch version, which is
held here against the reference's own oracles:

  * ``lu_factor`` against the Pallas ``batched_solve.lu_factor`` in
    interpret mode (the same unpivoted algorithm) at V=22 and at V=69,
    which crosses the Pallas kernel's 32-column panel: packed factors
    within 1e-5, ``factor_ok`` equal, a singular member flagged without
    poisoning the others;
  * ``chain_solve`` against ``ops.fused_chain_solve(use_pallas=False)``
    (LAPACK factors + block substitution) and a numpy per-stage
    ``np.linalg.solve`` loop, within 1e-5; a loopy member stays non-finite.
    (The Pallas ``chain_solve`` no longer traces in interpret mode on this
    jax: ``pl.load`` is gone.)
  * ``tagged`` against ``tagged_pallas`` in interpret mode and the dense
    sweep ``tagged_scan_dense``: bit-exact, packed words included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import batched_solve as jbs  # noqa: E402
from repro.kernels import blocked_sets as jbset  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core import marginals as tmg  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.kernels import batched_solve as tbs  # noqa: E402
from repro_torch.kernels import blocked_sets as tbset  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from _torch_cases import random_bits, stage_mats  # noqa: E402


@pytest.mark.parametrize("V", [22, 69])
def test_lu_factor_matches_pallas_interpret(V):
    rng = np.random.default_rng(V)
    mats = stage_mats(rng, 4, V)
    want = np.asarray(jbs.lu_factor(jnp.asarray(mats), interpret=True))
    got = tbs.lu_factor(torch.from_numpy(mats)).numpy()
    scale = np.maximum(np.abs(want), 1.0)
    assert np.max(np.abs(got - want) / scale) <= 1e-5
    assert np.array_equal(np.asarray(jbs.factor_ok(jnp.asarray(want))),
                          tbs.factor_ok(torch.from_numpy(got)).numpy())


def test_lu_factor_singular_member_flagged_without_poisoning():
    rng = np.random.default_rng(11)
    mats = stage_mats(rng, 6, 23)
    bad = 2
    mats[bad, :, 5] = 0.0
    mats[bad, 5, :] = 0.0
    want = np.asarray(jbs.lu_factor(jnp.asarray(mats), interpret=True))
    fact = tops.batched_factor(torch.from_numpy(mats))
    ok = fact.ok.numpy()
    assert not ok[bad] and ok[np.arange(6) != bad].all()
    assert np.array_equal(ok, np.asarray(jbs.factor_ok(jnp.asarray(want))))
    good = np.arange(6) != bad
    np.testing.assert_allclose(fact.lu.numpy()[good], want[good], atol=1e-5,
                               rtol=1e-5)


def _np_chain(mats, base, mult, trans, reverse, clamp, skip=()):
    """Per-stage ``np.linalg.solve`` loop in float64 (NaN for ``skip``)."""
    B, K, V = base.shape
    out = np.full((B, K, V), np.nan)
    for b in range(B):
        if b in skip:
            continue
        x = np.zeros(V)
        for k in (range(K - 1, -1, -1) if reverse else range(K)):
            A = mats[b, k].astype(np.float64)
            x = np.linalg.solve(A.T if trans else A,
                                base[b, k] + mult[b, k] * x)
            if clamp:
                x = np.maximum(x, 0.0)
            out[b, k] = x
    return out


@pytest.mark.parametrize("trans,reverse,clamp", [(1, False, False),
                                                 (0, True, True)])
def test_chain_solve_matches_reference(trans, reverse, clamp):
    rng = np.random.default_rng(5 + trans)
    B, K, V = 5, 3, 22
    loopy = 3
    mats = stage_mats(rng, B * K, V, loopy=(loopy * K + 1,)).reshape(B, K, V, V)
    base = rng.uniform(0.0, 2.0, (B, K, V)).astype(np.float32)
    mult = rng.uniform(0.0, 1.0, (B, K, V)).astype(np.float32)

    rfact = jops.batched_factor(jnp.asarray(mats), use_pallas=False)
    want = np.asarray(jops.fused_chain_solve(
        rfact, jnp.asarray(base), jnp.asarray(mult), trans=trans,
        reverse=reverse, clamp=clamp, use_pallas=False))
    fact = tops.batched_factor(torch.from_numpy(mats))
    got = tops.fused_chain_solve(fact, torch.from_numpy(base),
                                 torch.from_numpy(mult), trans=trans,
                                 reverse=reverse, clamp=clamp).numpy()
    exact = _np_chain(mats, base, mult, trans, reverse, clamp, (loopy,))

    good = np.arange(B) != loopy
    scale = np.maximum(np.abs(exact[good]), 1.0)
    assert np.max(np.abs(got[good] - want[good]) / scale) <= 1e-5
    assert np.max(np.abs(got[good] - exact[good]) / scale) <= 1e-5
    assert not fact.ok.numpy()[loopy, 1]
    assert not np.all(np.isfinite(got[loopy]))


def test_chain_clamp_keeps_nan():
    """The clamp is jnp.maximum's: NaN stays NaN (fmaxf would give 0)."""
    lu = torch.ones((3, 2, 1, 1))
    base = torch.tensor([[1.0, 0.5], [-2.0, -1.0], [float("nan"), 1.0]])[..., None]
    x = tbs.chain_solve(lu, base, torch.zeros_like(base), trans=0,
                        reverse=True, clamp=True)
    assert torch.equal(x[:2], torch.tensor([[1.0, 0.5], [0.0, 0.0]])[..., None])
    assert torch.isnan(x[2, 0]).all() and x[2, 1].item() == 1.0


def _congested_bits(name):
    """Routes of a 3-iteration iterate under the init strategy's marginals
    at twice the Table II rates: stale marginals make improper links.
    Made by the port, whose solve and marginals ``test_torch_gp.py`` holds
    to the reference's."""
    inst = tnet.table_ii_instance(name, seed=0, rate_scale=4.0, device="cpu")
    phi = tgp.solve(inst, alpha=0.1, max_iters=3, patience=10**6, tol=0.0,
                    device="cpu").phi
    pdt = tmg.marginals(inst, tgp.init_phi(inst)).pdt
    route = phi.e > 0.0
    worse = pdt[:, :, None, :] > pdt[:, :, :, None] + 1e-7
    V = inst.V
    return (route.reshape(-1, V, V).numpy(),
            (route & worse).reshape(-1, V, V).numpy())


@pytest.mark.parametrize("case", ["random-sparse", "random-dense",
                                  "geant-congested"])
def test_tagged_bit_exact(case):
    if case == "geant-congested":
        route, improper = _congested_bits("geant")
    else:
        rng = np.random.default_rng(3)
        route, improper = random_bits(
            rng, 12, 45, 0.05 if case == "random-sparse" else 0.3)
    V = route.shape[-1]
    Vp, _ = jbset.padded_nodes(V)
    row_pad = ((0, 0), (0, Vp - V), (0, 0))
    r_bits = jnp.pad(jbset.pack_bits(jnp.asarray(route)), row_pad)
    i_bits = jnp.pad(jbset.pack_bits(jnp.asarray(improper)), row_pad)
    want = np.asarray(jbset.tagged_pallas(r_bits, i_bits, V, interpret=True))
    dense = np.asarray(jbset.tagged_scan_dense(jnp.asarray(route),
                                               jnp.asarray(improper)))
    assert np.array_equal(want, dense)
    assert 0 < want.sum() < want.size          # the case propagates

    # packed words in, packed words out: bit-equal to the reference's words
    t_r = torch.from_numpy(np.array(r_bits).view(np.int32))
    t_i = torch.from_numpy(np.array(i_bits).view(np.int32))
    assert torch.equal(t_r[:, :V], tbset.pack_bits(torch.from_numpy(route)))
    words = tbset.tagged_plain(t_r, t_i).numpy()
    want_words = np.asarray(jbset.pack_bits(jnp.asarray(want))).view(np.int32)
    assert np.array_equal(words, want_words)
    assert np.array_equal(tbset.unpack_bits(torch.from_numpy(words), V).numpy(),
                          want)
    got = tops.blocked_tagged(torch.from_numpy(route),
                              torch.from_numpy(improper)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(
        tbset.tagged_scan_dense(torch.from_numpy(route),
                                torch.from_numpy(improper)).numpy(), want)
