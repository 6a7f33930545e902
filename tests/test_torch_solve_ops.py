"""PyTorch port vs JAX reference: ``lu_solve``, ``propagate_step`` and the
``ops`` entry points that reach them, on the CPU.

On the CPU each wrapper runs its plain PyTorch version, held here against
the reference's own oracles, all within 1e-5 relative (float32 sums in
another order):

  * ``lu_solve`` against the Pallas ``batched_solve.lu_solve`` in interpret
    mode (the same unpivoted two sweeps), both ``trans``, at V = 5, 23 and
    69 (the last crosses the Pallas factor's 32-column panel);
  * ``ops.batched_solve_factored`` / ``ops.batched_solve`` against the
    reference's ``use_pallas=False`` route (LAPACK factors); a singular
    member flags inf without touching the others;
  * the fused chain against a per-stage loop of ``batched_solve_factored``
    (the oracle the card's ``oracle`` phase runs);
  * ``propagate_step`` and ``solve_fixed_point`` against the reference's
    ``ops.propagate_step`` / ``ops.solve_fixed_point`` (Pallas, interpret
    mode), and the Neumann fixed point against the stage traffic of
    ``traffic.flows`` (the reference's own test holds it to 1e-3; the port
    meets 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import gp as jgp  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.kernels import batched_solve as jbs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import traffic as ttr  # noqa: E402
from repro_torch.kernels import batched_solve as tbs  # noqa: E402
from repro_torch.kernels import chain_propagate as tcp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from _torch_cases import stage_mats  # noqa: E402

TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


@pytest.mark.parametrize("trans", [0, 1])
@pytest.mark.parametrize("V", [5, 23, 69])
def test_lu_solve_plain_matches_pallas_interpret(V, trans):
    rng = np.random.default_rng(V + 100 * trans)
    mats = stage_mats(rng, 3, V)
    lu = tbs.lu_factor(torch.from_numpy(mats))
    rhs = rng.uniform(-1.0, 2.0, (3, V)).astype(np.float32)
    want = jbs.lu_solve(jnp.asarray(lu.numpy()), jnp.asarray(rhs), trans=trans,
                        interpret=True)
    got = tbs.lu_solve(lu, torch.from_numpy(rhs), trans=trans)
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(tbs.lu_solve_plain(lu, torch.from_numpy(rhs), trans=trans).numpy(),
                want) <= TOL


@pytest.mark.parametrize("trans", [0, 1])
def test_batched_solve_factored_matches_reference(trans):
    rng = np.random.default_rng(7 + trans)
    mats = stage_mats(rng, 2 * 3 * 4, 31).reshape(2, 3, 4, 31, 31)
    rhs = rng.uniform(0.0, 1.0, (2, 3, 4, 31)).astype(np.float32)
    jfact = jops.batched_factor(jnp.asarray(mats), use_pallas=False)
    want = jops.batched_solve_factored(jfact, jnp.asarray(rhs), trans=trans,
                                       use_pallas=False)
    fact = tops.batched_factor(torch.from_numpy(mats))
    got = tops.batched_solve_factored(fact, torch.from_numpy(rhs), trans=trans)
    assert got.shape == rhs.shape
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("trans", [0, 1])
def test_batched_solve_flags_a_singular_member(trans):
    rng = np.random.default_rng(11)
    mats = stage_mats(rng, 6, 23)
    bad = 2
    mats[bad, :, 5] = 0.0
    mats[bad, 5, :] = 0.0
    rhs = rng.uniform(0.0, 1.0, (6, 23)).astype(np.float32)
    jx, jres = jops.batched_solve(jnp.asarray(mats), jnp.asarray(rhs), trans=trans,
                                  use_pallas=False)
    x, res = tops.batched_solve(torch.from_numpy(mats), torch.from_numpy(rhs),
                                trans=trans)
    good = np.arange(6) != bad
    assert _rel(x.numpy()[good], np.asarray(jx)[good]) <= TOL
    res, jres = res.numpy(), np.asarray(jres)
    assert np.isinf(res[bad]) and not (np.isfinite(jres[bad]) and jres[bad] < 1e3)
    assert np.all(res[good] < TOL) and np.all(jres[good] < TOL)


@pytest.mark.parametrize("trans,reverse,clamp", [(1, False, False), (0, True, True)])
def test_fused_chain_matches_per_stage_lu_solve_loop(trans, reverse, clamp):
    """The fused chain against the loop of single solves it replaced, for
    both GP sweep shapes (traffic: trans=1 forward; marginals: trans=0
    reverse clamped), on the same factors."""
    rng = np.random.default_rng(5)
    Bf, K, V = 3, 5, 22
    P = rng.uniform(0.0, 1.0, (Bf, K, V, V))
    mats = (np.eye(V) - 0.5 * P / P.sum(-1, keepdims=True)).astype(np.float32)
    base = (rng.uniform(0.0, 1.0, (Bf, K, V)) - (0.5 if clamp else 0.0)).astype(np.float32)
    mult = rng.uniform(0.0, 1.0, (Bf, K, V)).astype(np.float32)
    fact = tops.batched_factor(torch.from_numpy(mats))
    base_t, mult_t = torch.from_numpy(base), torch.from_numpy(mult)
    carry = torch.zeros((Bf, V))
    want = [None] * K
    for k in (range(K - 1, -1, -1) if reverse else range(K)):
        fk = tops.BatchedLU(lu=fact.lu[:, k], ok=fact.ok[:, k])
        x = tops.batched_solve_factored(fk, base_t[:, k] + mult_t[:, k] * carry,
                                        trans=trans)
        want[k] = torch.clamp_min(x, 0.0) if clamp else x
        carry = want[k]
    got = tops.fused_chain_solve(fact, base_t, mult_t, trans=trans,
                                 reverse=reverse, clamp=clamp)
    assert _rel(got.numpy(), torch.stack(want, 1).numpy()) <= TOL


@pytest.mark.parametrize("S,V", [(2, 3), (5, 40), (12, 150)])
def test_propagate_step_matches_reference(S, V):
    rng = np.random.default_rng(S * 1000 + V)
    M = (rng.uniform(0.0, 1.0, (S, V, V)) * 0.2).astype(np.float32)
    src = rng.uniform(0.0, 1.0, (S, V)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, (S, V)).astype(np.float32)
    want = np.asarray(jops.propagate_step(jnp.asarray(t), jnp.asarray(M),
                                          jnp.asarray(src)))
    args = [torch.from_numpy(x) for x in (t, M, src)]
    assert _rel(tops.propagate_step(*args).numpy(), want) <= TOL
    assert _rel(tcp.propagate_step_plain(*args).numpy(), want) <= TOL


def test_solve_fixed_point_matches_reference_and_traffic():
    """The Neumann fixed point on Abilene's stage 0 at ``init_phi``
    (t = t Phi_0 + r) against the reference's Pallas sweep and against the
    stage traffic of ``traffic.flows``."""
    jinst = jnet.table_ii_instance("abilene", seed=0)
    jphi = jgp.init_phi(jinst)
    inst = tnet.table_ii_instance("abilene", seed=0, device="cpu")
    phi = tgp.init_phi(inst)
    assert np.array_equal(phi.e.numpy(), np.asarray(jphi.e))
    want = np.asarray(jops.solve_fixed_point(jphi.e[:, 0], jinst.r, sweeps=inst.V))
    got = tops.solve_fixed_point(phi.e[:, 0], inst.r, sweeps=inst.V)
    assert _rel(got.numpy(), want) <= TOL
    t0 = ttr.flows(inst, phi).t[:, 0]
    assert _rel(got.numpy(), t0.numpy()) <= TOL
