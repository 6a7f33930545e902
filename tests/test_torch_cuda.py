"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card: it carries the ``gpu`` marker and
skips where ``torch.cuda.is_available()`` is False.  The file imports no
JAX, so it runs on a machine with PyTorch and CUDA alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  The kernels are
built from ``src/repro_torch/kernels/csrc`` with ``nvcc`` at first use.
Tolerances: 1e-5 relative for the float32 kernels (they sum in another
order than the plain versions and fuse multiply-adds); bit-exact for the
tagged bitsets.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gp, network  # noqa: E402
from repro_torch.kernels import batched_solve as bs  # noqa: E402
from repro_torch.kernels import blocked_sets as bset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from _torch_cases import random_bits, stage_mats  # noqa: E402

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


def test_chain_clamp_keeps_nan_on_card(cuda):
    lu = torch.ones((3, 2, 1, 1), device=cuda)
    base = torch.tensor([[1.0, 0.5], [-2.0, -1.0], [float("nan"), 1.0]],
                        device=cuda)[..., None]
    x = bs.chain_solve(lu, base.contiguous(), torch.zeros_like(base), trans=0,
                       reverse=True, clamp=True).cpu()
    assert torch.equal(x[:2], torch.tensor([[1.0, 0.5], [0.0, 0.0]])[..., None])
    assert torch.isnan(x[2, 0]).all() and x[2, 1].item() == 1.0


@pytest.mark.parametrize("V,density", [(45, 0.05), (100, 0.03), (100, 0.3),
                                       (200, 0.01)])
def test_tagged_kernel_bit_equal_to_plain(cuda, V, density):
    rng = np.random.default_rng(V)
    route, improper = random_bits(rng, 16, V, density)
    Vp, W = bset.padded_nodes(V)

    def packed(x):
        bits = bset.pack_bits(torch.from_numpy(x).to(cuda))
        return torch.cat([bits, bits.new_zeros((16, Vp - V, W))], dim=1).contiguous()

    r, i = packed(route), packed(improper)
    got = bset.tagged(r, i)
    want = bset.tagged_plain(r, i)
    assert torch.equal(got, want)
    dense = bset.tagged_scan_dense(torch.from_numpy(route), torch.from_numpy(improper))
    assert torch.equal(bset.unpack_bits(got, V).cpu(), dense)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    m = torch.eye(8, device=cuda).repeat(2, 1, 1)
    with pytest.raises(TypeError):
        bs.lu_factor(m.double())
    with pytest.raises(ValueError):
        bs.lu_factor(m.transpose(1, 2))
    with pytest.raises(ValueError, match="shared memory"):
        bs.lu_factor(torch.eye(250, device=cuda)[None].contiguous())
    lu = m.reshape(1, 2, 8, 8)
    with pytest.raises(ValueError):
        bs.chain_solve(lu, torch.zeros((1, 2, 7), device=cuda),
                       torch.zeros((1, 2, 7), device=cuda))
    with pytest.raises(ValueError):
        bset.tagged(torch.zeros((1, 32, 1), device=cuda),
                    torch.zeros((1, 32, 1), device=cuda))


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
