"""PyTorch port vs JAX reference: service chains cut from model configs, the
instances built from them, and GP on those instances, on the CPU.

The analytic chain profile (``models.flops``, ``core.chain``) is plain
Python/numpy on both sides, so it is held bit for bit, for all ten
architectures.  GP solves are held under the parity contract of the dense
route (ROADMAP Queue 3): with the stall latch off, the same count and a
cost history within 1e-5 relative; the default solve's common prefix and
final cost within 1e-5 and its count reproduced by the stall-latch replay.
The full-width edge instance (``tests/data/torch_ref_edge.json``) splits
where two stepsize-ladder rungs tie in float32, so there the port's step is
held to the reference's from every one of the reference's iterates, and a
free-running solve up to its first rung flip, which must be a tie.  The
reference does not converge there (its cost oscillates until the stall
latch stops it), so a free-running solve's end point is held on the same
chains at a CPU capacity where the reference's cost falls at every step.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
pytest.importorskip("jax")

from repro import configs as jcfg  # noqa: E402
from repro.core import chain as jchain  # noqa: E402
from repro.core import gp as jgp  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.models import flops as jflops  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.core import chain as tchain  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.models import flops as tflops  # noqa: E402
from _torch_cases import edge_step_parity, free_run_split, stall_stop, stepped_rungs  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_ref_edge.json")
FIELDS = ["adj", "link_param", "comp_param", "L", "w", "wnode", "r", "dst",
          "n_tasks", "stage_mask"]
ARCHS = list(jcfg.ALIASES)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-9)))


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_configs_flops_and_chain_bit_equal(name, reduced):
    jc, tc = jcfg.get(name, reduced=reduced), tcfg.get(name, reduced=reduced)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tflops.param_count(tc) == jflops.param_count(jc)
    for seq in (128, 2048):
        assert tflops.layer_flops(tc, seq) == jflops.layer_flops(jc, seq)
        assert tflops.model_flops_per_token(tc, seq) == jflops.model_flops_per_token(jc, seq)
    assert tflops.layer_flops(tc, 1, decode=True, cache_len=4096) == \
        jflops.layer_flops(jc, 1, decode=True, cache_len=4096)
    for n_seg, tpp in ((2, 2048), (3, 128)):
        j = jchain.chain_from_arch(jc, n_segments=n_seg, tokens_per_packet=tpp)
        t = tchain.chain_from_arch(tc, n_segments=n_seg, tokens_per_packet=tpp)
        assert t.name == j.name and t.n_tasks == j.n_tasks
        assert np.array_equal(t.L, j.L) and np.array_equal(t.w, j.w)


def _chain_instances(reduced, link_capacity, comp_capacity, flops_unit):
    names = ("internlm2-1.8b", "mamba2-780m")
    kw = dict(sources=[[0, 2], [1, 5]], rates=[[1.0, 1.0], [1.0, 1.0]], dests=[9, 10],
              link_capacity=link_capacity, comp_capacity=comp_capacity)
    ck = dict(n_segments=2, tokens_per_packet=2048, flops_unit=flops_unit)
    ref = jchain.instance_from_chains(
        jnet.TOPOLOGIES["abilene"](),
        [jchain.chain_from_arch(jcfg.get(n, reduced=reduced), **ck) for n in names], **kw)
    port = tchain.instance_from_chains(
        tnet.TOPOLOGIES["abilene"](),
        [tchain.chain_from_arch(tcfg.get(n, reduced=reduced), **ck) for n in names],
        device="cpu", **kw)
    return ref, port


def test_instance_from_chains_field_by_field(golden):
    ref, port = _chain_instances(False, 160.0, 0.005, 1e12)
    assert (port.link_kind, port.comp_kind) == (ref.link_kind, ref.comp_kind)
    for f in FIELDS:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.shape == want.shape and np.array_equal(got, want), f
        assert np.array_equal(got, np.asarray(golden["instance"][f], dtype=got.dtype)), f
    for c, arch in zip(golden["chains"], golden["archs"]):
        t = tchain.chain_from_arch(tcfg.get(arch), n_segments=2, tokens_per_packet=2048)
        assert c["name"] == t.name
        assert np.array_equal(np.asarray(c["L"]), t.L) and np.array_equal(np.asarray(c["w"]), t.w)


def test_instance_from_chains_refuses_a_silent_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prof = tchain.chain_from_arch(tcfg.get("mamba2-780m"), n_segments=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tchain.instance_from_chains(tnet.TOPOLOGIES["abilene"](), [prof],
                                    sources=[[0]], rates=[[1.0]], dests=[9])
    from repro_torch.models import transformer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.make_model("mamba2-780m", reduced=True)


def test_gp_on_reduced_chain_instance_matches_reference():
    """Reduced configs, a congested instance on which GP takes 70
    iterations: the full parity contract of the module docstring holds."""
    ji, ti = _chain_instances(True, 160.0, 0.005, 1e9)
    ref = jgp.solve(ji, alpha=0.1, max_iters=400, solver="dense")
    ref_hist = np.asarray(ref.cost_history)
    assert ref.iterations > 20
    off = tgp.solve(ti, alpha=0.1, max_iters=ref.iterations, patience=10**6, tol=0.0,
                    device="cpu")
    ref_off = jgp.solve(ji, alpha=0.1, max_iters=ref.iterations, patience=10**6, tol=0.0,
                        solver="dense")
    assert off.iterations == ref.iterations
    assert _rel(np.asarray(ref_off.cost_history), off.cost_history.numpy()) <= 1e-5
    run = tgp.solve(ti, alpha=0.1, max_iters=400, device="cpu")
    hist = run.cost_history.numpy()
    n = min(len(hist), len(ref_hist))
    assert _rel(ref_hist[:n], hist[:n]) <= 1e-5
    assert _rel(ref.final_cost, run.final_cost) <= 1e-5
    assert (stall_stop(ref_hist)[0], stall_stop(hist)[0]) == (ref.iterations, run.iterations)


def test_gp_step_on_edge_instance_matches_reference_iterates(golden):
    """From each of the reference's 52 iterates on the full-width edge
    instance, the port's step: all rung costs, the step's cost, the rung
    (or a tie), the next strategy."""
    _, ti = _chain_instances(False, 160.0, 0.005, 1e12)
    res = edge_step_parity(ti, golden["latch_off"], golden["alpha"])
    assert res["inf_mismatch"] == 0
    assert res["ladder_max_rel"] <= 1e-5 and res["step_max_rel"] <= 1e-5
    assert res["phi_max_abs"] <= 1e-5
    assert not res["untied_flips"], res


def test_free_running_edge_solve_splits_only_at_a_tie(golden):
    """The latch-off solve on the edge instance follows the reference's to
    1e-5 up to its first rung flip, and that flip is a float32 tie of the
    reference's own rung costs; the default solve's count is its own
    history's stall-latch replay."""
    lo = golden["latch_off"]
    _, ti = _chain_instances(False, 160.0, 0.005, 1e12)
    costs, rungs = stepped_rungs(ti, golden["alpha"], lo["iterations"])
    off = tgp.solve(ti, alpha=golden["alpha"], max_iters=lo["iterations"],
                    patience=10**6, tol=0.0, device="cpu")
    hist = off.cost_history.double().numpy()
    assert np.array_equal(hist[1:], costs)
    flip, tied, prefix = free_run_split(hist, rungs, lo)
    assert tied and prefix <= 1e-5, (flip, prefix)
    run = tgp.solve(ti, alpha=golden["alpha"], max_iters=golden["max_iters"], device="cpu")
    dh = run.cost_history.numpy()
    m = min(len(dh), len(hist))
    assert np.array_equal(dh[:m], hist[:m])
    assert stall_stop(dh)[0] == run.iterations
    assert stall_stop(golden["default"]["cost_history"])[0] == golden["default"]["iterations"]
    if flip is None:
        assert run.iterations == golden["default"]["iterations"]


def test_free_running_solve_on_steady_edge_instance_matches_reference(golden):
    """The same two full-width chains with a CPU capacity of 0.04, where the
    reference's cost falls at every one of its 400 steps: the port's
    free-running default solve takes the reference's count and holds its
    whole history, and so its final cost, within 1e-5 (the congested
    instance's reference oscillates and has no final point to hold)."""
    st = golden["steady"]
    _, ti = _chain_instances(False, 160.0, st["comp_capacity"], 1e12)
    run = tgp.solve(ti, alpha=golden["alpha"], max_iters=golden["max_iters"], device="cpu")
    hist = run.cost_history.double().numpy()
    assert run.iterations == st["iterations"]
    assert _rel(st["cost_history"], hist) <= 1e-5
    assert _rel(st["cost_history"][-1], run.final_cost) <= 1e-5
    assert stall_stop(hist)[0] == run.iterations
    assert stall_stop(st["cost_history"])[0] == st["iterations"]


def test_golden_steady_solve_matches_reference(golden):
    """The golden file's steady solve is the reference's: its first 12
    iterations, regenerated here, and a rising cost nowhere in it."""
    st = golden["steady"]
    ref, _ = _chain_instances(False, 160.0, st["comp_capacity"], 1e12)
    res = jgp.solve(ref, alpha=golden["alpha"], max_iters=12, patience=10**6, tol=0.0,
                    solver=golden["solver"])
    assert np.array_equal(np.asarray(res.cost_history, dtype=np.float32),
                          np.asarray(st["cost_history"][:13], dtype=np.float32))
    assert np.all(np.diff(st["cost_history"]) < 0)


def test_golden_edge_file_matches_reference(golden):
    """The golden file is the reference's: the chains and the default
    solve's first 12 iterations, regenerated here."""
    ref, _ = _chain_instances(False, 160.0, 0.005, 1e12)
    for c, arch in zip(golden["chains"], golden["archs"]):
        j = jchain.chain_from_arch(jcfg.get(arch), n_segments=2, tokens_per_packet=2048)
        assert np.array_equal(np.asarray(c["L"]), j.L) and np.array_equal(np.asarray(c["w"]), j.w)
    res = jgp.solve(ref, alpha=golden["alpha"], max_iters=12, solver="dense")
    assert _rel(golden["default"]["cost_history"][:13], res.cost_history) <= 1e-6
    assert len(golden["latch_off"]["phi_e"]) == golden["latch_off"]["iterations"] + 1
