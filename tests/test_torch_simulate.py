"""PyTorch port vs JAX reference: the packet-level simulator, on the CPU.

``simulate`` runs its event loop on the host in numpy, with the
reference's random draws in the reference's order, so on the same strategy
and seed the port's ``n_delivered``, ``mean_delay`` and
``mean_queue_occupancy`` equal the reference's exactly; only
``predicted_delay`` comes from the port's float32 cost (within 1e-5
relative).  Against the stored run ``mean_delay`` is held within
``_torch_cases.SIM_MEAN_TOL``: both take ``numpy.mean``, whose pairwise sum
rounds by the numpy build of the host that runs it.  Held on the reference's GP strategy for Abilene at rate 1.5
(``tests/data/torch_ref_online.npz``): against the reference's simulator
run here at a short horizon, and against the file's full-horizon run.
Then ``tests/test_simulate.py``'s analytic-against-simulated check on the
port's own GP output: Little's law within 30%.  Every test calls
``simulate`` and so carries the ``slow`` marker (``tests/test_slow_audit.py``).
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
pytest.importorskip("jax")

from _torch_cases import SIM_MEAN_TOL  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core.traffic import Phi as JPhi  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.traffic import Phi, total_cost  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_ref_online.npz")


@functools.lru_cache(maxsize=None)
def _golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("sim/") or k == "meta"}


def _case():
    z = _golden()
    p = json.loads(str(z["meta"]))["sim"]
    tinst = tnet.table_ii_instance(p["scenario"], seed=p["seed"], rate_scale=p["rate_scale"],
                                   device="cpu")
    phi = Phi(e=torch.from_numpy(z["sim/phi_e"]), c=torch.from_numpy(z["sim/phi_c"]))
    return p, tinst, phi, z


def _same(got, want, mean_tol=0.0):
    assert got.n_delivered == want.n_delivered
    assert abs(got.mean_delay - want.mean_delay) <= mean_tol * abs(want.mean_delay)
    assert got.mean_queue_occupancy == want.mean_queue_occupancy
    assert abs(got.predicted_delay - want.predicted_delay) <= 1e-5 * abs(want.predicted_delay)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 7])
def test_simulate_matches_reference_short_horizon(seed):
    p, tinst, phi, _ = _case()
    jinst = jnet.table_ii_instance(p["scenario"], seed=p["seed"], rate_scale=p["rate_scale"])
    kw = dict(horizon=400.0, warmup=40.0, seed=seed)
    want = jsim.simulate(jinst, JPhi(e=phi.e.numpy(), c=phi.c.numpy()), **kw)
    got = tsim.simulate(tinst, phi, **kw)
    assert got.n_delivered > 1000
    _same(got, want)
    # a numpy strategy gives the same result
    _same(tsim.simulate(tinst, Phi(e=phi.e.numpy(), c=phi.c.numpy()), **kw), want)


@pytest.mark.slow
def test_simulate_matches_stored_full_horizon():
    p, tinst, phi, z = _case()
    got = tsim.simulate(tinst, phi, horizon=p["horizon"], warmup=p["warmup"],
                        seed=p["sim_seed"])
    want = tsim.SimResult(**{f.name: z[f"sim/{f.name}"].item()
                             for f in dataclasses.fields(tsim.SimResult)})
    _same(got, want, mean_tol=SIM_MEAN_TOL)


@pytest.mark.slow
def test_littles_law_on_the_ports_gp_output():
    p, tinst, _, _ = _case()
    res = tgp.solve(tinst, alpha=p["alpha"], max_iters=p["max_iters"], device="cpu")
    sim = tsim.simulate(tinst, res.phi, horizon=p["horizon"], warmup=p["warmup"],
                        seed=p["sim_seed"])
    assert sim.n_delivered > 3000
    # queueing simulations are noisy and service is per-class exponential
    # (an M/M/1 approximation): 30% agreement, as tests/test_simulate.py
    assert sim.mean_delay == pytest.approx(sim.predicted_delay, rel=0.30)
    assert sim.mean_queue_occupancy == pytest.approx(float(total_cost(tinst, res.phi)),
                                                     rel=0.30)


@pytest.mark.slow
def test_simulate_refuses_a_stacked_family():
    from repro_torch.core import batch

    inst = tnet.table_ii_instance("abilene", device="cpu")
    binst = batch.pad_instances([inst, inst])
    phi = tgp.init_phi(binst)
    with pytest.raises(ValueError, match="one instance"):
        tsim.simulate(binst, phi, horizon=10.0, warmup=1.0)
