"""PyTorch port vs JAX reference: instances and cost families.

Every ``Instance`` field of the port equals the reference's bit for bit,
and the cost/marginal/saturation functions agree elementwise to 1e-6
relative across the M/M/1 knee, including the ``cap ~ 0`` non-links.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
jnp = pytest.importorskip("jax.numpy")

from repro.core import costs as jcosts  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro_torch.core import costs as tcosts  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402

NAMES = ["abilene", "lhc", "geant", "fog", "balanced-tree", "sw-queue",
         "sw-linear"]
FIELDS = ["adj", "link_param", "comp_param", "L", "w", "wnode", "r", "dst",
          "n_tasks", "stage_mask"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_instance_bit_equal(name, seed):
    ref = jnet.table_ii_instance(name, seed=seed)
    port = tnet.table_ii_instance(name, seed=seed, device="cpu")
    assert (port.link_kind, port.comp_kind) == (ref.link_kind, ref.comp_kind)
    assert (port.V, port.A, port.K1) == (ref.V, ref.A, ref.K1)
    for f in FIELDS:
        a = np.asarray(getattr(ref, f))
        b = getattr(port, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype == np.float32:
            assert b.dtype == np.float32, f
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), f
        else:
            assert np.array_equal(a, b), f
    assert np.array_equal(np.asarray(ref.degenerate_mask()),
                          port.degenerate_mask().numpy())
    assert np.array_equal(np.asarray(ref.cpu_allowed()),
                          port.cpu_allowed().numpy())


def test_topologies_match_reference():
    for name in ["connected-er", "balanced-tree", "fog", "abilene", "lhc",
                 "geant", "sw"]:
        assert np.array_equal(jnet.TOPOLOGIES[name](), tnet.TOPOLOGIES[name]()), name


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-9)))


@pytest.mark.parametrize("kind", [jcosts.LINEAR, jcosts.QUEUE])
def test_costs_across_knee(kind):
    """Loads from 0 to 1.5x capacity on every (i, j) of sw-queue, non-links
    (cap = 0) included, plus loads straddling theta*cap by one ulp."""
    cap = np.asarray(jnet.table_ii_instance("sw-queue").link_param)
    u = np.concatenate([np.linspace(0.0, 1.5, 31),
                        [0.98 * (1 - 1e-6), 0.98, 0.98 * (1 + 1e-6)]])
    F = (u[:, None, None] * np.maximum(cap, 0.5)[None]).astype(np.float32)
    P = np.broadcast_to(cap, F.shape).astype(np.float32)
    for fn in ("cost", "marginal"):
        a = getattr(jcosts, fn)(kind, jnp.asarray(F), jnp.asarray(P))
        b = getattr(tcosts, fn)(kind, torch.from_numpy(F), torch.from_numpy(P))
        assert np.all(np.isfinite(np.asarray(a))), fn
        assert _rel(a, b.numpy()) <= 1e-6, fn
    sa = jcosts.saturated(kind, jnp.asarray(F), jnp.asarray(P))
    sb = tcosts.saturated(kind, torch.from_numpy(F), torch.from_numpy(P))
    assert np.array_equal(np.asarray(sa), sb.numpy())
