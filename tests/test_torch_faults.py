"""PyTorch port vs JAX reference: the fault layer (``core/faults.py``), on
the CPU.

  * ``chaos_trace`` step batch for step batch equal to the reference's,
    live on a two-member fleet (40 events, seed 5), and to the stored
    100-event trace over the fig6 fleet (``tests/data/torch_ref_service.npz``);
  * ``FaultInjector`` with both modes on one carry (a GP iterate shared with
    the reference): the same draws, the same modes and log, the same
    entries corrupted by the same factors, bit for bit, and the corrupted
    fields on the carry's own device; no mask entry lies within 1e-6
    relative of its threshold (1e-6 for ``nan_carry``, 0.5 for
    ``denorm_phi``), where float32 rounding could pick other entries;
  * an unknown mode raises the reference's ``ValueError``.

The two trace tests call ``chaos_trace`` and so carry the ``slow`` marker
(``tests/test_slow_audit.py``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
jax = pytest.importorskip("jax")

from _torch_cases import event_from_dict, same_event, service_run  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import faults as jfa  # noqa: E402
from repro.core import gp as jgp  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import faults as tfa  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.traffic import Phi  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_ref_service.npz")


def _same_steps(port, ref):
    assert [len(b) for b in port] == [len(b) for b in ref]
    assert all(same_event(p, r) for pb, rb in zip(port, ref) for p, r in zip(pb, rb))


@pytest.mark.slow
def test_chaos_trace_equals_reference():
    scales = (0.5, 1.0)
    jm = jev.pad_fleet([jnet.table_ii_instance("abilene", seed=0, rate_scale=s)
                        for s in scales], spare_apps=1)
    tm = tev.pad_fleet([tnet.table_ii_instance("abilene", seed=0, rate_scale=s, device="cpu")
                        for s in scales], spare_apps=1)
    ref = jfa.chaos_trace(jm, n_events=40, seed=5)
    port = tfa.chaos_trace(tm, n_events=40, seed=5)
    _same_steps(port, ref)
    assert any(len(b) > 1 for b in port)


@pytest.mark.slow
def test_chaos100_equals_stored_trace():
    with np.load(GOLDEN) as z:
        js = service_run(z, "chaos100")
    members = tev.pad_fleet([tnet.table_ii_instance("abilene", seed=0, rate_scale=s,
                                                    device="cpu")
                             for s in (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)], spare_apps=2)
    port = tfa.chaos_trace(members, n_events=100, seed=0)
    _same_steps(port, [[event_from_dict(e) for e in b] for b in js["steps"]])
    assert sum(map(len, port)) == len(js["events"]) == 100


def test_injector_modes_equal_reference():
    jinst = jnet.table_ii_instance("abilene", seed=0, rate_scale=1.0)
    tinst = tnet.table_ii_instance("abilene", seed=0, rate_scale=1.0, device="cpu")
    # a GP iterate (fractional rows) shared by both carries
    phi = jgp.solve(jinst, alpha=0.1, max_iters=20, solver="dense").phi
    e, c = np.asarray(phi.e), np.asarray(phi.c)
    jcarry = jeng.init_carry(jinst, phi, accel=jeng.resolve_accel(True))
    tcarry = teng.init_carry(tinst, Phi(e=torch.from_numpy(e.copy()),
                                        c=torch.from_numpy(c.copy())),
                             accel=teng.resolve_accel(True))
    flat = e.reshape(-1)
    live = flat[flat > 0]
    assert np.all(np.abs(live - 1e-6) > 1e-12)
    mass = e.sum(-1) + c
    assert np.all(np.abs(mass - 0.5) > 0.5e-6)
    jinj = jfa.FaultInjector(seed=0, p_inject=1.0)
    tinj = tfa.FaultInjector(seed=0, p_inject=1.0)
    seen = set()
    for t in range(8):
        jc, jmode = jinj.maybe_corrupt(jcarry, member=0, event_index=t)
        tc, tmode = tinj.maybe_corrupt(tcarry, member=0, event_index=t)
        assert tmode == jmode is not None
        seen.add(tmode)
        assert tc.phi.e.device == tcarry.phi.e.device and tc.phi.e.dtype == torch.float32
        assert np.array_equal(tc.phi.e.numpy(), np.asarray(jc.phi.e), equal_nan=True)
        assert np.array_equal(tc.phi.c.numpy(), np.asarray(jc.phi.c), equal_nan=True)
        if tmode == "nan_carry":
            assert np.isnan(float(tc.cost)) and np.isnan(float(tc.best_cost))
        else:     # the cost bookkeeping stays the carry's own
            assert tc.cost is tcarry.cost and tc.best_cost is tcarry.best_cost
    assert seen == set(tfa.FaultInjector.MODES)
    assert [(i.event_index, i.member, i.mode) for i in tinj.log] == \
        [(i.event_index, i.member, i.mode) for i in jinj.log]
    # the input carry is not written
    assert np.array_equal(tcarry.phi.e.numpy(), e)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown fault mode"):
        jfa.FaultInjector(modes=("rowhammer",))
    with pytest.raises(ValueError, match="unknown fault mode"):
        tfa.FaultInjector(modes=("rowhammer",))
