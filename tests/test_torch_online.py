"""PyTorch port vs JAX reference: the online GP service
(``serve/online.py``), on the CPU.

Held against ``tests/data/torch_ref_service.npz`` (the reference's
``OnlineSolver`` runs, ``tests/data/make_torch_ref_service.py``) under the
service's parity contract (``_torch_cases.event_parity``): per event the
exact report fields equal, costs within 1e-5 relative, counts equal, and
each re-convergence segment within 1e-5 of the reference's history with
its count reproduced by the service's stop test (the phi fixed-point latch
and the plateau probe included) up to its first departure.  A departure
needs a witness that float32 rounding decides it
(``_torch_cases.departure_witness``): the two choices tied in float64, the
departing step from a one-ulp move of its input taking the reference's
decision or moving its cost as far as the reference's lies, or a run from
a one-ulp start taking the reference's branch.  Every event is held to the
survival claims (served cost at most 1e-4 above the incumbent unless
rejected, no member left corrupt).

  * the four-event sequence of ``tests/test_online.py`` free-running from
    the port's own cold start: its surge event departs at a witnessed rung
    tie (the reference's warm round takes 105 iterations there, the port's
    18; the reference's cold solve takes 53, so "warm beats cold" is not
    held); after it the survival claims and the reference test's cold
    bounds;
  * 17 events of the fig6 50-event trace teacher-forced from the
    reference's stored pre-event state: every event type, a gate skip, a
    topology repair and cold restarts (the trace has no unfreeze round), and
    departures of every kind the trace shows on the CPU and every witness
    (an untied rung flip, rung and Anderson ties, one in a second segment,
    and two partings);
  * the impossible-budget ladder of ``tests/test_faults.py``
    (``tol=1e-12, max_iters=4``) down to ``baseline:SPOC``;
  * recovery from each fault-injection mode;
  * ``telemetry=`` other than None / False raises, and the entry point
    refuses instances on another device.
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially

from _torch_cases import (SEQ_COLD_BOUNDS, service_forced_pass, service_free_run,  # noqa: E402
                          service_run)
from repro_torch.core import events, faults, network  # noqa: E402
from repro_torch.serve import OnlineSolver  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_ref_service.npz")
ALPHA, TOL = 0.1, 1e-4
FIG6_SCALES = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)
# Teacher-forced fig6-trace events, chosen by coverage: every event type
# (RateScale 1, 2, 29, 49; AppDeparture 7, 39; AppArrival 13, 48; LinkDown
# 10, 17, 30, 43, 45; LinkUp 28, 47; NodeDown 35, 42), a topology repair
# with a cold restart (10), a cold restart (13), a gate skip (17), and, on
# the CPU, every departure kind and witness of the trace: an untied rung
# flip witnessed by a one-ulp start (2), rung ties (30 in its second
# segment, 45, 47, 48, 49) and Anderson ties (29, 35, 39) tied in float64 or
# flipped by a one-ulp step, and the two partings (42, 43) whose step a
# one-ulp move spreads as far.
FORCED_EVENTS = (1, 2, 7, 10, 13, 17, 28, 29, 30, 35, 39, 42, 43, 45, 47, 48, 49)


@functools.lru_cache(maxsize=None)
def _golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _abilene(scale):
    return network.table_ii_instance("abilene", seed=0, rate_scale=scale, device="cpu")


def _no_breach(run):
    assert not run["breaches"], run["breaches"]


def test_reference_file_records_the_surge_event():
    z = _golden()
    seq = service_run(z, "seq")["per_event"]
    # the reference's warm round on the surge event under this jax, and its
    # cold solve of the same instance
    assert (seq[1]["report"]["iterations"], seq[1]["cold"]["iterations"]) == (105, 53)
    assert {"fig6-trace50", "chaos-trace100"} <= set(json.loads(str(z["meta"]))["anchors"])


def test_seq_free_run_against_reference():
    run = service_free_run(
        _golden(), "seq",
        lambda: OnlineSolver([_abilene(0.5)], alpha=ALPHA, tol=TOL, accel=True, device="cpu"),
        cold_parity=SEQ_COLD_BOUNDS)
    _no_breach(run)
    lines = run["lines"]
    assert [ln["verdict"] for ln in lines[:2]] == ["match", "departs"]
    assert lines[1]["reference_iterations"] == 105 and lines[1]["witness"]["ok"]
    assert run["solver"].event_iters == sum(r.iterations for r in run["solver"].reports)


@pytest.fixture(scope="module")
def fleet():
    insts = [_abilene(s) for s in FIG6_SCALES]
    solver = OnlineSolver(insts, spare_apps=2, alpha=ALPHA, tol=TOL, accel=True,
                          device="cpu")
    return solver, events.pad_fleet(insts, spare_apps=2)


@pytest.mark.parametrize("t", FORCED_EVENTS)
def test_trace50_teacher_forced(fleet, t):
    solver, members = fleet
    run = service_forced_pass(_golden(), "trace50", solver, members, events={t})
    _no_breach(run)
    (line,) = run["lines"]
    assert line["verdict"] == "match" or line["witness"]["ok"], line


def test_impossible_budget_climbs_to_the_baseline():
    run = service_free_run(
        _golden(), "budget",
        lambda: OnlineSolver([_abilene(1.0)], alpha=ALPHA, tol=1e-12, max_iters=4,
                             accel=True, device="cpu"),
        tol=1e-12, max_iters=4)
    _no_breach(run)
    (line,) = run["lines"]
    assert line["verdict"] == "match"
    assert line["rungs"] == ["warm", "warm-clear", "cold", "baseline:SPOC"]
    assert not run["solver"].verify_member(0).corrupt


@pytest.mark.parametrize("mode", faults.FaultInjector.MODES)
def test_service_recovers_from_injection(mode):
    run = service_free_run(
        _golden(), f"inject/{mode}",
        lambda: OnlineSolver([_abilene(0.5)], alpha=ALPHA, tol=TOL, accel=True, debug=True,
                             fault_injector=faults.FaultInjector(seed=0, p_inject=1.0,
                                                                 modes=(mode,)),
                             device="cpu"))
    _no_breach(run)
    (line,) = run["lines"]
    assert line["injected"] == mode and line["verdict"] == "match"
    assert np.isfinite(line["cost"])
    assert not run["solver"].verify_member(0).corrupt


def test_events_touch_only_their_member():
    solver = OnlineSolver([_abilene(0.5), _abilene(1.0)], alpha=ALPHA, tol=TOL, accel=True,
                          device="cpu")
    before = solver.phi(0)
    rep = solver.process(events.RateScale(member=1, factor=1.5))
    assert rep.member == 1
    assert torch.equal(solver.phi(0).e, before.e) and torch.equal(solver.phi(0).c, before.c)
    # the stacked instance holds a copy of the member, not the member itself
    assert solver.binst.r[1].data_ptr() != solver.member(1).r.data_ptr()
    assert torch.equal(solver.binst.r[1], solver.member(1).r)


def test_telemetry_and_devices():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, Observability"):
        OnlineSolver([_abilene(0.5)], telemetry=True, device="cpu")
    with pytest.raises(ValueError, match="instance is on cpu"):
        OnlineSolver([_abilene(0.5)], device="meta")
    from repro_torch import serve

    assert serve.HealthReport.__module__ == "repro_torch.serve.online"
    with pytest.raises(NotImplementedError, match="Transformer substrate, the rest"):
        serve.ServeEngine  # noqa: B018
