"""PyTorch port vs JAX reference: the observability layer, on the CPU.

  * the ring helpers (``repro_torch.obs.device``) as the reference's
    ``tests/test_obs.py`` holds its own: shapes, truncation (not
    wrap-around), the write mask, the record dicts;
  * telemetry off and on give the same trajectory bit for bit, and the
    ring against the reference's ring (``tests/data/torch_ref_obs.npz``) on
    the Table II instances of ``tests/test_obs.py`` (Abilene at
    ``rate_scale=2.0``, 30 steps; the batched three-member family):
    ``_torch_cases.ring_parity`` (``iter``, ``alpha`` and ``anderson``
    exact; ``cost`` within 1e-5 relative; ``rung`` and ``bs_rounds`` exact
    up to a rung flip that is a tie; ``residual`` within 1e-5 relative to
    max(|ref|, 1) or the reference's own spread between its stage
    solvers);
  * the blocked sets' round count: the port's plain versions count every
    row's rounds as the reference's packed and neighbor-list loops count
    them, and a member's column is the max over its rows;
  * with telemetry off the loop never touches the ring (the same tensor
    object comes back) and no round count is asked for;
  * the online service over 6 events: served reports equal with telemetry
    off and on, each event's drained records equal its served iterations,
    the cold start recorded, metrics and spans filled in;
  * spans, metrics and the report generator, as ``tests/test_obs.py``
    holds them, on files under ``tmp_path``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import blocked_sets as jbset  # noqa: E402
from repro.kernels import sparse_solve as jss  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import batch, engine, events, gp, network  # noqa: E402
from repro_torch.kernels import blocked_sets as tbset  # noqa: E402
from repro_torch.kernels import sparse_solve as tss  # noqa: E402
from repro_torch.obs import device as obs_device  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.serve.online import OnlineSolver  # noqa: E402
from _torch_cases import random_bits, ring_parity  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_ref_obs.npz")
KW = dict(alpha=0.1, max_iters=30, patience=10**6, tol=0.0, device="cpu")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _inst(seed=0, scale=2.0):
    return network.table_ii_instance("abilene", seed=seed, rate_scale=scale, device="cpu")


# ---------------------------------------------------------------------------
# the ring helpers
# ---------------------------------------------------------------------------

def test_resolve_telemetry():
    assert engine.resolve_telemetry(None) is None
    assert engine.resolve_telemetry(False) is None
    assert engine.resolve_telemetry(True) == obs.DEFAULT_TELEMETRY
    assert engine.resolve_telemetry("default") == obs.DEFAULT_TELEMETRY
    cfg = obs.TelemetryConfig(ring=8, bs_rounds=False)
    assert engine.resolve_telemetry(cfg) is cfg
    with pytest.raises(TypeError):
        engine.resolve_telemetry(7)


def test_empty_ring_shapes():
    assert obs_device.empty_ring(None).shape == (0, obs.TEL_WIDTH)
    assert obs_device.empty_ring(obs.TelemetryConfig(ring=5)).shape == (5, obs.TEL_WIDTH)
    assert obs_device.empty_ring(obs.TelemetryConfig(ring=5), (3,)).shape == (
        3, 5, obs.TEL_WIDTH)


def test_ring_record_truncates_not_wraps():
    tb = obs_device.empty_ring(obs.TelemetryConfig(ring=3))
    for i in range(5):
        row = torch.full((obs.TEL_WIDTH,), float(i + 1))
        tb = obs_device.ring_record(tb, torch.tensor(i), row, torch.tensor(True))
    np.testing.assert_array_equal(tb[:, 0].numpy(), [1.0, 2.0, 3.0])   # 4, 5 dropped
    assert obs_device.ring_overflow(tb, 5) == 2
    assert obs_device.ring_valid(tb, 5).shape == (3, obs.TEL_WIDTH)
    assert obs_device.ring_valid(tb, 2).shape == (2, obs.TEL_WIDTH)


def test_ring_record_respects_write_mask():
    tb = obs_device.empty_ring(obs.TelemetryConfig(ring=3), (2,))
    row = torch.full((2, obs.TEL_WIDTH), 9.0)
    tb = obs_device.ring_record(tb, torch.tensor([0, 1]), row, torch.tensor([False, True]))
    assert float(tb[0].sum()) == 0.0
    assert float(tb[1, 1].sum()) == 9.0 * obs.TEL_WIDTH and float(tb[1].sum()) == 72.0


def test_records_to_dicts_columns():
    rows = np.arange(2 * obs.TEL_WIDTH, dtype=np.float32).reshape(2, -1)
    recs = obs.records_to_dicts(rows)
    assert [r["iter"] for r in recs] == [0, 8]
    assert set(recs[0]) == set(obs_device.COLUMNS)
    assert isinstance(recs[0]["rung"], int)
    assert isinstance(recs[0]["cost"], float)


# ---------------------------------------------------------------------------
# the solvers: telemetry off/on, the ring against the reference's
# ---------------------------------------------------------------------------

def test_single_device_parity_and_ring_against_reference(golden):
    inst = _inst()
    phi0 = gp.init_phi(inst)
    off = gp.solve(inst, phi0, **KW)
    on = gp.solve(inst, phi0, telemetry=True, record=True, **KW)
    assert off.telemetry is None
    assert on.iterations == off.iterations == KW["max_iters"]
    assert torch.equal(on.phi.e, off.phi.e) and torch.equal(on.phi.c, off.phi.c)
    assert torch.equal(on.cost_history, off.cost_history)

    rows = obs.ring_valid(on.telemetry, on.iterations)
    assert rows.shape == (KW["max_iters"], obs.TEL_WIDTH)
    np.testing.assert_array_equal(rows[:, obs_device.COL_ITER], np.arange(KW["max_iters"]))
    np.testing.assert_array_equal(rows[:, obs_device.COL_COST], on.cost_history[1:].numpy())
    assert obs.ring_overflow(on.telemetry, on.iterations) == 0
    assert (rows[:, obs_device.COL_BS_ROUNDS] >= 1).all()
    np.testing.assert_array_equal(rows[:, obs_device.COL_RUNG], on.records["rung"].numpy())

    ref = obs.ring_valid(golden["abilene/ring"], golden["abilene/iterations"])
    twin = obs.ring_valid(golden["abilene-sparse/ring"], golden["abilene-sparse/iterations"])
    rep = ring_parity(rows, ref, on.records["ladder_costs"].numpy(), twin)
    assert rep["ok"], rep

    loop = gp.solve_loop(inst, phi0, telemetry=True, **KW)
    assert torch.equal(loop.telemetry, on.telemetry)


def test_ring_overflow_truncates_on_real_solve():
    inst = _inst()
    phi0 = gp.init_phi(inst)
    res = gp.solve(inst, phi0, telemetry=obs.TelemetryConfig(ring=8), **KW)
    ref = gp.solve(inst, phi0, **KW)
    assert torch.equal(res.cost_history, ref.cost_history)
    rows = obs.ring_valid(res.telemetry, res.iterations)
    assert rows.shape == (8, obs.TEL_WIDTH)
    np.testing.assert_array_equal(rows[:, obs_device.COL_ITER], np.arange(8))
    assert obs.ring_overflow(res.telemetry, res.iterations) == KW["max_iters"] - 8
    scan = gp.solve_scan(inst, phi0, telemetry=obs.TelemetryConfig(ring=8), **KW)
    assert torch.equal(scan.telemetry, res.telemetry)


def test_batched_parity_and_rings_against_reference(golden):
    insts = [_inst(seed=s, scale=1.0 + 0.5 * s) for s in range(3)]
    binst = batch.pad_instances(insts)
    kw = dict(alpha=0.1, max_iters=25, tol=1e-4, device="cpu")
    off = gp.solve_batched(binst, **kw)
    on = gp.solve_batched(binst, telemetry=True, record=True, **kw)
    assert torch.equal(on.iterations, off.iterations)
    assert torch.equal(on.phi.e, off.phi.e)
    assert torch.equal(on.cost_history, off.cost_history)
    assert off.telemetry is None
    assert on.telemetry.shape == (3, obs.DEFAULT_TELEMETRY.ring, obs.TEL_WIDTH)
    for b in range(3):
        n = int(on.iterations[b])
        rows = obs.ring_valid(on.telemetry[b], n)
        np.testing.assert_array_equal(rows[:, obs_device.COL_ITER], np.arange(n))
        ref = obs.ring_valid(golden["batched/ring"][b], golden["batched/iterations"][b])
        twin = obs.ring_valid(golden["batched-sparse/ring"][b],
                              golden["batched-sparse/iterations"][b])
        rep = ring_parity(rows, ref, on.records["ladder_costs"][b].numpy(), twin)
        assert rep["ok"], (b, rep)
        one = gp.solve(batch.instance_slice(binst, b), telemetry=True, **kw)
        alone = obs.ring_valid(one.telemetry, one.iterations)
        assert alone.shape == rows.shape, b
        assert np.abs(alone[:, 1] - rows[:, 1]).max() <= 1e-4 * np.abs(rows[:, 1]).max(), b


def test_telemetry_off_leaves_the_ring_alone(monkeypatch):
    """With telemetry off the loop passes the placeholder ring through
    untouched and asks no kernel for a round count."""
    inst = _inst()
    carry = engine.init_carry(inst, gp.init_phi(inst))
    assert carry.tb.shape == (0, obs.TEL_WIDTH)
    asked = []
    real = engine.blocked_sets

    def spy(*a, **k):
        asked.append(k.get("with_rounds", False))
        return real(*a, **k)

    monkeypatch.setattr(engine, "blocked_sets", spy)
    out, *_ = engine.scan_chunk(inst, carry, torch.tensor(0.1), 0.0, 10**6, 10**6, length=3)
    assert out.tb is carry.tb and asked == [False] * 3
    on = engine.init_carry(inst, gp.init_phi(inst), telemetry=obs.TelemetryConfig(ring=4))
    engine.scan_chunk(inst, on, torch.tensor(0.1), 0.0, 10**6, 10**6, length=2,
                      telemetry=obs.TelemetryConfig(ring=4))
    assert asked[3:] == [True, True]


# ---------------------------------------------------------------------------
# the round count's convention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [9, 40, 70])
def test_round_counts_match_the_reference_loops(V):
    """Row by row, the port's plain packed and neighbor-list sweeps count
    the rounds the reference's loops count (the seed round 1, the round
    that changes nothing counted); over a batch the reference's one
    counter is the max of the port's."""
    rng = np.random.default_rng(V)
    B = 6
    route, improper = random_bits(rng, B, V, 0.15)
    improper[0] = False                                   # a row with no seed
    _, rounds = tbset.tagged_flags_plain(torch.from_numpy(route), torch.from_numpy(improper),
                                         with_rounds=True)
    Vp, _ = jbset.padded_nodes(V)

    def packed(x):
        return jnp.pad(jbset.pack_bits(jnp.asarray(x)), ((0, 0), (0, Vp - V), (0, 0)))

    for b in range(B):
        _, r = jbset.tagged_packed(packed(route[b:b + 1]), packed(improper[b:b + 1]), V,
                                   with_rounds=True)
        assert int(rounds[b]) == int(r), b
    _, r_all = jbset.tagged_packed(packed(route), packed(improper), V, with_rounds=True)
    assert int(rounds.max()) == int(r_all)

    nbr, mask, _, _ = network.sparse_neighbors(route.any(axis=0))   # every routed link listed
    nbr_t = torch.from_numpy(nbr.astype(np.int64))
    rv = tss.gathered(torch.from_numpy(route), nbr_t) & torch.from_numpy(mask)
    iv = tss.gathered(torch.from_numpy(improper), nbr_t)
    _, nrounds = tss.tagged_nbr_plain(rv, iv, nbr_t, with_rounds=True)
    for b in range(B):
        _, r = jss.tagged_nbr(jnp.asarray(rv[b:b + 1].numpy()), jnp.asarray(iv[b:b + 1].numpy()),
                              jnp.asarray(nbr), with_rounds=True)
        assert int(nrounds[b]) == int(r), b
    assert torch.equal(nrounds, rounds)
    assert int(rounds[0]) == 1 and int(rounds.max()) >= (3 if V >= 40 else 2)


# ---------------------------------------------------------------------------
# the online service
# ---------------------------------------------------------------------------

def test_online_parity_and_segment_drain():
    insts = [_inst(seed=s, scale=1.0 + 0.5 * s) for s in range(2)]
    members = events.pad_fleet(insts, spare_apps=1)
    trace = events.random_trace(members, n_events=6, seed=0)
    kw = dict(spare_apps=1, alpha=0.1, tol=1e-4, accel=True, device="cpu")
    off = OnlineSolver(insts, **kw)
    reps_off = off.step(trace)
    m, tr = obs.Metrics(), obs.Tracer()
    on = OnlineSolver(insts, telemetry=True, metrics=m, tracer=tr, **kw)
    reps_on = on.step(trace)

    assert off.event_iters == on.event_iters and off.iter_trace == []
    for a, b in zip(reps_off, reps_on):
        assert (a.iterations, a.status, a.rungs) == (b.iterations, b.status, b.rungs)
        assert a.cost == b.cost
        assert torch.equal(off.phi(a.member).e, on.phi(b.member).e)
    per_event: dict[int, int] = {}
    for rec in on.iter_trace:
        per_event[rec["event"]] = per_event.get(rec["event"], 0) + 1
    for t, rep in enumerate(reps_on):
        assert per_event.get(t, 0) == rep.iterations, t
    assert per_event.get(-1, 0) == int(on.cold_iters.sum()) > 0
    assert all(r.wall_s > 0 for r in reps_on)
    snap = m.snapshot()
    assert snap["histograms"]["online.event.iters"]["sum"] == on.event_iters
    assert sum(v for k, v in snap["counters"].items()
               if k.startswith("online.event.")) == len(trace)
    assert any(e["name"].startswith("event:") for e in tr.events)
    assert tr.to_chrome()["traceEvents"]


# ---------------------------------------------------------------------------
# spans, metrics, report
# ---------------------------------------------------------------------------

def _fake_clock(times):
    it = iter(times)
    last = [0.0]

    def clock():
        try:
            last[0] = next(it)
        except StopIteration:
            pass
        return last[0]
    return clock


def test_span_nesting_and_chrome_roundtrip(tmp_path):
    tr = obs.Tracer(clock=_fake_clock([0.0, 1.0, 2.0, 3.0, 4.0]))
    with tr.span("event", tid=1, member=1):
        with tr.span("converge", tid=1):
            pass
    tr.instant("rollback", tid=1)
    tr.counter("online.iters", 42.0)
    depths = {e["name"]: e["depth"] for e in tr.events if e["ph"] == "X"}
    assert depths == {"event": 0, "converge": 1}
    path = str(tmp_path / "trace.json")
    tr.export_chrome(path, tid_names={1: "member-1"})
    evs = obs.load_chrome(path)
    assert sorted(e["ph"] for e in evs) == ["C", "M", "M", "X", "X", "i"]
    x = [e for e in evs if e["ph"] == "X"]
    ev = next(e for e in x if e["name"] == "event")
    cv = next(e for e in x if e["name"] == "converge")
    assert ev["ts"] <= cv["ts"]
    assert cv["ts"] + cv["dur"] <= ev["ts"] + ev["dur"] + 1e-6
    assert all("depth" not in e for e in evs)
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def test_metrics_registry(tmp_path):
    m = obs.Metrics()
    m.counter("a.b")
    m.counter("a.b", 2)
    m.gauge("g", 7.5)
    for v in range(10):
        m.observe("h", float(v))
    snap = m.snapshot()
    assert snap["counters"]["a.b"] == 3
    assert snap["gauges"]["g"] == 7.5
    h = snap["histograms"]["h"]
    assert h["count"] == 10 and h["min"] == 0.0 and h["max"] == 9.0 and h["p50"] == 4.0
    path = str(tmp_path / "m.jsonl")
    m.export_jsonl(path)
    with open(path) as f:
        assert [json.loads(line)["kind"] for line in f] == ["counter", "gauge", "histogram"]


def test_collect_compile_caches():
    m = obs.Metrics()
    out = obs.collect_compile_caches(m)
    assert set(out) == {"compile.kernels.entries", "compile.kernels.builds",
                        "compile.kernels.build_s"}
    assert m.snapshot()["gauges"] == out


def _write_trace(tmp_path, events_rows, iters_rows, metrics=None):
    prefix = str(tmp_path / "t")
    with open(prefix + ".events.jsonl", "w") as f:
        for r in events_rows:
            f.write(json.dumps(r) + "\n")
    with open(prefix + ".iters.jsonl", "w") as f:
        for r in iters_rows:
            f.write(json.dumps(r) + "\n")
    if metrics is not None:
        with open(prefix + ".metrics.json", "w") as f:
            json.dump(metrics, f)
    return prefix


def _ev(t, member, iters, **kw):
    row = {"t": t, "event": "RateScale", "member": member, "iterations": iters,
           "cost": 1.0, "residual": 0.0, "status": "converged", "rungs": [],
           "rung_iters": [], "wall_s": 0.1, "solved_apps": 1, "skipped_apps": 0,
           "cold_restart": False, "rolled_back": False, "shed": []}
    row.update(kw)
    return row


def _it(member, event, segment, n):
    return [{"iter": i, "cost": 1.0, "residual": 0.1, "alpha": 0.1, "rung": 0,
             "anderson": -1.0, "bs_rounds": 1, "phi_delta": 0.0, "member": member,
             "event": event, "phase": "warm", "segment": segment} for i in range(n)]


def test_report_build_and_check(tmp_path):
    events_rows = [_ev(0, 0, 3), _ev(1, 1, 2, rungs=["half-alpha"], rung_iters=[2])]
    iters_rows = _it(0, -1, 0, 4) + _it(0, 0, 1, 3) + _it(1, 1, 2, 2)
    metrics = {"counters": {"online.gate.skip": 1.0}, "gauges": {}, "histograms": {}}
    prefix = _write_trace(tmp_path, events_rows, iters_rows, metrics)
    report = obs_report.build_report(obs_report.load_trace(prefix))
    s = report["summary"]
    assert s["n_events"] == 2 and s["event_iters"] == 5
    assert s["cold_start_iters_recorded"] == 4
    assert s["rung_iters"] == {"half-alpha": 2}
    assert s["gate_skips"] == 1.0
    m0 = next(m for m in report["members"] if m["member"] == 0)
    assert m0["total_iters"] == 3
    assert [seg["recorded"] for seg in m0["segments"]] == [4, 3]
    rows = [{"bench": "online", "scenario": "fig6-trace2", "V": 11, "solver": "online",
             "iters": 5}]
    assert obs_report.check_bench(report, rows, "fig6-trace2") == []
    rows[0]["iters"] = 6
    assert len(obs_report.check_bench(report, rows, "fig6-trace2")) == 1
    assert obs_report.check_bench(report, rows, "no-such") != []
    with pytest.raises(FileNotFoundError):
        obs_report.load_trace(str(tmp_path / "missing"))


def test_report_main_end_to_end(tmp_path):
    prefix = _write_trace(tmp_path, [_ev(0, 0, 4)], _it(0, 0, 0, 4))
    out = str(tmp_path / "report.json")
    bench = str(tmp_path / "bench.json")
    with open(bench, "w") as f:
        json.dump({"rows": [{"bench": "online", "scenario": "fig6-trace1", "V": 11,
                             "solver": "online", "iters": 4}]}, f)
    argv = ["--trace", prefix, "--out", out, "--check-bench", bench,
            "--scenario", "fig6-trace1"]
    assert obs_report.main(argv) == 0
    with open(out) as f:
        assert json.load(f)["summary"]["event_iters"] == 4
    with open(bench, "w") as f:
        json.dump({"rows": [{"bench": "online", "scenario": "fig6-trace1", "V": 11,
                             "solver": "online", "iters": 5}]}, f)
    assert obs_report.main(argv) == 1
