"""Trace -> report: per-member convergence timelines and a fleet summary.

Port of ``repro.obs.report``::

    PYTHONPATH=src python -m repro_torch.obs.report --trace PREFIX \
        [--out results/obs_report.json] \
        [--check-bench BENCH_gp.json --scenario fig6-trace50]

``PREFIX`` names an artifact family: ``PREFIX.events.jsonl`` (one served
event a line, required), ``PREFIX.iters.jsonl`` (the service's drained
telemetry records, ``OnlineSolver.iter_trace``), ``PREFIX.metrics.json``
(``Metrics.snapshot``) and ``PREFIX.trace.json`` (``Tracer.to_chrome``),
the last three optional.  The report holds:

  * **per-member timelines**: the events each fleet member handled
    (iterations, cost, residual, status, rungs, wall clock) and its
    per-iteration residual and cost by solve segment, from the ring;
  * **fleet summary**: event and iteration totals, status and event-type
    tallies, skip-gate and rollback counts, escalation-rung spend, wall
    clock by span, telemetry-ring drops.

``--check-bench`` holds the report against bench rows (a JSON object with
a ``rows`` list): the iterations summed over the recorded events must
equal the ``iters`` of the matching online row; a mismatch means dropped
or twice-drained segments.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional


def _read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def load_trace(prefix: str) -> dict:
    """Load the artifact family rooted at ``prefix``.

    Returns ``{"events": [...], "iters": [...], "metrics": {...},
    "spans": [...]}`` — ``events`` is required (raises
    ``FileNotFoundError`` when absent), the rest default to empty.
    """
    ev_path = prefix + ".events.jsonl"
    if not os.path.exists(ev_path):
        raise FileNotFoundError(f"{ev_path} not found: write the served events there")
    out = {"events": _read_jsonl(ev_path), "iters": [], "metrics": {},
           "spans": []}
    it_path = prefix + ".iters.jsonl"
    if os.path.exists(it_path):
        out["iters"] = _read_jsonl(it_path)
    m_path = prefix + ".metrics.json"
    if os.path.exists(m_path):
        with open(m_path) as f:
            out["metrics"] = json.load(f)
    t_path = prefix + ".trace.json"
    if os.path.exists(t_path):
        with open(t_path) as f:
            obj = json.load(f)
        out["spans"] = (obj["traceEvents"]
                        if isinstance(obj, dict) else obj)
    return out


def _member_segments(iters: list[dict], member: int) -> list[dict]:
    """The member's solve segments, each with its iteration trajectory."""
    segs: dict[int, dict] = {}
    for rec in iters:
        if rec.get("member") != member:
            continue
        seg = segs.setdefault(rec["segment"], {
            "segment": rec["segment"], "event": rec.get("event"),
            "phase": rec.get("phase"), "recorded": 0,
            "residual": [], "cost": []})
        seg["recorded"] += 1
        seg["residual"].append(rec.get("residual"))
        seg["cost"].append(rec.get("cost"))
    return [segs[k] for k in sorted(segs)]


def build_report(trace: dict) -> dict:
    """Distill loaded trace streams into the report dict (see module doc)."""
    events, iters = trace["events"], trace["iters"]
    members = sorted({e["member"] for e in events}
                     | {r["member"] for r in iters})

    timelines = []
    for b in members:
        evs = [e for e in events if e["member"] == b]
        timelines.append({
            "member": b,
            "events": [{k: e.get(k) for k in (
                "t", "event", "iterations", "cost", "residual", "status",
                "rungs", "rung_iters", "wall_s", "solved_apps",
                "skipped_apps", "cold_restart", "rolled_back", "shed")}
                for e in evs],
            "total_iters": sum(e["iterations"] for e in evs),
            "segments": _member_segments(iters, b),
        })

    statuses: dict[str, int] = {}
    event_types: dict[str, int] = {}
    rung_iters: dict[str, int] = {}
    for e in events:
        statuses[e.get("status", "?")] = statuses.get(e.get("status", "?"),
                                                      0) + 1
        event_types[e["event"]] = event_types.get(e["event"], 0) + 1
        for rung, spend in zip(e.get("rungs", ()),
                               e.get("rung_iters", ())):
            rung_iters[rung] = rung_iters.get(rung, 0) + int(spend)

    # wall-clock attribution: top-level event spans vs inner solve phases
    span_s: dict[str, float] = {}
    for s in trace["spans"]:
        if s.get("ph") == "X":
            key = s["name"].split(":")[0]
            span_s[key] = span_s.get(key, 0.0) + s.get("dur", 0.0) / 1e6

    counters = trace["metrics"].get("counters", {})
    cold_iters = sum(r.get("iter") is not None for r in iters
                     if r.get("event") == -1)
    summary = {
        "n_members": len(members),
        "n_events": len(events),
        "event_iters": sum(e["iterations"] for e in events),
        "cold_start_iters_recorded": cold_iters,
        "iters_recorded": len(iters),
        "ring_dropped": counters.get("telemetry.ring.dropped", 0),
        "statuses": statuses,
        "event_types": event_types,
        "rung_iters": rung_iters,
        "gate_skips": counters.get("online.gate.skip", 0),
        "rollbacks": counters.get("online.rollback", 0),
        "quarantines": counters.get("online.quarantine", 0),
        "wall_s_by_span": {k: round(v, 4)
                           for k, v in sorted(span_s.items())},
        "wall_s_total": round(sum(e.get("wall_s", 0.0) for e in events), 4),
    }
    return {"summary": summary, "members": timelines}


def check_bench(report: dict, bench_rows: list[dict], scenario: str
                ) -> list[str]:
    """Cross-check the report against committed online bench rows.

    The recorded trace must reproduce the committed event-level iteration
    count exactly: ``sum(iterations over events.jsonl)`` == the ``iters``
    field of the (online, ``scenario``, online/online-chaos) row.  Returns
    human-readable failure lines (empty = check passes).
    """
    rows = [r for r in bench_rows
            if r.get("bench") == "online" and r.get("scenario") == scenario
            and r.get("solver") in ("online", "online-chaos")]
    if not rows:
        return [f"no committed online row for scenario {scenario!r}"]
    failures = []
    got = report["summary"]["event_iters"]
    for row in rows:
        want = int(row.get("iters", -1))
        if got != want:
            failures.append(
                f"{scenario}/{row['solver']}: trace records {got} event "
                f"iterations but the committed row says {want}")
    return failures


def _print_summary(report: dict) -> None:
    s = report["summary"]
    print(f"fleet: {s['n_members']} members, {s['n_events']} events, "
          f"{s['event_iters']} event iters "
          f"(+{s['cold_start_iters_recorded']} cold-start recorded)")
    print(f"statuses:    {s['statuses']}")
    print(f"event types: {s['event_types']}")
    if s["rung_iters"]:
        print(f"rung spend:  {s['rung_iters']}")
    print(f"gate skips: {s['gate_skips']}  rollbacks: {s['rollbacks']}  "
          f"quarantines: {s['quarantines']}  "
          f"ring drops: {s['ring_dropped']}")
    if s["wall_s_by_span"]:
        print(f"wall clock by span: {s['wall_s_by_span']}")
    for m in report["members"]:
        segs = len(m["segments"])
        print(f"  member {m['member']}: {len(m['events'])} events, "
              f"{m['total_iters']} iters, {segs} telemetry segments")


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs.report")
    ap.add_argument("--trace", required=True, metavar="PREFIX",
                    help="artifact prefix (PREFIX.events.jsonl, ...)")
    ap.add_argument("--out", default=None,
                    help="report JSON path (default: results/"
                         "obs_report_<basename>.json)")
    ap.add_argument("--check-bench", default=None, metavar="BENCH_JSON",
                    help="bench rows (JSON with a 'rows' list) to cross-check against")
    ap.add_argument("--scenario", default="fig6-trace50",
                    help="online bench scenario for --check-bench")
    args = ap.parse_args(argv)

    trace = load_trace(args.trace)
    report = build_report(trace)
    _print_summary(report)

    out = args.out
    if out is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        base = os.path.basename(args.trace.rstrip("/")) or "trace"
        out = os.path.join(root, "results", f"obs_report_{base}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report: {out}")

    if args.check_bench:
        with open(args.check_bench) as f:
            rows = json.load(f)["rows"]
        failures = check_bench(report, rows, args.scenario)
        if failures:
            for line in failures:
                print(f"CHECK FAILED {line}")
            return 1
        print(f"check-bench: OK — trace reproduces the committed "
              f"{args.scenario} iteration count")
    return 0


if __name__ == "__main__":
    sys.exit(main())
