"""Structured spans with a Chrome-trace/perfetto exporter.

Port of ``repro.obs.spans``.  The online service's event handling is a
small tree of phases (event -> converge -> ladder rungs -> rollback); this
module records nested spans on the host and exports them in the Chrome
trace-event format (the JSON that https://ui.perfetto.dev and
chrome://tracing load):

  * ``ph: "X"`` complete events, one per finished span, microsecond
    ``ts``/``dur``, ``tid`` = fleet member, ``pid`` = 1;
  * ``ph: "i"`` instant events (rollbacks, injections);
  * ``ph: "C"`` counter events (numeric series);
  * ``ph: "M"`` metadata (process and thread names).

Spans nest per (pid, tid) by stack discipline: a child closes before its
parent (the context manager sees to it), and the viewer rebuilds the
nesting from containment.  The JSONL export writes the same records one a
line (:mod:`repro_torch.obs.report` reads them).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional


class Tracer:
    """Host-side span recorder.

    ``clock`` is injectable for tests (must be monotonic, in seconds).
    All public methods are cheap enough for per-event (not per-iteration)
    call sites; per-iteration data belongs to the device ring
    (:mod:`repro_torch.obs.device`).
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._stack: dict[int, list[dict]] = {}   # tid -> open spans
        self.events: list[dict] = []              # finished, in close order

    def _us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, *, tid: int = 0, **args):
        """Context manager recording one complete ("X") span."""
        rec = {"name": name, "ph": "X", "pid": 1, "tid": int(tid),
               "ts": self._us(), "args": {k: _jsonable(v)
                                          for k, v in args.items()}}
        stack = self._stack.setdefault(int(tid), [])
        rec["depth"] = len(stack)
        stack.append(rec)
        try:
            yield rec
        finally:
            rec["dur"] = self._us() - rec["ts"]
            stack.pop()
            self.events.append(rec)

    def instant(self, name: str, *, tid: int = 0, **args) -> None:
        """Point marker ("i" event) — rollbacks, injections, drains."""
        self.events.append(
            {"name": name, "ph": "i", "pid": 1, "tid": int(tid), "s": "t",
             "ts": self._us(), "args": {k: _jsonable(v)
                                        for k, v in args.items()}})

    def counter(self, name: str, value: float, *, tid: int = 0) -> None:
        """Numeric series sample ("C" event) — renders as a track graph."""
        self.events.append(
            {"name": name, "ph": "C", "pid": 1, "tid": int(tid),
             "ts": self._us(), "args": {name.rsplit(".", 1)[-1]:
                                        float(value)}})

    # -- exports ---------------------------------------------------------

    def to_chrome(self, *, process_name: str = "repro_torch.online",
                  tid_names: Optional[dict] = None) -> dict:
        """The Chrome trace-event JSON object (``{"traceEvents": [...]}``).

        Emits metadata names first, then every recorded event sorted by
        ``ts`` (viewers do not require the sort, but diff-friendly output
        does).  Open spans are not exported — close them first.
        """
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": process_name}}]
        for tid, label in sorted((tid_names or {}).items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": int(tid), "args": {"name": str(label)}})
        events = []
        for e in sorted(self.events, key=lambda e: e["ts"]):
            out = {k: v for k, v in e.items() if k != "depth"}
            events.append(out)
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str, **kw) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(**kw), f, indent=1)

    def export_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in sorted(self.events, key=lambda e: e["ts"]):
                f.write(json.dumps(e) + "\n")


def load_chrome(path: str) -> list[dict]:
    """Load a Chrome-trace JSON file back into its event list."""
    with open(path) as f:
        obj = json.load(f)
    return obj["traceEvents"] if isinstance(obj, dict) else obj


def _jsonable(v):
    """Span args must survive json.dumps — stringify anything exotic."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
