"""Fleet metrics registry: counters, gauges, histograms.

Port of ``repro.obs.metrics``: a small registry the online service (and
any driver) increments on the host, for solver-level facts that do not
live inside the device loop: skip-gate hits, escalation-rung climbs,
last-known-good rollbacks, quarantines, fault injections, the kernel
loader's builds.

Names are dot-separated (``online.gate.skip``, ``faults.injected.nan_carry``)
so exports group naturally.  Exports are plain JSON / JSONL.
"""

from __future__ import annotations

import json
import math
from typing import Optional


class Metrics:
    """In-process metrics registry.

    ``counter`` accumulates, ``gauge`` overwrites, ``observe`` appends to a
    histogram (summarized at export: count/sum/min/max/mean/p50/p90/p99).
    """

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list[float]] = {}

    def counter(self, name: str, inc: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self.histograms.setdefault(name, []).append(float(value))

    @staticmethod
    def _summary(vals: list[float]) -> dict:
        s = sorted(vals)
        n = len(s)

        def pct(p: float) -> float:
            return s[min(n - 1, int(math.ceil(p * n)) - 1)] if n else 0.0

        return {"count": n, "sum": sum(s),
                "min": s[0] if n else 0.0, "max": s[-1] if n else 0.0,
                "mean": (sum(s) / n) if n else 0.0,
                "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99)}

    def snapshot(self) -> dict:
        """One JSON-serializable view of everything recorded so far."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: self._summary(v)
                           for k, v in self.histograms.items()},
        }

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)

    def export_jsonl(self, path: str) -> None:
        """One line per metric — the stream-friendly export."""
        with open(path, "w") as f:
            for name, v in sorted(self.counters.items()):
                f.write(json.dumps(
                    {"kind": "counter", "name": name, "value": v}) + "\n")
            for name, v in sorted(self.gauges.items()):
                f.write(json.dumps(
                    {"kind": "gauge", "name": name, "value": v}) + "\n")
            for name, vals in sorted(self.histograms.items()):
                f.write(json.dumps(
                    {"kind": "histogram", "name": name,
                     **self._summary(vals)}) + "\n")


def collect_compile_caches(metrics: Optional[Metrics]) -> dict:
    """Gauge the port's one cache whose miss lies on an event's critical
    path into ``metrics`` (and return it): the kernel loader of
    ``kernels/_build.py``, whose first use of a kernel builds it with
    ``nvcc`` (seconds) unless the library is on disk already.

      * ``compile.kernels.entries`` — kernel libraries loaded in this
        process;
      * ``compile.kernels.builds`` — libraries built at first use (a miss
        of the on-disk cache) in this process;
      * ``compile.kernels.build_s`` — the seconds those builds took.
    """
    from repro_torch.kernels import _build

    out = {"compile.kernels.entries": float(len(_build._LIBS)),
           "compile.kernels.builds": float(_build.BUILDS["count"]),
           "compile.kernels.build_s": float(_build.BUILDS["seconds"])}
    if metrics is not None:
        for k, v in out.items():
            metrics.gauge(k, v)
    return out
