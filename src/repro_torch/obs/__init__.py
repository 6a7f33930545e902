"""Solver observability layer (port of ``repro.obs``).

  * :mod:`repro_torch.obs.device` — the on-device iteration ring in the GP
    loop's carry (``TelemetryConfig``; no host read inside the loop, no
    extra operation when off);
  * :mod:`repro_torch.obs.metrics` / :mod:`repro_torch.obs.spans` — host
    fleet metrics and nested spans with a Chrome-trace exporter;
  * :mod:`repro_torch.obs.report` — ``python -m repro_torch.obs.report``
    turns a recorded service run into per-member timelines and a fleet
    summary.
"""

from repro_torch.obs.device import (            # noqa: F401
    COLUMNS, DEFAULT_TELEMETRY, TEL_WIDTH, TelemetryConfig, empty_ring,
    records_to_dicts, resolve_telemetry, ring_overflow, ring_valid,
)
from repro_torch.obs.metrics import Metrics, collect_compile_caches  # noqa: F401
from repro_torch.obs.spans import Tracer, load_chrome                # noqa: F401
