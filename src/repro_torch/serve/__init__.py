"""Serving layer: the transformer serve engine and the online GP service.

Port of ``repro.serve``'s lazy exports: importing the package loads
neither module.  ``ServeEngine``, ``make_serve_step``,
``make_prefill_step`` and ``Request`` come from
:mod:`repro_torch.serve.engine` (which pulls in the model stack);
``OnlineSolver``, ``EventReport``, ``HealthReport`` and ``FleetHealth``
from :mod:`repro_torch.serve.online`.
"""

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - static analysis only
    from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: F401
                                          make_prefill_step, make_serve_step)
    from repro_torch.serve.online import (EventReport, FleetHealth,  # noqa: F401
                                          HealthReport, OnlineSolver)

_ENGINE = ("ServeEngine", "make_serve_step", "make_prefill_step", "Request")
_ONLINE = ("OnlineSolver", "EventReport", "HealthReport", "FleetHealth")

__all__ = list(_ENGINE + _ONLINE)


def __getattr__(name):
    if name in _ENGINE:
        from repro_torch.serve import engine
        return getattr(engine, name)
    if name in _ONLINE:
        from repro_torch.serve import online
        return getattr(online, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
