"""Serving layer: the online GP service (and, later, the transformer serve
engine).

Port of ``repro.serve``'s lazy exports: importing the package loads
neither module.  ``OnlineSolver``, ``EventReport``, ``HealthReport`` and
``FleetHealth`` come from :mod:`repro_torch.serve.online`.  The transformer
serve engine (``ServeEngine``, ``make_serve_step``, ``make_prefill_step``,
``Request``) is not ported yet: asking for one raises.
"""

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - static analysis only
    from repro_torch.serve.online import (EventReport, FleetHealth,  # noqa: F401
                                          HealthReport, OnlineSolver)

_ENGINE = ("ServeEngine", "make_serve_step", "make_prefill_step", "Request")
_ONLINE = ("OnlineSolver", "EventReport", "HealthReport", "FleetHealth")

__all__ = list(_ONLINE)


def __getattr__(name):
    if name in _ENGINE:
        raise NotImplementedError(
            f"serve.{name} (the transformer serve engine) is not ported yet: "
            "ROADMAP Queue 1, Transformer substrate, the rest")
    if name in _ONLINE:
        from repro_torch.serve import online
        return getattr(online, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
