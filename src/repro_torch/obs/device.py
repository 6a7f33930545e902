"""On-device iteration telemetry: the ring riding the GP loop's carry.

Port of ``repro.obs.device``.  The solve loop (``engine.scan_chunk``) never
reads anything back to the host inside a chunk, which also means nothing
inside it is observable.  The ring is the one mechanism that sees inside
without a host read: a ``(..., R, TEL_WIDTH)`` float32 tensor in the carry
(``engine.SolveCarry.tb``), written by a masked write on the device once per
committed iteration and read on the host only at the chunk boundaries where
the drivers already read the ``done`` latch.

  * **Telemetry off costs nothing.**  The ring is a zero-size ``(..., 0,
    TEL_WIDTH)`` placeholder and the loop never touches it: the step issues
    the same kernels and operations as without the ring.
  * **Telemetry on leaves the trajectory alone.**  Every column is a value
    the step computed anyway (cost, residual, winning rung, Anderson
    verdict, phi movement); the blocked-set kernels write the round count
    their fixed point keeps anyway.
  * **Write index = ``carry.iters``.**  The committed-iteration counter
    grows exactly when a record is written (both are masked by the
    ``done`` freeze) and ``engine.reset_carry`` zeroes it with the ring, so
    rows ``[0, min(iters, R))`` are the valid prefix.  Iterations past ``R``
    keep counting but write nothing: truncation, not wrap-around, so
    ``iters - R`` is the exact number of records dropped
    (:func:`ring_overflow`).

Nothing here imports the rest of the package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Record layout: one (TEL_WIDTH,) float32 row per committed iteration.
TEL_WIDTH = 8
COL_ITER = 0        # 0-based committed-iteration index
COL_COST = 1        # committed cost after this iteration
COL_RESIDUAL = 2    # committed sufficiency residual
COL_ALPHA = 3       # stepsize the winning ladder rung used
COL_RUNG = 4        # winning rung index in the evaluated ladder
COL_ANDERSON = 5    # 1 = mix accepted, 0 = rejected, -1 = mixer off
COL_BS_ROUNDS = 6   # blocked-set fixed-point rounds (-1: not measured)
COL_PHI_DELTA = 7   # max|dphi| of the committed move

COLUMNS = ("iter", "cost", "residual", "alpha", "rung", "anderson",
           "bs_rounds", "phi_delta")


class TelemetryConfig(NamedTuple):
    """Telemetry toggles, like ``engine.AccelConfig``.

      ring       ring capacity in records; iterations past it are counted
                 but not recorded (truncation, :func:`ring_overflow`)
      bs_rounds  also record the blocked-set fixed point's round count (the
                 kernels write the count they keep; nothing else changes)
    """

    ring: int = 256
    bs_rounds: bool = True


DEFAULT_TELEMETRY = TelemetryConfig()


def resolve_telemetry(telemetry) -> Optional[TelemetryConfig]:
    """None/False -> None (no ring); True/"default"/"on" ->
    :data:`DEFAULT_TELEMETRY`; a :class:`TelemetryConfig` passes through."""
    if telemetry is None or telemetry is False:
        return None
    if telemetry is True or telemetry in ("default", "on"):
        return DEFAULT_TELEMETRY
    if isinstance(telemetry, TelemetryConfig):
        return telemetry
    raise TypeError(
        f"telemetry must be None/bool/'default'/TelemetryConfig, got {telemetry!r}")


def empty_ring(telemetry: Optional[TelemetryConfig], batch_shape: tuple = (),
               device="cpu") -> torch.Tensor:
    """A fresh ring: ``(*batch_shape, ring, TEL_WIDTH)`` zeros, with a ring
    of 0 rows when telemetry is off."""
    R = telemetry.ring if telemetry is not None else 0
    return torch.zeros(tuple(batch_shape) + (R, TEL_WIDTH), dtype=torch.float32,
                       device=device)


def ring_record(tb: torch.Tensor, slot: torch.Tensor, row: torch.Tensor,
                write: torch.Tensor) -> torch.Tensor:
    """Masked write on the device: ``row`` (..., TEL_WIDTH) goes to row
    ``slot`` (...) of ``tb`` (..., R, TEL_WIDTH) where ``write`` (...) and
    the slot lies within the ring; elsewhere the ring is unchanged.  Nothing
    is read back to the host.  Only for a ring of at least one row (the off
    path never calls it)."""
    R = tb.shape[-2]
    at = (torch.arange(R, device=tb.device) == slot[..., None]) & write[..., None]
    return torch.where(at[..., None], row[..., None, :].to(tb.dtype), tb)


def ring_valid(tb, iters) -> np.ndarray:
    """Host-side drain of one ring: the valid prefix ``[0, min(iters, R))``
    as a ``(n, TEL_WIDTH)`` numpy array (a copy)."""
    tb = tb.cpu().numpy() if isinstance(tb, torch.Tensor) else np.asarray(tb)
    n = min(int(iters), tb.shape[0])
    return tb[:n].copy()


def ring_overflow(tb, iters) -> int:
    """How many committed iterations were not recorded (the truncated tail)."""
    return max(0, int(iters) - int(tb.shape[0]))


def records_to_dicts(records: np.ndarray) -> list[dict]:
    """(n, TEL_WIDTH) -> one JSON-friendly dict per record."""
    out = []
    for row in np.asarray(records):
        d = {name: float(v) for name, v in zip(COLUMNS, row)}
        d["iter"] = int(d["iter"])
        d["rung"] = int(d["rung"])
        d["bs_rounds"] = int(d["bs_rounds"])
        out.append(d)
    return out
