"""Congestion-dependent link/computation cost families (Section II).

Port of ``repro.core.costs``:

  * LINEAR:  D(F) = d * F          (pure transmission delay)
  * QUEUE:   D(F) = F / (d - F)    (M/M/1 expected queue occupancy)

The M/M/1 family is extended above ``theta * d`` with its second-order
Taylor model (C^1, convex, increasing), so every feasible strategy has a
finite cost and finite gradients.  The guards (``cap >= 1e-6``,
``cap - F >= 1e-12``) are the reference's, so non-links with ``cap = 0``
stay finite.
"""

from __future__ import annotations

import torch

LINEAR = 0
QUEUE = 1

# Fraction of capacity above which the M/M/1 cost switches to its quadratic
# Taylor extension.
_THETA = 0.98

# Taylor data at the knee F = theta*cap, with the cap powers cancelled
# analytically so no float32 intermediate under/overflows (cap ~0 on
# non-links):  value theta/(1-theta), slope 1/(cap (1-theta)^2),
# curvature 2/(cap^2 (1-theta)^3).
_V_KNEE = _THETA / (1.0 - _THETA)
_S1 = 1.0 / (1.0 - _THETA) ** 2
_S2 = 2.0 / (1.0 - _THETA) ** 3


def _queue_cost(F: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """M/M/1 queue length F/(cap-F), quadratically extended above theta*cap."""
    cap = torch.clamp_min(cap, 1e-6)
    knee = _THETA * cap
    inside = F / torch.clamp_min(cap - F, 1e-12)
    u = (F - knee) / cap                      # normalized overload
    outside = _V_KNEE + _S1 * u + 0.5 * _S2 * u * u
    return torch.where(F <= knee, inside, outside)


def _queue_marginal(F: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    cap = torch.clamp_min(cap, 1e-6)
    knee = _THETA * cap
    inside = cap / torch.clamp_min(cap - F, 1e-12) ** 2
    u = (F - knee) / cap
    outside = (_S1 + _S2 * u) / cap
    return torch.where(F <= knee, inside, outside)


def cost(kind: int, F: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """Elementwise cost D(F) (or C(G)) for the given family."""
    if kind == LINEAR:
        return param * F
    if kind == QUEUE:
        return _queue_cost(F, param)
    raise ValueError(f"unknown cost kind {kind}")


def marginal(kind: int, F: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """Elementwise marginal cost D'(F) for the given family."""
    if kind == LINEAR:
        return param * torch.ones_like(F)
    if kind == QUEUE:
        return _queue_marginal(F, param)
    raise ValueError(f"unknown cost kind {kind}")


def saturated(kind: int, F: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """Bool mask of links/CPUs operating beyond the modelled region."""
    if kind == LINEAR:
        return torch.zeros_like(F, dtype=torch.bool)
    return F > _THETA * param
