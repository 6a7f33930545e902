"""Optimality-condition checkers: KKT (5) and the sufficiency condition (6).

Port of ``repro.core.conditions``.  Both return a *residual*: the largest
amount by which a direction carrying flow exceeds the per-(i,a,k) minimum
marginal.  A strategy satisfies the condition iff its residual is ~0;
sufficiency (6) at ~0 certifies a global optimum (Theorem 1).
"""

from __future__ import annotations

import torch

from repro_torch.core.marginals import BIG, marginals
from repro_torch.core.network import Instance
from repro_torch.core.traffic import Phi, flows


def _residual(min_margin, margin_e, margin_c, phi: Phi,
              active_eps: float) -> torch.Tensor:
    """Max excess (margin - min) over directions with phi > active_eps."""
    exc_e = torch.where(phi.e > active_eps, margin_e - min_margin[..., None], 0.0)
    exc_c = torch.where(phi.c > active_eps, margin_c - min_margin, 0.0)
    return torch.maximum(exc_e.max(), exc_c.max())


def kkt_residual(inst: Instance, phi: Phi, active_eps: float = 1e-6) -> torch.Tensor:
    """Residual of the KKT necessary condition (5).  0 <=> (5) holds."""
    fl = flows(inst, phi)
    m = marginals(inst, phi, fl)
    ge = fl.t[..., None] * torch.where(m.delta_e < BIG, m.delta_e, 0.0)
    gc = fl.t * torch.where(m.delta_c < BIG, m.delta_c, 0.0)
    ge = torch.where(m.delta_e < BIG, ge, BIG)
    gc = torch.where(m.delta_c < BIG, gc, BIG)
    min_margin = torch.minimum(ge.amin(-1), gc)
    return _residual(min_margin, ge, gc, phi, active_eps)


def sufficiency_residual(inst: Instance, phi: Phi,
                         active_eps: float = 1e-6) -> torch.Tensor:
    """Residual of the sufficiency condition (6).  0 <=> global optimum."""
    m = marginals(inst, phi)
    min_margin = torch.minimum(m.delta_e.amin(-1), m.delta_c)
    return _residual(min_margin, m.delta_e, m.delta_c, phi, active_eps)


def per_app_residual(inst: Instance, phi: Phi,
                     active_eps: float = 1e-6) -> torch.Tensor:
    """(..., A) sufficiency residual of condition (6), per application.

    The excess of :func:`sufficiency_residual`, with the marginals computed
    under the global flows F/G (an application's residual reflects the
    congestion every other application imposes on it), maximized only over
    the application's own (k, i, j) directions.  ~0 certifies that the
    application's strategy is stationary given everyone else's: the skip
    gate of the online re-solve.  Dead or padded applications (no active
    direction) give exactly 0.
    """
    m = marginals(inst, phi)
    min_margin = torch.minimum(m.delta_e.amin(-1), m.delta_c)   # (...,A,K1,V)
    zero = phi.c.new_zeros(())
    exc_e = torch.where(phi.e > active_eps, m.delta_e - min_margin[..., None], zero)
    exc_c = torch.where(phi.c > active_eps, m.delta_c - min_margin, zero)
    return torch.maximum(exc_e.flatten(-3).amax(-1), exc_c.flatten(-2).amax(-1))


def satisfies_sufficiency(inst: Instance, phi: Phi, tol: float = 1e-3) -> bool:
    return bool(sufficiency_residual(inst, phi) <= tol)


def satisfies_kkt(inst: Instance, phi: Phi, tol: float = 1e-3) -> bool:
    return bool(kkt_residual(inst, phi) <= tol)
