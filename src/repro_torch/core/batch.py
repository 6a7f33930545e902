"""Instance padding and stacking: a family of scenarios as one stacked Instance.

Port of ``repro.core.batch`` for dense instances.  The paper's evaluation
(Figs. 5-7) is a statement about families of scenarios.  Every member is
padded to the family's common (V, A, K1) envelope and the padded fields are
stacked along a leading member dim; ``gp.solve_batched`` then runs the
whole family in one member-batched loop.

Padding invariants (the reference's DESIGN.md §9):

  * **Dead nodes** (index >= the member's true V): no adjacency, zero input
    rate, unit CPU capacity.  They receive zero traffic, so with
    D(0) = C(0) = 0 they add nothing to the objective, and the stage systems
    stay nonsingular (their rows reduce to the identity).
  * **Dead applications / stages**: zero rate, ``stage_mask`` False, so
    ``renormalize`` zeroes their strategy rows and ``cpu_allowed`` excludes
    them from every direction set.
  * **Cost kinds** select Python code paths and must agree across a batch
    (``scenarios.run_sweep`` groups by kind first).

Every padded field is bit-equal to the reference's.  The reference's
``batch_size(binst)`` is ``binst.batch_shape[0]`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.network import DENSE_FIELDS, Instance
from repro_torch.core.traffic import Phi

# Packet-size fill of padded stages: the instances' positive floor, so a
# padded entry never brings a zero-size degeneracy.
_L_FILL = 0.01


def next_pow2(n: int) -> int:
    """Size-class quantizer of ``scenarios.run_sweep``'s grouping."""
    return 1 << max(n - 1, 0).bit_length()


def _pad_axis(x: torch.Tensor, axis: int, target: int, fill) -> torch.Tensor:
    cur = x.shape[axis]
    if cur == target:
        return x
    shape = list(x.shape)
    shape[axis] = target - cur
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)],
                     dim=axis)


def _refuse_sparse(inst: Instance) -> None:
    if inst.has_sparse:
        raise NotImplementedError(
            "batching instances with a sparse topology (the neighbor lists' "
            "hetero-degree padding) is not ported yet: ROADMAP Queue 1, Sparse "
            "batching and the metro leftovers; "
            "strip it with network.without_sparse")


def pad_instance(inst: Instance, V: int, A: int, K1: int) -> Instance:
    """Pad one dense instance to the (V, A, K1) envelope (no member dim)."""
    _refuse_sparse(inst)
    if V < inst.V or A < inst.A or K1 < inst.K1:
        raise ValueError(
            f"target shape ({V},{A},{K1}) smaller than instance "
            f"({inst.V},{inst.A},{inst.K1})")
    return dataclasses.replace(
        inst,
        adj=_pad_axis(_pad_axis(inst.adj, 0, V, False), 1, V, False),
        link_param=_pad_axis(_pad_axis(inst.link_param, 0, V, 0.0), 1, V, 0.0),
        # dead nodes get unit CPU capacity: zero workload, and a zero
        # capacity would blow up the queue family's marginal at 0 flow
        comp_param=_pad_axis(inst.comp_param, 0, V, 1.0),
        wnode=_pad_axis(inst.wnode, 0, V, 1.0),
        L=_pad_axis(_pad_axis(inst.L, 1, K1, _L_FILL), 0, A, _L_FILL),
        w=_pad_axis(_pad_axis(inst.w, 1, K1, 0.0), 0, A, 0.0),
        r=_pad_axis(_pad_axis(inst.r, 1, V, 0.0), 0, A, 0.0),
        dst=_pad_axis(inst.dst, 0, A, 0),
        n_tasks=_pad_axis(inst.n_tasks, 0, A, 0),
        stage_mask=_pad_axis(_pad_axis(inst.stage_mask, 1, K1, False), 0, A, False),
    )


def batch_envelope(insts: Sequence[Instance]) -> tuple[int, int, int]:
    """Common (V, A, K1) envelope of a family."""
    return (max(i.V for i in insts), max(i.A for i in insts),
            max(i.K1 for i in insts))


def pad_instances(insts: Sequence[Instance]) -> Instance:
    """Stack dense instances into one Instance whose every field has a
    leading member dim: ``adj (B, V, V)``, ``r (B, A, V)``, ...

    Members must share ``link_kind``/``comp_kind`` and lie on one device.
    """
    if not insts:
        raise ValueError("pad_instances needs at least one instance")
    kinds = {(i.link_kind, i.comp_kind) for i in insts}
    if len(kinds) > 1:
        raise ValueError(
            f"cannot batch across cost families {sorted(kinds)}; group "
            "instances by (link_kind, comp_kind) first")
    for inst in insts:
        _refuse_sparse(inst)
        if inst.batch_shape:
            raise ValueError("pad_instances takes unstacked instances")
    V, A, K1 = batch_envelope(insts)
    padded = [pad_instance(i, V, A, K1) for i in insts]
    return dataclasses.replace(padded[0], **{
        f: torch.stack([getattr(p, f) for p in padded]) for f in DENSE_FIELDS})


def instance_slice(binst: Instance, b: int) -> Instance:
    """Padded member ``b`` of a stacked Instance."""
    return dataclasses.replace(binst, **{f: getattr(binst, f)[b] for f in DENSE_FIELDS})


def pad_phi(phi: Phi, V: int, A: int, K1: int,
            inst: Optional[Instance] = None) -> Phi:
    """Pad a strategy to the (V, A, K1) envelope.

    Padded rows are zero, which is right for every degenerate row.  The one
    non-degenerate padded row class is (real app, non-final stage, dead
    node): constraint (1) wants those to sum to 1 although they carry no
    traffic.  With ``inst`` (the unpadded instance) they are seeded with
    full local offloading (phi_c = 1), as ``init_phi`` gives there.
    """
    V0 = phi.e.shape[2]
    e = phi.e
    for axis, tgt in ((0, A), (1, K1), (2, V), (3, V)):
        e = _pad_axis(e, axis, tgt, 0.0)
    c = phi.c
    for axis, tgt in ((0, A), (1, K1), (2, V)):
        c = _pad_axis(c, axis, tgt, 0.0)
    if inst is not None and V > V0:
        dead = torch.arange(V, device=c.device) >= V0
        cpu_ok = _pad_axis(_pad_axis(inst.cpu_allowed(), 1, K1, False), 0, A, False)
        c = torch.where(dead & cpu_ok[:, :, None], 1.0, c)
    return Phi(e=e, c=c)


def pad_phis(phis: Sequence[Phi], insts: Sequence[Instance]) -> Phi:
    """Stack per-instance strategies to match ``pad_instances(insts)``."""
    V, A, K1 = batch_envelope(insts)
    padded = [pad_phi(p, V, A, K1, inst) for p, inst in zip(phis, insts)]
    return Phi(e=torch.stack([p.e for p in padded]),
               c=torch.stack([p.c for p in padded]))


def unpad_phi(phi: Phi, inst: Instance) -> Phi:
    """Strip padding back to an instance's true (V, A, K1)."""
    A, K1, V = inst.A, inst.K1, inst.V
    return Phi(e=phi.e[:A, :K1, :V, :V], c=phi.c[:A, :K1, :V])


def valid_mask(binst: Instance, insts: Sequence[Instance]) -> np.ndarray:
    """(B, V) bool: which nodes of each padded member are real."""
    mask = np.zeros((binst.batch_shape[0], binst.V), dtype=bool)
    for b, inst in enumerate(insts):
        mask[b, : inst.V] = True
    return mask
