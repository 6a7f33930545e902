"""Carry problem state into the port from plain numpy arrays.

The port and the JAX package share no code, so state crosses between them
as numpy arrays, one per field: ``np.asarray`` of each field of a reference
``Instance`` or ``Phi`` on one side, these constructors on the other.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import Device, Instance, resolve_device
from repro_torch.core.traffic import Phi

_FLOAT = ("link_param", "comp_param", "L", "w", "wnode", "r")
_INT = ("dst", "n_tasks")
_BOOL = ("adj", "stage_mask")
# The optional sparse topology (``network.with_sparse``): int64 index
# lists and bool masks, carried when the dict holds them.
_SPARSE_INT = ("out_nbr", "in_nbr", "node_part", "blk_nbr")
_SPARSE_BOOL = ("out_mask", "in_mask", "blk_mask")


def instance_from_numpy(fields: dict, link_kind: int, comp_kind: int,
                        device: Device = "cuda") -> Instance:
    """An :class:`Instance` from ``{field name: array}``.

    Floats become float32, node/task indices int64, masks bool.  The seven
    sparse-topology fields are carried when ``fields`` holds them (all or
    none, not ``None``).
    """
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.tensor(np.asarray(fields[name], dtype=dtype), device=dev)

    kw = {n: t(n, np.float32) for n in _FLOAT}
    kw.update({n: t(n, np.int64) for n in _INT})
    kw.update({n: t(n, bool) for n in _BOOL})
    sparse = [n for n in _SPARSE_INT + _SPARSE_BOOL if fields.get(n) is not None]
    if sparse:
        missing = sorted(set(_SPARSE_INT + _SPARSE_BOOL) - set(sparse))
        if missing:
            raise ValueError(f"sparse topology incomplete: missing {missing}")
        kw.update({n: t(n, np.int64) for n in _SPARSE_INT})
        kw.update({n: t(n, bool) for n in _SPARSE_BOOL})
    return Instance(link_kind=int(link_kind), comp_kind=int(comp_kind), **kw)


def phi_from_numpy(e, c, device: Device = "cuda") -> Phi:
    """A float32 :class:`Phi` from its (A, K1, V, V) and (A, K1, V) arrays."""
    dev = resolve_device(device)
    return Phi(e=torch.tensor(np.asarray(e, dtype=np.float32), device=dev),
               c=torch.tensor(np.asarray(c, dtype=np.float32), device=dev))
