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


def _layer_period(cfg) -> tuple[int, int]:
    """(n_prefix, period) of the reference's layer stack: the leading layers
    it keeps unstacked, and the length of the period its scan stacks."""
    n_prefix = cfg.moe.first_k_dense if cfg.moe else 0
    if cfg.hybrid_attn_period:
        period = cfg.hybrid_attn_period
    elif cfg.local_global:
        period = 2
    elif cfg.moe and cfg.moe.every > 1:
        period = cfg.moe.every
    else:
        period = 1
    if (cfg.n_layers - n_prefix) % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers - n_prefix} body layers, period {period}")
    return n_prefix, period


def model_params_from_numpy(cfg, tree: dict) -> dict:
    """The port's ``Model`` state (``load_state_dict``'s argument, float32 CPU
    tensors) from the reference's params pytree as nested dicts of numpy
    arrays (``Model.init``'s pytree with its NamedTuples turned into dicts
    by field name).

    The reference stacks the layers of each period position along a
    leading axis (``body[p][...][c]`` is layer ``n_prefix + c * period +
    p``); this unstacks them into one entry per layer.  An MoE layer's
    ``MoEParams`` come as its dict like any other: ``ffn.router`` (d, E),
    the experts ``ffn.w_gate`` / ``w_up`` (E, d, f) and ``w_down`` (E, f, d)
    unstacked from (n_periods, E, ...), and the ``shared_*`` tensors kept
    zero-width where the config has no shared expert.
    """
    n_prefix, period = _layer_period(cfg)
    n_periods = (cfg.n_layers - n_prefix) // period

    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float32))

    out = {"embedding": t(tree["embed"]), "final_norm": t(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = t(tree["lm_head"])

    def put(idx, block, pick):
        for name, val in block.items():
            if isinstance(val, dict):
                for field, arr in val.items():
                    out[f"layers.{idx}.{name}.{field}"] = t(pick(arr))
            else:
                out[f"layers.{idx}.{name}"] = t(pick(val))

    for i, block in enumerate(tree.get("prefix", [])):
        put(i, block, lambda a: a)
    for p, block in enumerate(tree["body"]):
        for c in range(n_periods):
            put(n_prefix + c * period + p, block, lambda a, c=c: np.asarray(a)[c])
    return out


def _cache_tensor(x, dev) -> torch.Tensor:
    """A cache array as a tensor of its own dtype; bfloat16 arrays (numpy's
    ``ml_dtypes`` type, which torch does not read) go through float32,
    exactly."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.astype(np.float32), device=dev).to(torch.bfloat16)
    return torch.tensor(x, device=dev)


def cache_from_numpy(cfg, tree: dict, device: Device = "cuda") -> list:
    """The port's per-layer cache (``Model.init_cache``'s form, on
    ``device``) from the reference's cache as nested lists of numpy arrays:
    ``{"prefix": [entry, ...], "body": [entry, ...]}``, each entry a pair
    ((k, v) or (conv state, SSM state)), a body entry's arrays stacked by
    period as ``model_params_from_numpy`` unstacks them."""
    dev = resolve_device(device)
    n_prefix, period = _layer_period(cfg)
    n_periods = (cfg.n_layers - n_prefix) // period
    out = [None] * cfg.n_layers
    for i, entry in enumerate(tree.get("prefix", [])):
        out[i] = tuple(_cache_tensor(a, dev) for a in entry)
    for p, entry in enumerate(tree["body"]):
        for c in range(n_periods):
            out[n_prefix + c * period + p] = tuple(_cache_tensor(np.asarray(a)[c], dev)
                                                   for a in entry)
    return out
