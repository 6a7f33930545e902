"""Service chains, including chains derived from DNN vertical splits.

Port of ``repro.core.chain``.  The paper's headline use case is "DNN with
vertical split" (Section I): :func:`chain_from_arch` cuts a model config's
layer stack into ``n_segments`` tasks, the inter-segment activation
byte-rate gives the stage packet sizes ``L_(a,k)`` and the per-segment
FLOP count the computation weights ``w(a,k)``;
:func:`instance_from_chains` turns such chains into an :class:`Instance`
that GP solves like the paper's synthetic chains.

``w`` reproduces the reference bit for bit, including its unit: the
per-token FLOPs of ``layer_flops`` are divided by ``tokens_per_packet`` and
multiplied by it again, so ``w[k]`` is segment k's FLOPs per TOKEN (in
``flops_unit``), not per packet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.network import QUEUE, Device, Instance, resolve_device
from repro_torch.models.flops import embed_bits_per_token, layer_flops


@dataclasses.dataclass(frozen=True)
class ChainProfile:
    """One service-chain application, in network units.

    L[k]  — packet size (bits per request-packet) of stage k, k = 0..K
    w[k]  — computation workload per packet for task k+1 (w[K] unused)
    """

    name: str
    L: np.ndarray
    w: np.ndarray

    @property
    def n_tasks(self) -> int:
        return len(self.L) - 1


def segment_bounds(n_layers: int, n_segments: int) -> np.ndarray:
    """Layer indices cutting ``n_layers`` into ``n_segments`` near-equal
    segments: segment k runs layers ``bounds[k]:bounds[k + 1]``."""
    return np.linspace(0, n_layers, n_segments + 1).round().astype(int)


def chain_from_arch(
    cfg,
    *,
    n_segments: int = 3,
    tokens_per_packet: int = 128,
    flops_unit: float = 1e12,
    bits_unit: float = 1e6,
) -> ChainProfile:
    """Vertical-split service chain for a model config.

    Stage-0 packets are token ids (or frame/patch embeddings for audio/VLM);
    stages 1..K-1 are the residual-stream activations between segments;
    stage K is the output token ids.  Workloads are the analytic segment
    FLOPs in ``flops_unit``; packet sizes in ``bits_unit``.
    """
    act_bits = cfg.d_model * 16 * tokens_per_packet          # bf16 residual
    in_bits = embed_bits_per_token(cfg) * tokens_per_packet
    out_bits = 32 * tokens_per_packet                        # token ids out

    per_layer = layer_flops(cfg, seq_len=tokens_per_packet) / tokens_per_packet
    seg_layers = np.diff(segment_bounds(cfg.n_layers, n_segments))

    L = np.empty(n_segments + 1)
    L[0] = in_bits / bits_unit
    L[1:n_segments] = act_bits / bits_unit
    L[n_segments] = out_bits / bits_unit
    w = np.zeros(n_segments + 1)
    w[:n_segments] = seg_layers * per_layer * tokens_per_packet / flops_unit
    return ChainProfile(name=cfg.name, L=L, w=w)


def instance_from_chains(
    adj: np.ndarray,
    chains: Sequence[ChainProfile],
    *,
    sources: Sequence[Sequence[int]],
    rates: Sequence[Sequence[float]],
    dests: Sequence[int],
    link_capacity: float | np.ndarray = 100.0,
    comp_capacity: float | np.ndarray = 50.0,
    link_kind: int = QUEUE,
    comp_kind: int = QUEUE,
    wnode: np.ndarray | None = None,
    device: Device = "cuda",
) -> Instance:
    """An :class:`Instance` whose applications are the given chains, on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    V = adj.shape[0]
    A = len(chains)
    K1 = max(c.n_tasks for c in chains) + 1

    L = np.zeros((A, K1))
    w = np.zeros((A, K1))
    stage_mask = np.zeros((A, K1), dtype=bool)
    n_tasks = np.zeros(A, dtype=np.int64)
    r = np.zeros((A, V))
    for a, c in enumerate(chains):
        k1 = c.n_tasks + 1
        L[a, :k1] = c.L
        w[a, :k1] = c.w
        stage_mask[a, :k1] = True
        n_tasks[a] = c.n_tasks
        for s, rate in zip(sources[a], rates[a]):
            r[a, s] += rate

    link_param = np.where(adj, np.broadcast_to(np.asarray(link_capacity, dtype=float),
                                               (V, V)), 0.0)
    comp_param = np.broadcast_to(np.asarray(comp_capacity, dtype=float), (V,))

    def f32(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)

    return Instance(
        adj=torch.tensor(np.asarray(adj, dtype=bool), device=dev),
        link_param=f32(link_param),
        link_kind=link_kind,
        comp_param=f32(comp_param),
        comp_kind=comp_kind,
        L=f32(L),
        w=f32(w),
        wnode=f32(wnode if wnode is not None else np.ones(V)),
        r=f32(r),
        dst=torch.tensor(np.asarray(dests, dtype=np.int64), device=dev),
        n_tasks=torch.tensor(n_tasks, device=dev),
        stage_mask=torch.tensor(stage_mask, device=dev),
    )
