"""Network model for collaborative edge computing (CEC), in PyTorch.

Port of ``repro.core.network``: the directed-graph model of Section II and
the Table II evaluation topologies.  An :class:`Instance` bundles what
problem (2) needs (adjacency, link and CPU cost parameters, the
applications' chains, packet sizes, weights, input rates and destinations)
as a dataclass of tensors on one device.

The topology builders are numpy only.  Each adds its nodes in label order,
so the adjacency matrices equal the reference's (which builds networkx
graphs and relabels them in insertion order) without relabelling.  The
random draws of :func:`build_instance`, :func:`small_world` and
:func:`metro_geant` make the same ``numpy.random.default_rng`` calls in
the same order, so every field is bit for bit the reference's.

The sparse topology of the metro path (padded neighbor lists, the BFS
partition and the block-level neighbor lists of the blocked stage
systems) is numpy too, bit-equal to the reference's, and rides on the
:class:`Instance` as optional tensors (:func:`with_sparse`).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import random
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import costs
from repro_torch.kernels.sparse_solve import SPARSE_BLOCK

# Cost-family identifiers (match repro_torch.core.costs).
LINEAR = costs.LINEAR
QUEUE = costs.QUEUE

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and absent: no silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Instance:
    """A complete CEC service-chain forwarding/offloading problem instance.

    Shapes: V = #nodes, A = #applications, K1 = max(|T_a|) + 1 stages.
    Every tensor lies on one device; ``link_kind``/``comp_kind`` are ints.
    """

    # --- graph ---
    adj: torch.Tensor           # (V, V) bool, adj[i, j] == (i, j) in E
    link_param: torch.Tensor    # (V, V) float32, capacity (QUEUE) or coeff
    link_kind: int              # costs.LINEAR or costs.QUEUE
    comp_param: torch.Tensor    # (V,) float32, CPU capacity (QUEUE) or coeff
    comp_kind: int
    # --- applications ---
    L: torch.Tensor             # (A, K1) float32 packet size of stage (a, k)
    w: torch.Tensor             # (A, K1) float32 computation weight of task k+1
    wnode: torch.Tensor         # (V,) float32 per-node workload multiplier
    r: torch.Tensor             # (A, V) float32 exogenous input rate of a at i
    dst: torch.Tensor           # (A,) int64 destination node d_a
    n_tasks: torch.Tensor       # (A,) int64 |T_a|
    stage_mask: torch.Tensor    # (A, K1) bool, valid stages k <= |T_a|
    # --- sparse topology (optional, attached by ``with_sparse``) ---
    # Padded neighbor lists: row i lists its out-/in-neighbors in columns
    # 0..deg-1; masked columns point at i itself (a safe gather target).
    out_nbr: Optional[torch.Tensor] = None    # (V, D) int64
    out_mask: Optional[torch.Tensor] = None   # (V, D) bool
    in_nbr: Optional[torch.Tensor] = None     # (V, D) int64
    in_mask: Optional[torch.Tensor] = None    # (V, D) bool
    node_part: Optional[torch.Tensor] = None  # (V,) int64 BFS routing-block id
    # Block-level neighbor lists of the SPARSE_BLOCK x SPARSE_BLOCK blocked
    # stage systems (symmetrized: one structure serves Phi and Phi^T).
    blk_nbr: Optional[torch.Tensor] = None    # (NB, BD) int64
    blk_mask: Optional[torch.Tensor] = None   # (NB, BD) bool

    @property
    def V(self) -> int:
        return int(self.adj.shape[-1])

    @property
    def A(self) -> int:
        return int(self.L.shape[-2])

    @property
    def K1(self) -> int:
        return int(self.L.shape[-1])

    @property
    def batch_shape(self) -> tuple:
        """Leading member dims: () for one instance, (B,) for a stacked
        family (``batch.pad_instances``); every field carries them."""
        return tuple(self.adj.shape[:-2])

    @property
    def device(self) -> torch.device:
        return self.adj.device

    @property
    def has_sparse(self) -> bool:
        """Whether the sparse-topology fields are attached (``with_sparse``)."""
        return self.out_nbr is not None

    @property
    def max_degree(self) -> int:
        """Neighbor-list pad width D (0 when no sparse topology attached)."""
        return int(self.out_nbr.shape[-1]) if self.has_sparse else 0

    def degenerate_mask(self) -> torch.Tensor:
        """(..., A, K1, V) bool: True where phi must sum to 0 (eq. (1) lower
        branch).

        Stage K_a at the destination is the network's exit; a final-stage
        row at a node without outgoing links is degenerate too.
        """
        dev = self.device
        karr = torch.arange(self.K1, device=dev)[:, None]             # (K1,1)
        is_last = karr == self.n_tasks[..., None, None]                # (...,A,K1,1)
        is_dst = (torch.arange(self.V, device=dev)
                  == self.dst[..., None, None])                        # (...,A,1,V)
        no_out = ~self.adj.any(dim=-1)                                 # (...,V)
        return ((is_last & is_dst) | (is_last & no_out[..., None, None, :])
                | ~self.stage_mask[..., None])

    def cpu_allowed(self) -> torch.Tensor:
        """(..., A, K1) bool: whether phi_{i0}(a,k) may be nonzero (k < |T_a|)."""
        karr = torch.arange(self.K1, device=self.device)
        return (karr < self.n_tasks[..., None]) & self.stage_mask

    @functools.cached_property
    def lifted(self) -> "Instance":
        """The instance with a unit dim after its member dims on every dense
        field, so that it broadcasts against a strategy stack with one more
        leading dim (the stepsize ladder's candidates).  The sparse
        topology is shared, not lifted.  Built once per instance: a solve
        asks for it twice a step."""
        cut = len(self.batch_shape)
        return dataclasses.replace(self, **{
            f: getattr(self, f).reshape(getattr(self, f).shape[:cut] + (1,)
                                        + getattr(self, f).shape[cut:])
            for f in DENSE_FIELDS})


# The per-instance tensor fields, the ones a member dim is stacked on.
DENSE_FIELDS = ("adj", "link_param", "comp_param", "L", "w", "wnode", "r", "dst",
                "n_tasks", "stage_mask")
# The sparse topology's fields (``with_sparse``); a stacked sparse family
# carries the member dim on these too (``batch.pad_instances``).
SPARSE_FIELDS = ("out_nbr", "out_mask", "in_nbr", "in_mask", "node_part", "blk_nbr",
                 "blk_mask")


def member_fields(inst: "Instance") -> tuple:
    """The fields that carry an instance's member dims: the dense ones, and
    the sparse topology's where it is attached."""
    return DENSE_FIELDS + (SPARSE_FIELDS if inst.has_sparse else ())


# ---------------------------------------------------------------------------
# Topologies (Table II), numpy only
# ---------------------------------------------------------------------------

def _to_directed(n: int, edges) -> np.ndarray:
    """Undirected edge list on nodes 0..n-1 -> bool adjacency, both ways."""
    adj = np.zeros((n, n), dtype=bool)
    for u, v in edges:
        adj[u, v] = True
        adj[v, u] = True
    return adj


def _n_undirected(adj: np.ndarray) -> int:
    return int(np.triu(adj | adj.T).sum())


def _gnm_edges(n: int, m: int, seed: int) -> list[tuple[int, int]]:
    """networkx 3.x ``gnm_random_graph(n, m, seed)``'s draws: over
    ``random.Random(seed)``, pick u and v uniformly from the n nodes,
    reject a self-loop or a repeated edge, stop at m edges (all of them
    when m reaches n(n-1)/2)."""
    if m >= n * (n - 1) / 2:
        return [(u, v) for u in range(n) for v in range(u + 1, n)]
    draw = random.Random(seed)
    nodes = range(n)
    edges: set[frozenset] = set()
    out = []
    while len(out) < m:
        u, v = draw.choice(nodes), draw.choice(nodes)
        if u == v or frozenset((u, v)) in edges:
            continue
        edges.add(frozenset((u, v)))
        out.append((u, v))
    return out


def _connected(adj: np.ndarray) -> bool:
    """Breadth-first search from node 0 reaches every node."""
    seen = np.zeros(adj.shape[0], dtype=bool)
    seen[0] = True
    frontier = [0]
    while frontier:
        nxt = np.flatnonzero(adj[frontier].any(axis=0) & ~seen)
        seen[nxt] = True
        frontier = nxt.tolist()
    return bool(seen.all())


def connected_er(n: int = 20, m: int = 40, seed: int = 0) -> np.ndarray:
    """Connectivity-guaranteed Erdos-Renyi graph with n nodes and m edges.

    The reference's sampler, draw for draw: an outer numpy generator seeds
    each networkx-style G(n, m) trial (:func:`_gnm_edges`) until one is
    connected.
    """
    rng = np.random.default_rng(seed)
    for _ in range(10_000):
        adj = _to_directed(n, _gnm_edges(n, m, int(rng.integers(1 << 31))))
        if _connected(adj):
            return adj
    raise RuntimeError("could not sample a connected ER graph")


def balanced_tree(r: int = 2, h: int = 3) -> np.ndarray:
    """Complete r-ary tree of height h: r=2, h=3 -> 15 nodes / 14 edges."""
    n = sum(r ** d for d in range(h + 1))
    return _to_directed(n, [((v - 1) // r, v) for v in range(1, n)])


def fog(seed: int = 0) -> np.ndarray:
    """A 3-tier fog-computing sample topology, 19 nodes / 30 edges."""
    edges = [(0, s) for s in range(1, 7)]                 # cloud <-> server
    edges += [(s, 1 + (s % 6)) for s in range(1, 7)]      # server ring
    edges += [(d, 1 + (d - 7) % 6) for d in range(7, 19)]  # device -> server
    edges += [(d, 7 + (d - 7 + 3) % 12) for d in range(7, 19, 2)]  # D2D
    adj = _to_directed(19, edges)
    assert _n_undirected(adj) == 30
    return adj


def abilene() -> np.ndarray:
    """Abilene (Internet2 predecessor): 11 nodes / 14 edges."""
    edges = [
        (0, 1), (0, 2), (1, 2), (1, 3), (2, 4), (3, 4), (3, 5), (4, 6),
        (5, 6), (5, 7), (6, 8), (7, 9), (8, 9), (9, 10),
    ]
    adj = _to_directed(11, edges)
    assert _n_undirected(adj) == 14
    return adj


def lhc(seed: int = 7) -> np.ndarray:
    """LHC computing-grid-like topology, 16 nodes / 31 edges."""
    edges = [(0, t1) for t1 in range(1, 6)]               # tier-0 hub
    edges += [(t1, 1 + (t1 % 5)) for t1 in range(1, 6)]   # tier-1 ring
    for t2 in range(6, 16):                               # dual-homed tier 2
        edges += [(t2, 1 + (t2 - 6) % 5), (t2, 1 + (t2 - 6 + 2) % 5)]
    edges.append((6, 11))                                 # shortcut
    adj = _to_directed(16, edges)
    assert _n_undirected(adj) == 31
    return adj


def geant(seed: int = 11) -> np.ndarray:
    """GEANT-like pan-European topology, 22 nodes / 33 edges."""
    n = 22
    edges = [(i, (i + 1) % n) for i in range(n)]          # backbone ring
    edges += [(0, 5), (2, 9), (4, 13), (6, 17), (8, 15), (10, 19),
              (12, 21), (1, 14), (3, 18), (7, 20), (11, 16)]
    adj = _to_directed(n, edges)
    assert _n_undirected(adj) == 33
    return adj


def small_world(n: int = 100, seed: int = 3,
                n_long: Optional[int] = None) -> np.ndarray:
    """Ring + i+2/i+3 short-range chords + ``n_long`` random long chords.

    At the Table II defaults (n=100, seed=3) this is the paper's
    100-node / 320-edge topology.
    """
    adj = _to_directed(n, [(i, (i + d) % n) for i in range(n)
                           for d in (1, 2, 3)])
    if n_long is None:
        n_long = n // 5
    rng = np.random.default_rng(seed)
    added = 0
    while added < n_long:                                 # long-range chords
        u, v = rng.integers(0, n, size=2)
        if u != v and not adj[u, v]:
            adj[u, v] = adj[v, u] = True
            added += 1
    if n == 100 and n_long == 20:
        assert _n_undirected(adj) == 320
    return adj


def metro_geant(n: int = 300, seed: int = 11) -> np.ndarray:
    """GEANT-like ring + chords construction scaled to metro node counts.

    Same shape as :func:`geant` (backbone ring + n/2 random chords, average
    degree 3) at any ``n``; the chords are drawn as the reference draws
    them, so the adjacency is the reference's.
    """
    adj = _to_directed(n, [(i, (i + 1) % n) for i in range(n)])
    rng = np.random.default_rng(seed)
    added = 0
    while added < n // 2:                                 # chords
        u, v = rng.integers(0, n, size=2)
        if u != v and not adj[u, v]:
            adj[u, v] = adj[v, u] = True
            added += 1
    return adj


TOPOLOGIES = {
    "connected-er": lambda: connected_er(20, 40, seed=0),
    "balanced-tree": lambda: balanced_tree(2, 3),
    "fog": fog,
    "abilene": abilene,
    "lhc": lhc,
    "geant": geant,
    "sw": small_world,
}


# ---------------------------------------------------------------------------
# Sparse topology (padded neighbor lists + graph partition), numpy only
# ---------------------------------------------------------------------------

def sparse_neighbors(adj: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Padded neighbor lists of a dense adjacency.

    Returns ``(out_nbr, out_mask, in_nbr, in_mask)``, each ``(V, D)`` with
    ``D = max(1, max degree)``: row ``i`` lists its out-(in-)neighbors in
    the leading columns; masked columns point at ``i`` itself so gathers
    through them stay in bounds (and are zeroed by the mask).
    """
    adj = np.asarray(adj, dtype=bool)
    V = adj.shape[0]
    D = max(1, int(max(adj.sum(1).max(initial=0), adj.sum(0).max(initial=0))))
    out_nbr = np.tile(np.arange(V, dtype=np.int32)[:, None], (1, D))
    in_nbr = out_nbr.copy()
    out_mask = np.zeros((V, D), dtype=bool)
    in_mask = np.zeros((V, D), dtype=bool)
    for i in range(V):
        js = np.nonzero(adj[i])[0]
        out_nbr[i, : len(js)] = js
        out_mask[i, : len(js)] = True
        js = np.nonzero(adj[:, i])[0]
        in_nbr[i, : len(js)] = js
        in_mask[i, : len(js)] = True
    return out_nbr, out_mask, in_nbr, in_mask


def graph_partition(adj: np.ndarray) -> np.ndarray:
    """(V,) int32 routing-block labels: BFS discovery order packed into
    groups of ``SPARSE_BLOCK`` nodes.

    For the ring-labelled metro builders the labels coincide with the
    contiguous index blocks ``i // block`` that the blocked kernels use;
    the labels themselves are diagnostic metadata.
    """
    adj = np.asarray(adj, dtype=bool)
    V = adj.shape[0]
    seen = np.zeros(V, dtype=bool)
    order = []
    for s in range(V):
        if seen[s]:
            continue
        seen[s] = True
        queue = collections.deque([s])
        while queue:
            u = queue.popleft()
            order.append(u)
            for v in np.nonzero(adj[u])[0]:
                if not seen[v]:
                    seen[v] = True
                    queue.append(int(v))
    part = np.empty(V, dtype=np.int32)
    part[np.asarray(order)] = np.arange(V, dtype=np.int32) // SPARSE_BLOCK
    return part


def block_neighbors(adj: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Block-level neighbor lists of the partition-blocked stage systems.

    Nodes are grouped into ``NB = ceil(V / SPARSE_BLOCK)`` contiguous index
    blocks; block pair (I, J) is a neighbor iff an edge in either direction
    touches the (I, J) submatrix (symmetrized, so one structure serves
    ``Phi`` and ``Phi^T``).  Returns ``(blk_nbr, blk_mask)``, each ``(NB, BD)`` with
    ``BD`` the largest block degree; masked columns point at ``I`` itself.
    """
    adj = np.asarray(adj, dtype=bool)
    V = adj.shape[0]
    bs = SPARSE_BLOCK
    NB = -(-V // bs)
    ap = np.zeros((NB * bs, NB * bs), dtype=bool)
    ap[:V, :V] = adj
    touch = ap.reshape(NB, bs, NB, bs).any(axis=(1, 3))
    touch = touch | touch.T
    BD = max(1, int(touch.sum(1).max(initial=0)))
    blk_nbr = np.tile(np.arange(NB, dtype=np.int32)[:, None], (1, BD))
    blk_mask = np.zeros((NB, BD), dtype=bool)
    for i in range(NB):
        js = np.nonzero(touch[i])[0]
        blk_nbr[i, : len(js)] = js
        blk_mask[i, : len(js)] = True
    return blk_nbr, blk_mask


def with_sparse(inst: Instance) -> Instance:
    """Attach the sparse topology fields to an instance.

    The dense fields are untouched; the neighbor lists (int64) and masks
    (bool) are built on the host from ``inst.adj`` and placed on the
    instance's device, where the sparse stage solver and the
    neighbor-list tagged sweep read them.
    """
    adj = inst.adj.cpu().numpy()
    out_nbr, out_mask, in_nbr, in_mask = sparse_neighbors(adj)
    part = graph_partition(adj)
    blk_nbr, blk_mask = block_neighbors(adj)
    dev = inst.device

    def t(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype=dtype)).to(dev)

    return dataclasses.replace(
        inst,
        out_nbr=t(out_nbr, np.int64), out_mask=t(out_mask, bool),
        in_nbr=t(in_nbr, np.int64), in_mask=t(in_mask, bool),
        node_part=t(part, np.int64),
        blk_nbr=t(blk_nbr, np.int64), blk_mask=t(blk_mask, bool),
    )


def without_sparse(inst: Instance) -> Instance:
    """Strip the sparse topology fields (back to the dense route)."""
    return dataclasses.replace(
        inst, out_nbr=None, out_mask=None, in_nbr=None, in_mask=None,
        node_part=None, blk_nbr=None, blk_mask=None,
    )


def n_edges(inst: Instance) -> int:
    """Directed edge count |E|."""
    return int(inst.adj.sum())


# ---------------------------------------------------------------------------
# Instance builders
# ---------------------------------------------------------------------------

def build_instance(
    adj: np.ndarray,
    *,
    n_apps: int,
    n_tasks: int = 2,
    n_sources: int = 3,
    link_kind: int = QUEUE,
    comp_kind: int = QUEUE,
    link_mean: float = 10.0,
    comp_mean: float = 12.0,
    rate_lo: float = 0.5,
    rate_hi: float = 1.5,
    packet_sizes: Optional[np.ndarray] = None,
    comp_weight: float = 1.0,
    seed: int = 0,
    heterogeneity: float = 0.3,
    device: Device = "cuda",
) -> Instance:
    """Build a random instance in the style of Table II.

    Link/CPU parameters are u.a.r. in [1-h, 1+h] * mean; input rates u.a.r.
    in [rate_lo, rate_hi] at ``n_sources`` random source nodes.  Packet
    sizes default to the paper's ``L_(a,k) = 10 - 5k``, floored at 0.01.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    V = adj.shape[0]
    K1 = n_tasks + 1

    link_param = np.where(
        adj,
        link_mean * rng.uniform(1 - heterogeneity, 1 + heterogeneity, (V, V)),
        0.0,
    )
    comp_param = comp_mean * rng.uniform(1 - heterogeneity, 1 + heterogeneity, V)

    if packet_sizes is None:
        packet_sizes = np.array([10.0 - 5.0 * k for k in range(K1)])
    packet_sizes = np.maximum(np.asarray(packet_sizes, dtype=np.float64), 0.01)
    L = np.tile(packet_sizes[None, :], (n_apps, 1))

    w = np.full((n_apps, K1), comp_weight, dtype=np.float64)
    w[:, -1] = 0.0                                # final stage is never computed

    r = np.zeros((n_apps, V))
    dst = np.zeros(n_apps, dtype=np.int64)
    for a in range(n_apps):
        dst[a] = rng.integers(V)
        srcs = rng.choice(V, size=min(n_sources, V), replace=False)
        r[a, srcs] = rng.uniform(rate_lo, rate_hi, size=len(srcs))

    def f32(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)

    return Instance(
        adj=torch.from_numpy(np.asarray(adj, dtype=bool)).to(dev),
        link_param=f32(link_param),
        link_kind=link_kind,
        comp_param=f32(comp_param),
        comp_kind=comp_kind,
        L=f32(L),
        w=f32(w),
        wnode=torch.ones(V, dtype=torch.float32, device=dev),
        r=f32(r),
        dst=torch.from_numpy(dst).to(dev),
        n_tasks=torch.full((n_apps,), n_tasks, dtype=torch.int64, device=dev),
        stage_mask=torch.ones((n_apps, K1), dtype=torch.bool, device=dev),
    )


# Table II scenario parameters: (topology, |A|, R, link_kind, d_mean,
#                                comp_kind, s_mean)
TABLE_II = {
    "connected-er": ("connected-er", 5, 3, QUEUE, 10.0, QUEUE, 12.0),
    "balanced-tree": ("balanced-tree", 5, 3, QUEUE, 20.0, QUEUE, 15.0),
    "fog": ("fog", 5, 3, QUEUE, 20.0, QUEUE, 17.0),
    "abilene": ("abilene", 3, 3, QUEUE, 15.0, QUEUE, 10.0),
    "lhc": ("lhc", 8, 3, QUEUE, 15.0, QUEUE, 15.0),
    "geant": ("geant", 10, 5, QUEUE, 20.0, QUEUE, 20.0),
    "sw-queue": ("sw", 30, 8, QUEUE, 20.0, QUEUE, 20.0),
    "sw-linear": ("sw", 30, 8, LINEAR, 20.0, LINEAR, 20.0),
}


def table_ii_instance(name: str, seed: int = 0, rate_scale: float = 1.0, *,
                      device: Device = "cuda") -> Instance:
    """Instantiate one of the paper's Table II simulation scenarios."""
    topo, n_apps, R, lk, dmean, ck, smean = TABLE_II[name]
    dev = resolve_device(device)
    adj = TOPOLOGIES[topo]()
    return build_instance(
        adj,
        n_apps=n_apps,
        n_tasks=2,
        n_sources=R,
        link_kind=lk,
        comp_kind=ck,
        link_mean=dmean,
        comp_mean=smean,
        rate_lo=0.5 * rate_scale,
        rate_hi=1.5 * rate_scale,
        seed=seed,
        device=dev,
    )


def metro_instance(topo: str, V: int, *, seed: int = 0,
                   device: Device = "cuda") -> Instance:
    """A metro-scale instance on a V-node sparse graph.

    ``topo`` is ``"sw"`` (scaled :func:`small_world`) or ``"geant"``
    (scaled :func:`metro_geant`).  Parameters follow the Table II sw-queue
    scenario (three applications).  The sparse topology is attached, which
    sends the solve down the factorization-free sparse route at V >= 128;
    ``without_sparse`` strips it.
    """
    if topo == "sw":
        adj = small_world(V, seed=3)
    elif topo == "geant":
        adj = metro_geant(V, seed=11)
    else:
        raise ValueError(f"unknown metro topology {topo!r} (want 'sw'/'geant')")
    inst = build_instance(
        adj, n_apps=3, n_tasks=2, n_sources=3,
        link_mean=20.0, comp_mean=20.0, seed=seed, device=device,
    )
    return with_sparse(inst)
