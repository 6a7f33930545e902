"""Typed online events over a fleet of padded instances.

Port of ``repro.core.events``.  The paper's Section IV argues that the
distributed GP algorithm adapts to changes in input rates and topology and
can run online.  This module gives that claim an event model: a small
algebra of typed events over a *fleet* of padded instances,

  * :class:`RateScale`      — an application's input rates scale
  * :class:`LinkDown` / :class:`LinkUp`   — a directed link fails / recovers
  * :class:`NodeDown`       — a node fails (its links, its local rates)
  * :class:`AppArrival` / :class:`AppDeparture` — a service chain joins /
    leaves, in the spare application slots of the padded envelope

plus :func:`apply_event`, the pure transition ``Instance -> Instance``
that also reports what the event disturbed (an :class:`EventEffect`), and
:func:`random_trace`, a feasibility-preserving trace generator.

Events name fleet members by index and touch one member each.
:func:`apply_event` never changes a shape (churn happens inside the padded
envelope: a departed application is a dead row) and never writes into the
input instance's tensors: it builds new ones, on the instance's device, so
the earlier members that :func:`replay` and a caller keep stay as they
were.  The reachability tests and the trace sampling run in numpy on the
host, with the reference's ``numpy.random.default_rng`` draws in the
reference's order, so a trace is the reference's event for event and
every member field is the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import batch
from repro_torch.core.network import Instance

# ---------------------------------------------------------------------------
# Event types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RateScale:
    """Scale application ``app``'s input rates by ``factor`` (all apps of
    the member when ``app`` is None)."""

    member: int
    factor: float
    app: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class LinkDown:
    """Directed link (i, j) fails: removed from the graph, capacity zeroed."""

    member: int
    i: int
    j: int


@dataclasses.dataclass(frozen=True)
class LinkUp:
    """Directed link (i, j) (re)appears with the given capacity/coefficient."""

    member: int
    i: int
    j: int
    capacity: float


@dataclasses.dataclass(frozen=True)
class NodeDown:
    """Node fails: every incident link removed, exogenous input at the node
    zeroed; applications destined to the node depart."""

    member: int
    node: int


@dataclasses.dataclass(frozen=True)
class AppArrival:
    """A new service chain occupies dead application slot ``app``.

    ``rates`` is a tuple of (source node, rate) pairs.  Packet sizes follow
    the ``L_(a,k) = 10 - 5k`` profile (floored at 0.01) and computation
    weights are 1 for every computed task.
    """

    member: int
    app: int
    dst: int
    rates: tuple = ()
    n_tasks: int = 2


@dataclasses.dataclass(frozen=True)
class AppDeparture:
    """Application slot ``app`` leaves: its rates and stages are cleared and
    the slot becomes a dead row."""

    member: int
    app: int


Event = Union[RateScale, LinkDown, LinkUp, NodeDown, AppArrival, AppDeparture]

# A rate change whose factor lies in this window is "small": the optimum
# moves continuously, so a solver may keep its Anderson window across it.
SMALL_RATE_WINDOW = (0.5, 2.0)


@dataclasses.dataclass(frozen=True)
class EventEffect:
    """What :func:`apply_event` disturbed, for a solver's skip gates.

    ``topology``   — the direction sets changed: the strategy needs
                     ``traffic.repair_phi`` and the Anderson window must go.
    ``small``      — a rate change inside :data:`SMALL_RATE_WINDOW`.
    ``touched``    — (A,) bool: applications whose own data changed; the
                     others are disturbed only through shared congestion,
                     which ``conditions.per_app_residual`` detects.
    ``dead_links`` — directed links the event removed (applications with
                     strategy mass on them need re-solving too).
    ``shed``       — application slots the event forcibly departed because
                     their sources can no longer reach their destination.
    """

    topology: bool
    small: bool
    touched: np.ndarray
    dead_links: tuple = ()
    shed: tuple = ()


# ---------------------------------------------------------------------------
# Event application (pure)
# ---------------------------------------------------------------------------


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _set(x: torch.Tensor, index, value) -> torch.Tensor:
    """A copy of ``x`` with ``x[index] = value`` (``x`` is not written)."""
    out = x.clone()
    out[index] = value
    return out


def _default_chain(K1: int, n_tasks: int):
    """Packet sizes / weights / stage mask of ``network.build_instance``'s
    default chain."""
    L = np.maximum(10.0 - 5.0 * np.arange(K1), 0.01)
    w = np.where(np.arange(K1) < n_tasks, 1.0, 0.0)
    mask = np.arange(K1) <= n_tasks
    return L, w, mask


def _check_index(v: int, n: int, what: str) -> None:
    """Bounds-check an event index: negative indexing would otherwise write
    somewhere else without a word."""
    if not 0 <= v < n:
        raise ValueError(f"{what} {v} out of range [0, {n})")


def _reverse_reach(adj: np.ndarray, d: int) -> np.ndarray:
    """(V,) bool: which nodes have a directed path to ``d`` (reverse BFS)."""
    seen = np.zeros(adj.shape[0], dtype=bool)
    seen[d] = True
    stack = [int(d)]
    while stack:
        v = stack.pop()
        for u in np.flatnonzero(adj[:, v] & ~seen):
            seen[u] = True
            stack.append(int(u))
    return seen


def _depart(inst: Instance, gone: np.ndarray, **extra) -> Instance:
    """``inst`` with the applications ``gone`` ((A,) bool) made dead rows."""
    g = torch.as_tensor(gone, device=inst.device)
    return dataclasses.replace(
        inst,
        r=extra.pop("r", inst.r).masked_fill(g[:, None], 0.0),
        stage_mask=inst.stage_mask.masked_fill(g[:, None], False),
        **extra)


def _shed_unreachable(inst: Instance, touched: np.ndarray):
    """Depart applications whose live sources lost every route to their
    destination: such a chain has no finite-cost strategy, so it is shed
    (a dead row) instead.  Returns (inst, touched, shed slots)."""
    adj = _np(inst.adj)
    r = _np(inst.r)
    live = _np(inst.stage_mask).any(axis=1)
    dst = _np(inst.dst)
    shed = []
    for a in np.flatnonzero(live):
        srcs = np.flatnonzero(r[a] > 0)
        if len(srcs) and not _reverse_reach(adj, int(dst[a]))[srcs].all():
            shed.append(int(a))
    if not shed:
        return inst, touched, ()
    gone = np.zeros(inst.A, dtype=bool)
    gone[shed] = True
    inst = _depart(inst, gone, n_tasks=inst.n_tasks.masked_fill(
        torch.as_tensor(gone, device=inst.device), 0))
    return inst, touched & ~gone, tuple(shed)


def apply_event(inst: Instance, ev: Event) -> tuple[Instance, EventEffect]:
    """Apply one event to a (padded, unstacked) member instance.

    Returns a new :class:`Instance` of the same shapes (the input's tensors
    are not written) and an :class:`EventEffect`.  Raises ValueError for a
    structurally invalid event (arriving into a live slot, failing a link
    that does not exist, an index out of range, ...), TypeError for an
    unknown event type.
    """
    A = inst.A
    touched = np.zeros(A, dtype=bool)
    live_apps = _np(inst.stage_mask).any(axis=1)
    f32 = inst.r.dtype

    if isinstance(ev, RateScale):
        if not (np.isfinite(ev.factor) and ev.factor > 0):
            raise ValueError(f"RateScale: factor {ev.factor} must be a "
                             "finite positive number")
        factor = torch.tensor(ev.factor, dtype=f32, device=inst.device)
        if ev.app is None:
            r = inst.r * factor
            touched[:] = live_apps
        else:
            _check_index(ev.app, A, "RateScale: app")
            if not live_apps[ev.app]:
                raise ValueError(f"RateScale: slot {ev.app} is dead")
            r = _set(inst.r, ev.app, inst.r[ev.app] * factor)
            touched[ev.app] = True
        lo, hi = SMALL_RATE_WINDOW
        return dataclasses.replace(inst, r=r), EventEffect(
            topology=False, small=lo <= ev.factor <= hi, touched=touched)

    if isinstance(ev, LinkDown):
        _check_index(ev.i, inst.V, "LinkDown: node")
        _check_index(ev.j, inst.V, "LinkDown: node")
        if not bool(inst.adj[ev.i, ev.j]):
            raise ValueError(f"LinkDown({ev.i},{ev.j}): link does not exist")
        new = dataclasses.replace(
            inst,
            adj=_set(inst.adj, (ev.i, ev.j), False),
            link_param=_set(inst.link_param, (ev.i, ev.j), 0.0),
        )
        new, touched, shed = _shed_unreachable(new, touched)
        return new, EventEffect(topology=True, small=False, touched=touched,
                                dead_links=((ev.i, ev.j),), shed=shed)

    if isinstance(ev, LinkUp):
        _check_index(ev.i, inst.V, "LinkUp: node")
        _check_index(ev.j, inst.V, "LinkUp: node")
        if bool(inst.adj[ev.i, ev.j]):
            raise ValueError(f"LinkUp({ev.i},{ev.j}): link already exists")
        if ev.i == ev.j or not np.isfinite(ev.capacity) or ev.capacity <= 0:
            raise ValueError(f"LinkUp({ev.i},{ev.j}): invalid link")
        new = dataclasses.replace(
            inst,
            adj=_set(inst.adj, (ev.i, ev.j), True),
            link_param=_set(inst.link_param, (ev.i, ev.j), ev.capacity),
        )
        # nobody's data changed; apps that should use the new link are
        # caught by the residual gate (the new direction lowers the minimum)
        return new, EventEffect(topology=True, small=False, touched=touched)

    if isinstance(ev, NodeDown):
        v = ev.node
        _check_index(v, inst.V, "NodeDown: node")
        adj_np = _np(inst.adj)
        if not (adj_np[v].any() or adj_np[:, v].any()):
            raise ValueError(f"NodeDown({v}): node already dead")
        dead = tuple((v, int(j)) for j in np.flatnonzero(adj_np[v])) + \
            tuple((int(i), v) for i in np.flatnonzero(adj_np[:, v]))
        adj = inst.adj.clone()
        adj[v, :] = False
        adj[:, v] = False
        link_param = inst.link_param.clone()
        link_param[v, :] = 0.0
        link_param[:, v] = 0.0
        r = _set(inst.r, (slice(None), v), 0.0)
        touched = _np(inst.r[:, v] > 0)
        # applications destined to the failed node depart with it
        gone = (_np(inst.dst) == v) & live_apps
        touched &= ~gone
        new = _depart(inst, gone, r=r, adj=adj, link_param=link_param)
        new, touched, shed = _shed_unreachable(new, touched)
        return new, EventEffect(topology=True, small=False, touched=touched,
                                dead_links=dead, shed=shed)

    if isinstance(ev, AppArrival):
        a = ev.app
        _check_index(a, A, "AppArrival: slot")
        _check_index(ev.dst, inst.V, "AppArrival: dst")
        if live_apps[a]:
            raise ValueError(f"AppArrival: slot {a} is live")
        if ev.n_tasks + 1 > inst.K1:
            raise ValueError(f"AppArrival: chain needs K1 >= {ev.n_tasks + 1}")
        # admission control: every source must reach the destination under
        # the current topology, else the chain has no finite-cost strategy
        reach = _reverse_reach(_np(inst.adj), ev.dst)
        L_row, w_row, mask_row = _default_chain(inst.K1, ev.n_tasks)
        r_row = np.zeros(inst.V)
        for node, rate in ev.rates:
            _check_index(node, inst.V, "AppArrival: source")
            if not (np.isfinite(rate) and rate >= 0):
                raise ValueError(f"AppArrival: rate {rate} at node {node} "
                                 "must be finite and non-negative")
            if rate > 0 and not bool(reach[node]):
                raise ValueError(f"AppArrival: source {node} cannot reach "
                                 f"dst {ev.dst} — admission rejected")
            r_row[node] = rate

        def row(x: torch.Tensor, vals) -> torch.Tensor:
            return _set(x, a, torch.as_tensor(vals, dtype=x.dtype, device=x.device))

        new = dataclasses.replace(
            inst, L=row(inst.L, L_row), w=row(inst.w, w_row), r=row(inst.r, r_row),
            dst=_set(inst.dst, a, ev.dst), n_tasks=_set(inst.n_tasks, a, ev.n_tasks),
            stage_mask=row(inst.stage_mask, mask_row),
        )
        touched[a] = True
        return new, EventEffect(topology=True, small=False, touched=touched)

    if isinstance(ev, AppDeparture):
        a = ev.app
        _check_index(a, A, "AppDeparture: slot")
        if not live_apps[a]:
            raise ValueError(f"AppDeparture: slot {a} already dead")
        new = dataclasses.replace(
            inst,
            r=_set(inst.r, a, 0.0),
            stage_mask=_set(inst.stage_mask, a, False),
            n_tasks=_set(inst.n_tasks, a, 0),
        )
        # the departed app needs no solving (renormalize zeroes its rows);
        # the survivors' relief is picked up by the residual gate
        return new, EventEffect(topology=True, small=False, touched=touched)

    raise TypeError(f"unknown event type {type(ev).__name__}")


def replay(members: Sequence[Instance], trace: Sequence[Event]):
    """Replay a trace over a member list; returns [(event, instance,
    effect)] with ``instance`` the event's member after the event."""
    members = list(members)
    out = []
    for ev in trace:
        members[ev.member], eff = apply_event(members[ev.member], ev)
        out.append((ev, members[ev.member], eff))
    return out


# ---------------------------------------------------------------------------
# Fleet construction
# ---------------------------------------------------------------------------


def pad_fleet(insts: Sequence[Instance], spare_apps: int = 0) -> list[Instance]:
    """Pad a fleet to its common envelope plus ``spare_apps`` dead
    application slots per member (room for :class:`AppArrival` events).

    Members stay separate instances with uniform shapes, so event replay
    and a solver agree on slot indices.  Dense instances only
    (``batch.pad_instance`` refuses a sparse topology).
    """
    V, A, K1 = batch.batch_envelope(insts)
    return [batch.pad_instance(i, V, A + spare_apps, K1) for i in insts]


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------


def _reaches_all_dsts(adj: np.ndarray, dsts: Sequence[int]) -> bool:
    """True iff every node with an outgoing link reaches every dst in
    ``dsts`` (reverse BFS from each destination)."""
    live = adj.any(axis=1)
    return all(bool(_reverse_reach(adj, int(d))[live].all()) for d in dsts)


def random_trace(
    members: Sequence[Instance],
    n_events: int = 50,
    seed: int = 0,
    *,
    p_rate: float = 0.5,
    p_topology: float = 0.3,
    p_app: float = 0.2,
    rate_window: tuple = (0.4, 1.6),
) -> list[Event]:
    """Sample a deterministic, feasibility-preserving event trace over an
    already padded fleet (:func:`pad_fleet`).  By replaying its own events
    while sampling it guarantees:

      * failures keep every live node connected to every live destination
        (so ``traffic.repair_phi`` always has a finite-cost fallback);
      * at least one application stays live per member;
      * per-app cumulative rate factors stay inside ``rate_window``;
      * ``LinkUp`` only restores failed links at their original capacity;
        arrivals only fill dead slots.

    Deterministic in ``seed``; an infeasible draw falls back to a
    RateScale.
    """
    rng = np.random.default_rng(seed)
    state = list(members)
    failed: list[list[tuple]] = [[] for _ in members]          # [(i, j, cap)]
    cum = [np.ones(m.A) for m in members]                      # rate factors
    orig_cap = [_np(m.link_param).copy() for m in members]

    def alive_apps(m):
        return np.flatnonzero(_np(state[m].stage_mask).any(axis=1))

    def live_nodes(m):
        return np.flatnonzero(_np(state[m].adj).any(axis=1))

    def live_dsts(m):
        dst = _np(state[m].dst)
        return [int(dst[a]) for a in alive_apps(m)]

    def commit(ev):
        state[ev.member], _ = apply_event(state[ev.member], ev)
        trace.append(ev)

    def sample_rate(m) -> Event:
        a = int(rng.choice(alive_apps(m)))
        choices = np.array([0.6, 0.8, 1.25, 1.5, 2.0])
        ok = [f for f in choices
              if rate_window[0] <= cum[m][a] * f <= rate_window[1]]
        factor = float(rng.choice(ok)) if ok else float(1.0 / cum[m][a])
        cum[m][a] *= factor
        return RateScale(member=m, factor=factor, app=a)

    def sample_link_down(m) -> Optional[Event]:
        adj = _np(state[m].adj)
        links = np.argwhere(adj)
        rng.shuffle(links)
        dsts = live_dsts(m)
        for i, j in links[:32]:
            cand = adj.copy()
            cand[i, j] = False
            if _reaches_all_dsts(cand, dsts):
                failed[m].append((int(i), int(j), float(orig_cap[m][i, j])))
                return LinkDown(member=m, i=int(i), j=int(j))
        return None

    def sample_link_up(m) -> Optional[Event]:
        if not failed[m]:
            return None
        i, j, cap = failed[m].pop(int(rng.integers(len(failed[m]))))
        return LinkUp(member=m, i=i, j=j, capacity=cap)

    def sample_node_down(m) -> Optional[Event]:
        adj = _np(state[m].adj)
        dst_set = set(live_dsts(m))
        nodes = [v for v in live_nodes(m) if v not in dst_set]
        rng.shuffle(nodes)
        for v in nodes[:16]:
            cand = adj.copy()
            cand[v, :] = False
            cand[:, v] = False
            if _reaches_all_dsts(cand, live_dsts(m)):
                # a dead node's links are not restorable one by one
                failed[m] = [(i, j, c) for i, j, c in failed[m]
                             if i != v and j != v]
                return NodeDown(member=m, node=int(v))
        return None

    def sample_app(m) -> Optional[Event]:
        dead_slots = np.flatnonzero(~_np(state[m].stage_mask).any(axis=1))
        apps = alive_apps(m)
        want_arrival = len(dead_slots) > 0 and (
            len(apps) <= 1 or rng.random() < 0.6)
        if want_arrival:
            a = int(dead_slots[0])
            nodes = live_nodes(m)
            if len(nodes) < 2:
                return None
            dst = int(rng.choice(nodes))
            n_src = min(int(rng.integers(2, 4)), len(nodes) - 1)
            srcs = rng.choice([v for v in nodes if v != dst],
                              size=n_src, replace=False)
            rates = tuple((int(s), float(rng.uniform(0.3, 0.8))) for s in srcs)
            cum[m][a] = 1.0
            return AppArrival(member=m, app=a, dst=dst, rates=rates)
        if len(apps) > 1:
            return AppDeparture(member=m, app=int(rng.choice(apps)))
        return None

    trace: list[Event] = []
    kinds = np.array([p_rate, p_topology, p_app]) / (p_rate + p_topology + p_app)
    while len(trace) < n_events:
        m = int(rng.integers(len(members)))
        kind = rng.choice(3, p=kinds)
        ev: Optional[Event] = None
        if kind == 1:
            topo = rng.random()
            if topo < 0.45:
                ev = sample_link_down(m)
            elif topo < 0.75:
                ev = sample_link_up(m)
            else:
                ev = sample_node_down(m)
        elif kind == 2:
            ev = sample_app(m)
        if ev is None:
            ev = sample_rate(m)
        commit(ev)
    return trace
