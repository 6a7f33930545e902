"""Packet-level discrete-event validation of the flow model.

Port of ``repro.core.simulate``.  The paper's premise (Section II): when
D_ij and C_i are M/M/1 queue lengths, the aggregate cost D(phi) equals the
expected number of packets in the system, so by Little's law

    mean packet system delay  =  D(phi) / (total input rate).

The optimizer never simulates packets (it is flow-level); this module is
the ground-truth check: Poisson arrivals, random dispatching by phi
(footnote 2), exponential service with mean L_(a,k)/d_ij on links and
w(a,k)*wnode_i/s_i on CPUs, FIFO queues.  :func:`simulate` measures the
mean end-to-end delay and the mean number of packets in the system.

The event loop runs on the host in numpy: the instance and the strategy
are copied to numpy once, at entry, and the loop makes the reference's
``numpy.random.default_rng`` draws in the reference's order on arrays of
the reference's dtypes, so on the same strategy and seed ``n_delivered``,
``mean_delay`` and ``mean_queue_occupancy`` are the reference's exactly
on one host.  The mean delay is ``numpy.mean``, as in the reference, whose
pairwise sum may round a few ulps apart on a host with another numpy build.
Only ``predicted_delay`` comes from the port's ``traffic.total_cost`` (on
the instance's device).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np
import torch

from repro_torch.core.network import Instance
from repro_torch.core.traffic import Phi, total_cost


@dataclasses.dataclass
class SimResult:
    mean_delay: float          # mean packet system time (injection -> exit)
    n_delivered: int
    predicted_delay: float     # D(phi) / total rate (Little's law)
    mean_queue_occupancy: float


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def simulate(inst: Instance, phi: Phi, *, horizon: float = 2_000.0,
             warmup: float = 200.0, seed: int = 0,
             max_events: int = 2_000_000) -> SimResult:
    """Simulate packets through one (unstacked) instance under strategy
    ``phi`` (tensors or numpy arrays) until ``horizon``; statistics count
    the packets injected after ``warmup``."""
    if inst.batch_shape:
        raise ValueError("simulate takes one instance, not a stacked family")
    rng = np.random.default_rng(seed)
    V, A = inst.V, inst.A
    lp = _np(inst.link_param)
    cp = _np(inst.comp_param)
    L = _np(inst.L)
    w = _np(inst.w)
    wnode = _np(inst.wnode)
    r = _np(inst.r)
    dst = _np(inst.dst)
    ntask = _np(inst.n_tasks)
    phi_e = _np(phi.e)
    phi_c = _np(phi.c)

    # server state: one FIFO per link and per CPU
    link_busy_until = np.zeros((V, V))
    cpu_busy_until = np.zeros(V)

    counter = itertools.count()
    events: list = []          # (time, tiebreak, kind, payload)

    # Poisson arrivals per (a, source)
    for a in range(A):
        for i in range(V):
            if r[a, i] > 0:
                t = rng.exponential(1.0 / r[a, i])
                heapq.heappush(events, (t, next(counter), "arr", (a, i)))

    delays = []
    occupancy_area = 0.0
    in_system = 0
    last_t = warmup
    delivered = 0

    def advance(t):
        nonlocal occupancy_area, last_t
        if t > last_t:
            occupancy_area += in_system * (t - last_t)
            last_t = t

    n_events = 0
    while events and n_events < max_events:
        t, _, kind, payload = heapq.heappop(events)
        if t > horizon:
            break
        n_events += 1
        if kind == "arr":
            a, i = payload
            # next arrival of this stream
            heapq.heappush(events, (t + rng.exponential(1.0 / r[a, i]),
                                    next(counter), "arr", (a, i)))
            if t >= warmup:
                advance(t)
                in_system += 1
            heapq.heappush(events, (t, next(counter), "hop", (a, 0, i, t)))
            continue
        a, k, i, t0 = payload
        if k == ntask[a] and i == dst[a]:            # exit
            if t0 >= warmup:
                advance(t)
                in_system -= 1
                delays.append(t - t0)
                delivered += 1
            continue
        # choose a direction by phi (random dispatch, footnote 2)
        pe = phi_e[a, k, i].copy()
        pc = phi_c[a, k, i] if k < ntask[a] else 0.0
        tot = pe.sum() + pc
        if tot <= 1e-12:
            continue                                 # dead end (zero-traffic row)
        u = rng.random() * tot
        if u < pc:
            # CPU: exponential service, mean w * wnode / s per packet
            svc = rng.exponential(w[a, k] * wnode[i] / cp[i])
            done = max(t, cpu_busy_until[i]) + svc
            cpu_busy_until[i] = done
            heapq.heappush(events, (done, next(counter), "hop", (a, k + 1, i, t0)))
        else:
            j = min(int(np.searchsorted(np.cumsum(pe), u - pc)), V - 1)
            svc = rng.exponential(L[a, k] / lp[i, j]) if lp[i, j] > 0 else 0.0
            done = max(t, link_busy_until[i, j]) + svc
            link_busy_until[i, j] = done
            heapq.heappush(events, (done, next(counter), "hop", (a, k, j, t0)))

    dev = inst.device
    phi_t = Phi(e=torch.as_tensor(phi_e, device=dev), c=torch.as_tensor(phi_c, device=dev))
    D = float(total_cost(inst, phi_t))
    lam = float(r.sum())
    span = max(last_t - warmup, 1e-9)
    return SimResult(
        mean_delay=float(np.mean(delays)) if delays else float("nan"),
        n_delivered=delivered,
        predicted_delay=D / lam,
        mean_queue_occupancy=occupancy_area / span,
    )
