"""Blocked node sets of the dense route: the tagged-node fixed point and
the blocked mask.

Port of ``repro.kernels.blocked_sets``.  Category 3 of the blocked node
sets (Section IV) tags every node whose routing subtree contains an
improper link; per (app, stage) that is the monotone fixed point of

    tagged[p] = exists q: route[p, q] and (improper[p, q] or tagged[q]),

and the blocked mask is ``~adj | worse | tagged[q]`` (``improper`` lies
inside ``worse``).

  * :func:`blocked_dense` — the kernel wrapper: ``phi_e``, ``pdt`` and
    ``adj`` in, the ``(B, V, V)`` blocked mask out, one launch of
    ``csrc/tagged.cu`` for CUDA tensors (the bits formed on chip, no
    packed words in device memory), :func:`blocked_dense_plain` for CPU
    tensors;
  * :func:`blocked_dense_plain` — its plain version, the composition the
    kernel replaces: route, worse and improper as V x V tensors, both
    packed into 32-bit words (:func:`pack_bits`), the packed rounds
    (:func:`tagged_plain`), :func:`unpack_bits` and the four-term OR;
  * :func:`tagged_scan_dense` — the seed's dense V-round sweep, kept as the
    differential reference of ``engine.blocked_sets(method="scan")``.

Packed words are ``(B, Vp, W)`` with ``W = ceil(V / 32)`` and
``Vp = 32 W``, carried as **int32** tensors (bit ``q % 32`` of word
``q // 32``): PyTorch's uint32 has no shifts on the CPU.  The map is
monotone, so stopping when the bitset stops changing gives the least fixed
point, bit-equal to the dense sweep.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

WORD = 32  # bits per packed word


def padded_nodes(V: int) -> tuple[int, int]:
    """(Vp, W): node count padded to a word multiple, and the word count."""
    W = -(-V // WORD)
    return W * WORD, W


def _bit_weights(device) -> torch.Tensor:
    return torch.ones(WORD, dtype=torch.int64, device=device) << torch.arange(
        WORD, dtype=torch.int64, device=device)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack a bool tensor along its last axis: (..., V) -> (..., W) int32.

    Bit ``q % 32`` of word ``q // 32`` is ``x[..., q]``; the pad tail is 0.
    The words are the reference's uint32 words reinterpreted as int32.
    """
    V = x.shape[-1]
    Vp, W = padded_nodes(V)
    if Vp != V:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (Vp - V,))], dim=-1)
    xw = x.reshape(x.shape[:-1] + (W, WORD)).to(torch.int64)
    words = (xw * _bit_weights(x.device)).sum(-1)           # in [0, 2^32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_bits(w: torch.Tensor, V: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., W) int32 -> (..., V) bool."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=w.device)
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(w.shape[:-1] + (w.shape[-1] * WORD,))[..., :V] != 0


# ---------------------------------------------------------------------------
# Reference: the seed's dense V-round boolean sweep
# ---------------------------------------------------------------------------

def tagged_scan_dense(route: torch.Tensor, improper: torch.Tensor) -> torch.Tensor:
    """Dense fixed point by V unconditional sweeps: (..., V, V) -> (..., V)."""
    V = route.shape[-1]
    tagged = torch.zeros(route.shape[:-1], dtype=torch.bool, device=route.device)
    for _ in range(V):
        tagged = (improper | (route & tagged[..., None, :])).any(dim=-1)
    return tagged


# ---------------------------------------------------------------------------
# The plain version: packed rounds and the composition around them
# ---------------------------------------------------------------------------

def tagged_plain(route_bits: torch.Tensor, imp_bits: torch.Tensor, *,
                 with_rounds: bool = False):
    """Packed rounds until the bitset settles: (B, Vp, W) x2 -> (B, W) int32.

    One round: ``hit[p] = any_w(imp[p, w] | (route[p, w] & tb[w])) != 0``,
    re-packed into the bitset; at most Vp + 1 rounds.  ``with_rounds=True``
    also returns each row's (B,) int32 round count: the rounds from the
    empty bitset up to and with the one that changed nothing (the seed is
    round 1), the reference's packed loop's counter for that row alone.
    """
    B, Vp, W = route_bits.shape
    tb = torch.zeros((B, W), dtype=torch.int32, device=route_bits.device)
    rounds = torch.zeros(B, dtype=torch.int32, device=route_bits.device)
    live = torch.ones(B, dtype=torch.bool, device=route_bits.device)
    for _ in range(Vp + 1):
        hit = imp_bits | (route_bits & tb[:, None, :])
        nb = pack_bits((hit != 0).any(dim=-1))
        if with_rounds:
            rounds += live.to(torch.int32)
            live = live & (nb != tb).any(dim=-1)
        if torch.equal(nb, tb):
            break
        tb = nb
    return (tb, rounds) if with_rounds else tb


def tagged_flags_plain(route: torch.Tensor, improper: torch.Tensor, *,
                       with_rounds: bool = False):
    """Tagged flags through the packed rounds: route, improper (B, V, V)
    bool -> (B, V) bool (rows padded to Vp with zero words), and with
    ``with_rounds`` the (B,) round counts of :func:`tagged_plain`."""
    V = route.shape[-1]
    Vp, _ = padded_nodes(V)

    def packed(x):
        bits = pack_bits(x)                                      # (B, V, W)
        pad = bits.new_zeros((bits.shape[0], Vp - V, bits.shape[2]))
        return torch.cat([bits, pad], dim=1).contiguous()        # (B, Vp, W)

    tb = tagged_plain(packed(route), packed(improper), with_rounds=with_rounds)
    if with_rounds:
        return unpack_bits(tb[0], V), tb[1]
    return unpack_bits(tb, V)


def blocked_dense_plain(phi_e: torch.Tensor, pdt: torch.Tensor, adj: torch.Tensor, *,
                        eps: float, with_tagged: bool = False, with_rounds: bool = False):
    """The blocked mask the way the port computed it before the kernel:
    phi_e (B, V, V), pdt (B, V), adj (M, V, V) with M dividing B (row batch
    b belongs to member b // (B // M)) -> (B, V, V) bool,

        ~adj | improper | worse | tagged[q],
        worse[p, q] = pdt[q] > pdt[p] + eps,  improper = (phi_e > 0) & worse.

    ``with_tagged=True`` also returns the (B, V) tagged flags,
    ``with_rounds=True`` the (B,) int32 round counts (after the flags where
    both are asked).
    """
    B, V = pdt.shape
    M = adj.shape[0]
    route = phi_e > 0.0
    worse = pdt[:, None, :] > pdt[:, :, None] + eps              # pdt_q > pdt_p
    improper = route & worse
    tagged, rounds = tagged_flags_plain(route, improper, with_rounds=True)
    blocked = ((~adj[:, None]) | (improper | worse | tagged[:, None, :]).reshape(
        M, B // M, V, V)).reshape(B, V, V)
    out = (blocked,) + ((tagged,) if with_tagged else ()) + ((rounds,) if with_rounds else ())
    return out if len(out) > 1 else blocked


# ---------------------------------------------------------------------------
# blocked_dense: the kernel wrapper
# ---------------------------------------------------------------------------

TAGGED_MAX_CLUSTER = 16
TAGGED_THREADS = 512
# node counts one CTA takes alone (four bitset words)
TAGGED_CTA_NODES = 128


def cluster_for(V: int) -> int:
    """CTAs a row batch of the blocked-set kernels: one up to V = 128, else
    the least power of two with a CTA for each 32-row word of the bitset, at
    most 16."""
    W = -(-V // WORD)
    if V <= TAGGED_CTA_NODES:
        return 1
    return min(TAGGED_MAX_CLUSTER, 1 << (W - 1).bit_length())


def blocked_dense_plan(V: int) -> dict:
    """How :func:`blocked_dense` launches at V nodes: ``cluster`` CTAs a
    row batch (:func:`cluster_for`), ``words`` bitset words (32 rows each) a
    CTA, and the shared memory a CTA takes (pdt padded to 16 bytes, route
    and worse words of its rows, the seed, the two bitsets, two stamps)."""
    W = -(-V // WORD)
    c = cluster_for(V)
    wr = -(-W // c)
    plan = {"cluster": c, "words": wr, "threads": TAGGED_THREADS,
            "smem_bytes": 4 * (-(-V // 4) * 4 + 2 * W * WORD * wr + wr + 2 * W + 2)}
    if plan["smem_bytes"] > _build.SMEM_LIMIT:
        raise ValueError(f"blocked_dense: V={V} needs {plan['smem_bytes']} B of shared "
                         f"memory per CTA, above {_build.SMEM_LIMIT} B")
    return plan


def check_inputs(name: str, phi_e, pdt, adj) -> tuple[int, int, int]:
    """(B, V, per) of a kernel call, after checking what the kernel takes."""
    for what, x, dtype, ndim in (("phi_e", phi_e, torch.float32, 3),
                                 ("pdt", pdt, torch.float32, 2),
                                 ("adj", adj, torch.bool, 3)):
        if x.dtype != dtype or x.ndim != ndim or not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {ndim}-dim {dtype} "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
        if x.device != phi_e.device:
            raise ValueError(f"{name}: all inputs must be on one device")
    B, V, V2 = phi_e.shape
    M = adj.shape[0]
    if V != V2 or pdt.shape != (B, V) or adj.shape[1:] != (V, V) or M < 1 or B % M:
        raise ValueError(f"{name}: shapes phi_e {tuple(phi_e.shape)}, pdt "
                         f"{tuple(pdt.shape)}, adj {tuple(adj.shape)} do not agree")
    return B, V, B // M


def blocked_dense(phi_e: torch.Tensor, pdt: torch.Tensor, adj: torch.Tensor, *,
                  eps: float, with_tagged: bool = False, with_rounds: bool = False):
    """The dense route's blocked mask: phi_e (B, V, V) float32, pdt (B, V)
    float32, adj (M, V, V) bool -> (B, V, V) bool (and the (B, V) tagged
    flags with ``with_tagged``, the (B,) int32 round counts with
    ``with_rounds``, the kernel's own count), as :func:`blocked_dense_plain`.

    CUDA tensors: one launch of ``csrc/tagged.cu`` (the plan of
    :func:`blocked_dense_plan`).  CPU tensors: :func:`blocked_dense_plain`.
    """
    if phi_e.device.type == "cpu":
        return blocked_dense_plain(phi_e, pdt, adj, eps=eps, with_tagged=with_tagged,
                                   with_rounds=with_rounds)
    B, V, per = check_inputs("blocked_dense", phi_e, pdt, adj)
    plan = blocked_dense_plan(V)
    out = torch.empty((B, V, V), dtype=torch.bool, device=phi_e.device)
    tagged = (torch.empty((B, V), dtype=torch.bool, device=phi_e.device)
              if with_tagged else None)
    rounds = (torch.empty((B,), dtype=torch.int32, device=phi_e.device)
              if with_rounds else None)
    vec = int(V % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in (phi_e, out, adj)))
    fn = _build.function("tagged", "repro_tagged_dense",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(phi_e.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(phi_e.data_ptr(), pdt.data_ptr(), adj.data_ptr(), out.data_ptr(),
                tagged.data_ptr() if with_tagged else None,
                rounds.data_ptr() if with_rounds else None, B, V, per, plan["cluster"],
                plan["words"], eps, vec, stream)
    _build.check("tagged", rc, "blocked_dense")
    blocked_dense.launches += 1
    res = (out,) + ((tagged,) if with_tagged else ()) + ((rounds,) if with_rounds else ())
    return res if len(res) > 1 else out


blocked_dense.launches = 0
