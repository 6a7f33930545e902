"""Bit-packed blocked-set ("tagged node") propagation.

Port of ``repro.kernels.blocked_sets``.  Category 3 of the blocked node
sets (Section IV) tags every node whose routing subtree contains an
improper link; per (app, stage) that is the monotone fixed point of

    tagged[p] = exists q: route[p, q] and (improper[p, q] or tagged[q]).

The successor axis is packed into 32-bit words, ``(B, Vp, W)`` with
``W = ceil(V / 32)`` and ``Vp = 32 W``.  Words travel as **int32** tensors
(bit ``q % 32`` of word ``q // 32``): PyTorch's uint32 has no shifts on the
CPU, and the kernel reads the same bits as uint32.

  * :func:`tagged` — the kernel wrapper (``csrc/tagged.cu`` for CUDA
    tensors, :func:`tagged_plain` for CPU tensors), packed words in and out;
  * :func:`tagged_scan_dense` — the seed's dense V-round sweep, kept as the
    differential reference of ``engine.blocked_sets(method="scan")``.

The map is monotone, so stopping when the bitset stops changing gives the
least fixed point, bit-equal to the dense sweep.
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
# tagged: kernel + plain packed version
# ---------------------------------------------------------------------------

def tagged_plain(route_bits: torch.Tensor, imp_bits: torch.Tensor) -> torch.Tensor:
    """Packed rounds until the bitset settles: (B, Vp, W) x2 -> (B, W) int32.

    One round: ``hit[p] = any_w(imp[p, w] | (route[p, w] & tb[w])) != 0``,
    re-packed into the bitset; at most Vp + 1 rounds, like the kernel.
    """
    B, Vp, W = route_bits.shape
    tb = torch.zeros((B, W), dtype=torch.int32, device=route_bits.device)
    for _ in range(Vp + 1):
        hit = imp_bits | (route_bits & tb[:, None, :])
        nb = pack_bits((hit != 0).any(dim=-1))
        if torch.equal(nb, tb):
            break
        tb = nb
    return tb


def tagged_plan(Vp: int, W: int) -> dict:
    """How :func:`tagged` launches: ``variant`` "shared" (both word
    matrices in shared memory, Vp <= 960) or "global" (read from global
    memory each round; the two bitsets in shared memory)."""
    smem = 4 * (2 * Vp * W + 2 * W)
    if smem <= _build.SMEM_LIMIT:
        return {"variant": "shared", "smem_bytes": smem}
    return {"variant": "global", "smem_bytes": 4 * 2 * W}


def tagged(route_bits: torch.Tensor, imp_bits: torch.Tensor) -> torch.Tensor:
    """Packed tagged fixed point: (B, Vp, W) int32 x2 -> (B, W) int32 words.

    CUDA tensors: one launch of ``csrc/tagged.cu``, one block per member
    (the variant of :func:`tagged_plan`).  CPU tensors: :func:`tagged_plain`.
    """
    if route_bits.device.type == "cpu":
        return tagged_plain(route_bits, imp_bits)
    for name, x in (("route_bits", route_bits), ("imp_bits", imp_bits)):
        if x.dtype != torch.int32 or x.ndim != 3 or not x.is_contiguous():
            raise ValueError(f"tagged: {name} must be a contiguous (B, Vp, W) "
                             f"int32 tensor, got {x.dtype} {tuple(x.shape)}")
    B, Vp, W = route_bits.shape
    if imp_bits.shape != route_bits.shape or imp_bits.device != route_bits.device:
        raise ValueError("tagged: route_bits and imp_bits must match")
    if Vp != W * WORD:
        raise ValueError(f"tagged: Vp={Vp} must equal 32 * W={W * WORD}")
    variant = ("shared", "global").index(tagged_plan(Vp, W)["variant"])
    out = torch.empty((B, W), dtype=torch.int32, device=route_bits.device)
    fn = _build.function("tagged", "repro_tagged",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(route_bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(route_bits.data_ptr(), imp_bits.data_ptr(), out.data_ptr(),
                B, Vp, W, variant, stream)
    _build.check("tagged", rc, "tagged")
    tagged.launches += 1
    return out


tagged.launches = 0
