"""Sparse stage-system solves and the neighbor-list tagged sweep.

Port of ``repro.kernels.sparse_solve``.  For a loop-free strategy the
stage matrix ``M = Phi_k`` (trans=0) or ``Phi_k^T`` (trans=1) restricted
to its support is nilpotent (routing follows a DAG), so the fixed-point
sweep

    x <- b + M x

settles EXACTLY after (DAG depth + 1) sweeps, and the ``x != prev`` exit
stops precisely at the solution of ``(I - M) x = b``.  Loopy ladder
candidates make it diverge: values past 1e12 (or non-finite) latch at
+inf, and ``traffic_is_valid`` rejects the member.  No stage is factored.

  * :func:`block_values` gathers the nonzero 32 x 32 blocks of a stage
    matrix stack (the BSR layout of ``network.block_neighbors``);
  * :func:`chain_solve_bsr` walks every member's K stages by blocked sweeps:
    ``csrc/bsr_chain.cu`` (one thread-block cluster per member, reading the
    blocks of ``phi_e`` itself) for CUDA tensors, :func:`block_values` and
    :func:`chain_solve_bsr_plain` for CPU tensors;
  * :func:`blocked_nbr` is the blocked mask of the sparse route, its
    category-3 fixed point on the padded out-neighbor lists:
    ``csrc/tagged_nbr.cu`` for CUDA tensors (one launch: the route and seed
    bits read from ``phi_e`` at the listed edges, the fixed point, the
    mask), :func:`blocked_nbr_plain` for CPU tensors (the V x V
    composition with the neighbor-list sweep :func:`tagged_nbr_plain`).

**Per-member lists.**  A stacked family whose members' topologies differ
(``batch.pad_instances`` over sparse members) carries one list a member:
``blk_nbr``/``blk_mask`` ``(L, NB, BD)`` and ``nbr``/``mask`` ``(L, V, D)``,
the batch's rows grouped L ways, the rows of one member consecutive
(:func:`member_rows`).  Both kernels then read each member's own list (a
member stride); one list ``(NB, BD)`` / ``(V, D)`` is the launch with stride
0, instruction for instruction the single-list launch.

One sweep sums in a fixed order that the kernel and the plain version
share: per 32 x 32 block, the 32 products of a row are rounded one by one
and summed by the same pairwise tree (halves, then quarters, ...), and the
block sums are added to ``b`` in the order of the block list, every
operation rounded once (no fused multiply-add).  So the two agree bit for
bit and stop after the same number of sweeps, and the sweep count is a
function of the data, not of the device.

``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import blocked_sets as _bset

# Edge length of the partition blocks (re-exported by ``network``); equal to
# the warp width, so one lane owns one row of a block.
SPARSE_BLOCK = 32

# Iterates beyond this magnitude are frozen at +inf: the member has
# diverged (every physical traffic or marginal is orders smaller), and
# freezing makes the sweep loop exit instead of running to the cap.
_DIVERGE = 1e12


def member_rows(lists: torch.Tensor, B: int) -> torch.Tensor:
    """The list of each of B batch rows: ``lists`` (n, m) shared by every
    row -> a (B, n, m) view; ``lists`` (L, n, m), one a member, L dividing
    B -> (B, n, m), member ``b // (B // L)``'s list for row ``b``."""
    if lists.ndim == 2:
        return lists.expand((B,) + lists.shape)
    L = lists.shape[0]
    if L < 1 or B % L:
        raise ValueError(f"{L} per-member lists do not divide {B} batch rows")
    return lists.repeat_interleave(B // L, dim=0)


def block_values(M: torch.Tensor, blk_nbr: torch.Tensor,
                 blk_mask: torch.Tensor) -> torch.Tensor:
    """Gather the nonzero 32 x 32 blocks of a stage matrix stack.

    M (..., V, V), blk_nbr/blk_mask (NB, BD) -> bvals (..., NB, BD, bs, bs)
    with ``bvals[..., I, d] = M[rows of I, cols of blk_nbr[I, d]]`` (zero
    where masked), bs = SPARSE_BLOCK.  V is zero-padded to NB * bs.  With
    per-member lists (L, NB, BD), L dividing M's first dim, each row of that
    dim gathers by its member's list (:func:`member_rows`).
    """
    NB, BD = blk_nbr.shape[-2:]
    bs = SPARSE_BLOCK
    V = M.shape[-1]
    Vp = NB * bs
    if Vp != V:
        M = F.pad(M, (0, Vp - V, 0, Vp - V))
    Mb = M.reshape(M.shape[:-2] + (NB, bs, NB, bs)).transpose(-3, -2)
    rows = torch.arange(NB, device=M.device)[:, None]
    if blk_nbr.ndim == 2:
        bvals = Mb[..., rows, blk_nbr, :, :]              # (..., NB, BD, bs, bs)
        return torch.where(blk_mask[:, :, None, None], bvals, 0.0)
    B = M.shape[0]
    nbr, mask = member_rows(blk_nbr, B), member_rows(blk_mask, B)     # (B, NB, BD)
    Mf = Mb.reshape((B, -1, NB, NB, bs, bs)).permute(0, 2, 3, 1, 4, 5)
    bvals = Mf[torch.arange(B, device=M.device)[:, None, None], rows[None], nbr]
    bvals = torch.where(mask[..., None, None, None], bvals, 0.0)  # (B, NB, BD, P, bs, bs)
    return bvals.permute(0, 3, 1, 2, 4, 5).reshape(M.shape[:-2] + (NB, BD, bs, bs))


# ---------------------------------------------------------------------------
# chain_solve_bsr: kernel + plain version
# ---------------------------------------------------------------------------

def _tree_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (a power of two) by halves, as the kernel does."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def _bsr_sweep(bvals_k, blk_nbr, b, x):
    """y = b + sum_d bvals[I, d] @ x[block blk_nbr[I, d]], then the latch.

    bvals_k (B, NB, BD, bs, bs), blk_nbr (NB, BD) or per-member (L, NB, BD),
    b/x (B, Vp) -> y (B, Vp).
    """
    B, NB, BD, bs, _ = bvals_k.shape
    xg = x.reshape(B, NB, bs)[torch.arange(B, device=x.device)[:, None, None],
                              member_rows(blk_nbr, B)]    # (B, NB, BD, bs)
    s = _tree_sum(bvals_k * xg[:, :, :, None, :])         # (B, NB, BD, bs)
    y = b.reshape(B, NB, bs)
    for d in range(BD):
        y = y + s[:, :, d]
    y = y.reshape(B, NB * bs)
    bad = ~torch.isfinite(y) | (y.abs() > _DIVERGE)
    return torch.where(bad, torch.inf, y)


def chain_solve_bsr_plain(bvals: torch.Tensor, blk_nbr: torch.Tensor,
                          base: torch.Tensor, mult: torch.Tensor, *,
                          reverse: bool = False, clamp: bool = False,
                          with_sweeps: bool = False):
    """Plain blocked chain solve: the reference's loop, in PyTorch.

    bvals (B, K, NB, BD, bs, bs), blk_nbr (NB, BD) or per-member (L, NB, BD)
    (:func:`member_rows`), base/mult (B, K, V) -> x (B, K, V) (and the
    (B, K) int32 sweep counts with ``with_sweeps``).
    Per stage: the first sweep from 0 against ``prev = inf``, then sweeps
    until no entry changed or ``V + 2`` sweeps ran; every member sweeps
    until the last one settles (a settled member stays settled), and the
    exit test is read on the host once per sweep.
    """
    B, K, NB, BD, bs = bvals.shape[:5]
    V = base.shape[-1]
    Vp = NB * bs
    cap = V + 2
    base = F.pad(base, (0, Vp - V))
    mult = F.pad(mult, (0, Vp - V))
    dev = base.device
    out = torch.empty((B, K, Vp), dtype=torch.float32, device=dev)
    sweeps = torch.zeros((B, K), dtype=torch.int32, device=dev)
    x = torch.zeros((B, Vp), dtype=torch.float32, device=dev)
    for k in (range(K - 1, -1, -1) if reverse else range(K)):
        b = base[:, k] + mult[:, k] * x
        x = _bsr_sweep(bvals[:, k], blk_nbr, b, torch.zeros_like(b))
        live = (x != torch.inf).any(dim=-1)
        sweeps[:, k] = 1
        i = 1
        while i < cap and bool(live.any()):
            y = _bsr_sweep(bvals[:, k], blk_nbr, b, x)
            sweeps[:, k] += live.to(torch.int32)
            live = live & (y != x).any(dim=-1)
            x = y
            i += 1
        if clamp:
            x = torch.maximum(x, x.new_zeros(()))
        out[:, k] = x
    out = out[..., :V]
    return (out, sweeps) if with_sweeps else out


# bsr_chain's launch: one thread-block cluster per member (csrc/bsr_chain.cu)
BSR_THREADS = 256
BSR_MAX_CLUSTER = 16


def bsr_chain_plan(NB: int, BD: int) -> dict:
    """How :func:`chain_solve_bsr` launches for NB block rows of BD blocks:
    one cluster of ``cluster`` CTAs per member, ``rows`` = ceil(NB / 16)
    block rows a CTA (the cluster the power of two at or above
    ceil(NB / rows)); ``variant`` "shared" (a CTA's rows x BD blocks in its
    shared memory, 32 x 33 floats each, loaded once a stage) or "stream"
    (read from global memory every sweep) where they do not fit."""
    rows = -(-NB // BSR_MAX_CLUSTER)
    cluster = 1 << max(0, (-(-NB // rows) - 1).bit_length())

    def floats(stream):
        return ((0 if stream else rows * BD * SPARSE_BLOCK * (SPARSE_BLOCK + 1))
                + 2 * NB * SPARSE_BLOCK + rows * SPARSE_BLOCK + rows * BD * SPARSE_BLOCK
                + 2 * BSR_MAX_CLUSTER + 2 * rows * BD)

    stream = 4 * floats(False) > _build.SMEM_LIMIT
    plan = {"variant": "stream" if stream else "shared", "cluster": cluster, "rows": rows,
            "threads": BSR_THREADS, "smem_bytes": 4 * floats(stream)}
    if plan["smem_bytes"] > _build.SMEM_LIMIT:
        raise ValueError(f"chain_solve_bsr: NB={NB}, BD={BD} needs {plan['smem_bytes']} B "
                         f"of shared memory per CTA, above {_build.SMEM_LIMIT} B")
    return plan


def _check_cuda(x: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if x.dtype != dtype or x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-dim {dtype} tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")


def chain_solve_bsr(phi_e: torch.Tensor, blk_nbr: torch.Tensor,
                    blk_mask: torch.Tensor, base: torch.Tensor, mult: torch.Tensor, *,
                    trans: int = 0, reverse: bool = False, clamp: bool = False,
                    with_sweeps: bool = False):
    """Blocked-sparse fused chain solve: phi_e (B, K, V, V), the block lists
    blk_nbr/blk_mask (NB, BD) or one a member (L, NB, BD), L dividing B (the
    rows of a member consecutive), base/mult (B, K, V) -> x (B, K, V), walking
    k forward (or backward with ``reverse``):

        x_k = (I - M_k)^{-1} (base_k + mult_k * x_prev),   x_prev(start) = 0,
        M_k = Phi_k (trans=0) or Phi_k^T (trans=1),

    optionally clamped at 0.  CUDA tensors: one launch of
    ``csrc/bsr_chain.cu`` (:func:`bsr_chain_plan`), which reads the unmasked
    32 x 32 blocks of ``phi_e`` itself.  CPU tensors: :func:`block_values`
    and the plain version.  ``with_sweeps=True`` also returns the (B, K) int32 sweep
    counts.
    """
    if phi_e.device.type == "cpu":
        M = phi_e.transpose(-1, -2) if trans else phi_e
        return chain_solve_bsr_plain(block_values(M, blk_nbr, blk_mask), blk_nbr, base,
                                     mult, reverse=reverse, clamp=clamp,
                                     with_sweeps=with_sweeps)
    _check_cuda(phi_e, "chain_solve_bsr phi_e", torch.float32, 4)
    _check_cuda(blk_nbr, "chain_solve_bsr blk_nbr", torch.int64, blk_nbr.ndim)
    _check_cuda(blk_mask, "chain_solve_bsr blk_mask", torch.bool, blk_nbr.ndim)
    _check_cuda(base, "chain_solve_bsr base", torch.float32, 3)
    _check_cuda(mult, "chain_solve_bsr mult", torch.float32, 3)
    B, K, V, V2 = phi_e.shape
    NB, BD = blk_nbr.shape[-2:]
    L = blk_nbr.shape[0] if blk_nbr.ndim == 3 else 1
    if blk_nbr.ndim not in (2, 3) or V != V2 or blk_mask.shape != blk_nbr.shape \
            or base.shape != (B, K, V) or mult.shape != (B, K, V) or L < 1 or B % L \
            or not (NB - 1) * SPARSE_BLOCK < V <= NB * SPARSE_BLOCK:
        raise ValueError(
            f"chain_solve_bsr: shapes phi_e {tuple(phi_e.shape)}, blk_nbr "
            f"{tuple(blk_nbr.shape)}, blk_mask {tuple(blk_mask.shape)}, base "
            f"{tuple(base.shape)}, mult {tuple(mult.shape)} do not agree")
    if any(t.device != phi_e.device for t in (blk_nbr, blk_mask, base, mult)):
        raise ValueError("chain_solve_bsr: all inputs must be on one device")
    plan = bsr_chain_plan(NB, BD)
    out = torch.empty_like(base)
    sweeps = torch.empty((B, K), dtype=torch.int32, device=base.device)
    fn = _build.function("bsr_chain", "repro_bsr_chain",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    with torch.cuda.device(phi_e.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(phi_e.data_ptr(), blk_nbr.data_ptr(), blk_mask.data_ptr(), base.data_ptr(),
                mult.data_ptr(), out.data_ptr(), sweeps.data_ptr(), B, K, NB, BD, V,
                plan["cluster"], plan["rows"], int(plan["variant"] == "stream"),
                int(reverse) | (int(clamp) << 1) | (int(bool(trans)) << 2), B // L,
                NB * BD if blk_nbr.ndim == 3 else 0, stream)
    _build.check("bsr_chain", rc, "chain_solve_bsr")
    chain_solve_bsr.launches += 1
    return (out, sweeps) if with_sweeps else out


chain_solve_bsr.launches = 0


# ---------------------------------------------------------------------------
# blocked_nbr: kernel + plain version
# ---------------------------------------------------------------------------

def tagged_nbr_plain(route_vals: torch.Tensor, improper_vals: torch.Tensor,
                     nbr: torch.Tensor, *, with_rounds: bool = False):
    """Plain neighbor-list tagged sweep: the reference's loop, in PyTorch.

    route_vals/improper_vals (B, V, D) bool (``route``/``improper`` gathered
    onto the padded out-neighbor lists, masked columns False), nbr (V, D)
    or one a member (L, V, D) (:func:`member_rows`) -> tagged (B, V) bool,
    the monotone fixed point of

        tagged[p] = exists d: route[p, d] and (improper[p, d] or
                                               tagged[nbr[p, d]])

    from ``tagged = seed`` in at most V + 1 rounds (the exit test read on
    the host each round).  ``with_rounds=True`` also returns the (B,) int32
    round counts, the seed counted as round 1.
    """
    B, V, D = route_vals.shape
    succ = member_rows(nbr, B).reshape(B, V * D)
    seed = (route_vals & improper_vals).any(dim=-1)
    t = seed
    live = seed.any(dim=-1)
    rounds = torch.ones(seed.shape[0], dtype=torch.int32, device=seed.device)
    i = 1
    while i < V + 1 and bool(live.any()):
        hit = seed | (route_vals & torch.gather(t, 1, succ).reshape(B, V, D)).any(dim=-1)
        rounds += live.to(torch.int32)
        live = live & (hit != t).any(dim=-1)
        t = hit
        i += 1
    return (t, rounds) if with_rounds else t


def gathered(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(B, V, V) -> (B, V, D): ``x[b, p, nbr[p, d]]`` (nbr (V, D), or one a
    member (L, V, D): row b's member's)."""
    return torch.gather(x, -1, member_rows(nbr, x.shape[0]))


def blocked_nbr_plain(phi_e: torch.Tensor, pdt: torch.Tensor, adj: torch.Tensor,
                      nbr: torch.Tensor, mask: torch.Tensor, *, eps: float,
                      with_rounds: bool = False):
    """The sparse route's blocked mask the way the port computed it before
    the kernel: phi_e (B, V, V), pdt (B, V), adj (M, V, V) with M dividing
    B, the out-neighbor lists nbr/mask (V, D), or one pair a member (M, V,
    D) -> (B, V, V) bool,

        ~adj | improper | worse | tagged[q],

    ``tagged`` by :func:`tagged_nbr_plain` on route and improper gathered
    onto the lists.  ``with_rounds=True`` also returns the (B, V) tagged
    flags and the (B,) int32 round counts.
    """
    B, V = pdt.shape
    M = adj.shape[0]
    route = phi_e > 0.0
    worse = pdt[:, None, :] > pdt[:, :, None] + eps              # pdt_q > pdt_p
    improper = route & worse
    if nbr.ndim == 3 and nbr.shape[0] != M:
        raise ValueError(f"blocked_nbr_plain: {nbr.shape[0]} neighbor lists for {M} members")
    tagged, rounds = tagged_nbr_plain(gathered(route, nbr) & member_rows(mask, B),
                                      gathered(improper, nbr), nbr, with_rounds=True)
    blocked = ((~adj[:, None]) | (improper | worse | tagged[:, None, :]).reshape(
        M, B // M, V, V)).reshape(B, V, V)
    return (blocked, tagged, rounds) if with_rounds else blocked


def blocked_nbr_plan(V: int, D: int) -> dict:
    """How :func:`blocked_nbr` launches at V nodes and pad width D:
    ``cluster`` CTAs a row batch (``blocked_sets.cluster_for``), ``words``
    bitset words (32 rows each) a CTA, and the shared memory a CTA takes
    (pdt padded to 16 bytes, route bits and neighbor lists of its rows, the
    seed, the two bitsets, two stamps)."""
    W = -(-V // _bset.WORD)
    c = _bset.cluster_for(V)
    wr = -(-W // c)
    plan = {"cluster": c, "words": wr, "threads": _bset.TAGGED_THREADS,
            "smem_bytes": 4 * (-(-V // 4) * 4 + 32 * wr * (-(-D // 32) + D) + wr + 2 * W + 2)}
    if plan["smem_bytes"] > _build.SMEM_LIMIT:
        raise ValueError(f"blocked_nbr: V={V}, D={D} needs {plan['smem_bytes']} B of "
                         f"shared memory per CTA, above {_build.SMEM_LIMIT} B")
    return plan


def blocked_nbr(phi_e: torch.Tensor, pdt: torch.Tensor, adj: torch.Tensor,
                nbr: torch.Tensor, mask: torch.Tensor, *, eps: float,
                with_rounds: bool = False):
    """The sparse route's blocked mask: phi_e (B, V, V) float32, pdt (B, V)
    float32, adj (M, V, V) bool, nbr (V, D) int64, mask (V, D) bool (or one
    pair a member, (M, V, D) each) ->
    (B, V, V) bool (and the tagged flags and round counts with
    ``with_rounds``), as :func:`blocked_nbr_plain`.

    CUDA tensors: one launch of ``csrc/tagged_nbr.cu`` (the plan of
    :func:`blocked_nbr_plan`).  CPU tensors: :func:`blocked_nbr_plain`.
    """
    if phi_e.device.type == "cpu":
        return blocked_nbr_plain(phi_e, pdt, adj, nbr, mask, eps=eps,
                                 with_rounds=with_rounds)
    B, V, per = _bset.check_inputs("blocked_nbr", phi_e, pdt, adj)
    _check_cuda(nbr, "blocked_nbr nbr", torch.int64, nbr.ndim)
    _check_cuda(mask, "blocked_nbr mask", torch.bool, nbr.ndim)
    D = nbr.shape[-1]
    if nbr.ndim not in (2, 3) or nbr.shape[-2] != V or mask.shape != nbr.shape or D < 1 \
            or (nbr.ndim == 3 and nbr.shape[0] != adj.shape[0]):
        raise ValueError(f"blocked_nbr: nbr {tuple(nbr.shape)}, mask {tuple(mask.shape)} "
                         f"do not fit V={V}")
    if nbr.device != phi_e.device or mask.device != phi_e.device:
        raise ValueError("blocked_nbr: all inputs must be on one device")
    plan = blocked_nbr_plan(V, D)
    out = torch.empty((B, V, V), dtype=torch.bool, device=phi_e.device)
    tagged = (torch.empty((B, V), dtype=torch.bool, device=phi_e.device)
              if with_rounds else None)
    rounds = (torch.empty((B,), dtype=torch.int32, device=phi_e.device)
              if with_rounds else None)
    vec = int(V % 4 == 0 and out.data_ptr() % 16 == 0 and adj.data_ptr() % 16 == 0)
    fn = _build.function("tagged_nbr", "repro_tagged_nbr",
                         [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(phi_e.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(phi_e.data_ptr(), pdt.data_ptr(), adj.data_ptr(), nbr.data_ptr(),
                mask.data_ptr(), out.data_ptr(), tagged.data_ptr() if with_rounds else None,
                rounds.data_ptr() if with_rounds else None, B, V, D, per, plan["cluster"],
                plan["words"], eps, vec, V * D if nbr.ndim == 3 else 0, stream)
    _build.check("tagged_nbr", rc, "blocked_nbr")
    blocked_nbr.launches += 1
    return (out, tagged, rounds) if with_rounds else out


blocked_nbr.launches = 0
