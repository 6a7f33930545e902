"""Public wrappers around the kernels, over any leading batch dims.

Port of ``repro.kernels.ops``: the batched-LU, propagation, sparse,
blocked-set, attention and SSD wrappers.  The blocked sets are one launch
a GP step on either route: :func:`blocked_set` (dense route) and
:func:`blocked_set_nbr` (sparse route) take ``phi_e``, ``pdt`` and ``adj``
and return the whole blocked mask.
Leading dims are flattened into the kernel's batch and restored on return,
so the GP engine hands over ``(A, K1, V, V)`` stacks for the iterate and
``(ladder, A, K1, V, V)`` stacks for the stepsize ladder alike, each in ONE
launch.  Every wrapper is per-member: no wrapper reduces across members.

The factors are unpivoted (identity permutation), so :class:`BatchedLU`
carries the packed ``lu`` and the per-member ``ok`` flag only.  The sparse
route (:func:`sparse_chain_solve`, :func:`blocked_set_nbr`) factors
nothing: the instance's block lists take the factors' place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import batched_solve as _bs
from repro_torch.kernels import blocked_sets as _bset
from repro_torch.kernels import chain_propagate as _cp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import sparse_solve as _ss
from repro_torch.kernels import ssd_chunk as _sc

# The kernel wrappers whose ``launches`` counters record the main path.
KERNELS = {
    "lu_factor": _bs.lu_factor,
    "chain_solve": _bs.chain_solve,
    "lu_solve": _bs.lu_solve,
    "tagged": _bset.blocked_dense,
    "bsr_chain": _ss.chain_solve_bsr,
    "tagged_nbr": _ss.blocked_nbr,
    "propagate_step": _cp.propagate_step,
    "flash_attention": _fa.flash_attention_fwd,
    "ssd_chunk": _sc.ssd_chunk_fwd,
}


def launch_counts() -> dict:
    """{kernel name: CUDA launches counted since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


class BatchedLU(NamedTuple):
    """Packed LU factors of a batch of stage systems.

    lu: (..., V, V) packed L\\U (unit diagonal of L implicit), unpivoted
    ok: (...,) bool per-member condition flag (False: singular or
        non-finite factor; the member's solves carry inf/nan)
    """

    lu: torch.Tensor
    ok: torch.Tensor


def batched_factor(mats: torch.Tensor) -> BatchedLU:
    """Factor a batch of dense systems: mats (..., V, V) -> BatchedLU."""
    lead, V = mats.shape[:-2], mats.shape[-1]
    lu, ok = _bs.lu_factor(mats.reshape(-1, V, V).contiguous(), with_ok=True)
    return BatchedLU(lu=lu.reshape(lead + (V, V)), ok=ok.reshape(lead))


def batched_solve_factored(fact: BatchedLU, rhs: torch.Tensor, *,
                           trans: int = 0) -> torch.Tensor:
    """Solve A x = rhs (trans=0) or A^T x = rhs (trans=1) from factors:
    fact.lu (..., V, V), rhs (..., V) -> (..., V), every member in one
    ``lu_solve`` launch.  The factors' permutation is the identity."""
    V = rhs.shape[-1]
    x = _bs.lu_solve(fact.lu.reshape(-1, V, V).contiguous(),
                     rhs.reshape(-1, V).to(torch.float32).contiguous(), trans=trans)
    return x.reshape(rhs.shape)


def batched_solve(mats: torch.Tensor, rhs: torch.Tensor, *,
                  trans: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot factor and solve with per-member residual flags.

    Returns ``(x (..., V), resid (...,))``, resid the relative residual
    ``|A x - b|_inf / (|b|_inf + 1)``, inf for a non-finite member: a
    singular member flags itself without touching the others.
    """
    fact = batched_factor(mats)
    x = batched_solve_factored(fact, rhs, trans=trans)
    lead, V = mats.shape[:-2], mats.shape[-1]
    resid = _bs.residuals(mats.reshape(-1, V, V), x.reshape(-1, V),
                          rhs.reshape(-1, V), trans=trans)
    return x, resid.reshape(lead)


def propagate_step(t: torch.Tensor, M: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """One Neumann sweep for all stages: t, src (S, V); M (S, V, V) -> (S, V)."""
    return _cp.propagate_step(t.to(torch.float32).contiguous(),
                              M.to(torch.float32).contiguous(),
                              src.to(torch.float32).contiguous())


def solve_fixed_point(M: torch.Tensor, src: torch.Tensor, *, sweeps: int) -> torch.Tensor:
    """``sweeps`` Neumann sweeps from zero (exact for loop-free routing once
    ``sweeps`` reaches the longest path)."""
    return _cp.solve_fixed_point(M.to(torch.float32).contiguous(),
                                 src.to(torch.float32).contiguous(), sweeps=sweeps)


def fused_chain_solve(fact: BatchedLU, base: torch.Tensor, mult: torch.Tensor,
                      *, trans: int = 0, reverse: bool = False,
                      clamp: bool = False) -> torch.Tensor:
    """Sequential solve along the stage axis of a factor stack.

    fact with leading dims (..., K), base/mult (..., K, V) -> x (..., K, V),
    walking k forward (or backward with ``reverse=True``):

        x_k = A_k^{-1(T)} (base_k + mult_k * x_prev),   x_prev(start) = 0,

    optionally clamped at 0.  One kernel launch covers every chain.
    """
    K, V = base.shape[-2:]
    x = _bs.chain_solve(fact.lu.reshape(-1, K, V, V).contiguous(),
                        base.reshape(-1, K, V).contiguous(),
                        mult.reshape(-1, K, V).contiguous(),
                        trans=trans, reverse=reverse, clamp=clamp)
    return x.reshape(base.shape)


def _flat(adj: torch.Tensor, phi_e: torch.Tensor, pdt: torch.Tensor):
    """(adj (M, V, V), phi_e (B, V, V), pdt (B, V)), contiguous: the leading
    dims flattened, adj's a prefix of phi_e's (a member's adjacency serves
    its A x K1 row batches)."""
    V = phi_e.shape[-1]
    lead = phi_e.shape[:-2]
    if tuple(adj.shape[:-2]) != tuple(lead[:adj.ndim - 2]) or pdt.shape != lead + (V,):
        raise ValueError(f"blocked sets: adj {tuple(adj.shape)}, phi_e "
                         f"{tuple(phi_e.shape)}, pdt {tuple(pdt.shape)} do not agree")
    return (adj.reshape(-1, V, V).contiguous(), phi_e.reshape(-1, V, V).contiguous(),
            pdt.reshape(-1, V).contiguous())


def blocked_set(adj: torch.Tensor, phi_e: torch.Tensor, pdt: torch.Tensor, *,
                eps: float, with_rounds: bool = False):
    """The dense route's blocked mask, ``engine.blocked_sets``' result:
    adj (*M, V, V) bool, phi_e (*M, ..., V, V), pdt (*M, ..., V) ->
    (*M, ..., V, V) bool,

        ~adj | (pdt_q > pdt_p + eps) | tagged[q],

    ``tagged`` the least fixed point of
    ``tagged[p] = exists q: route[p, q] and (improper[p, q] or tagged[q])``
    (``route = phi_e > 0``, ``improper = route & worse``).  One launch of
    the dense blocked-set kernel covers every row batch.  ``with_rounds=True``
    also returns each row batch's int32 round count of the fixed point
    (shape ``phi_e.shape[:-2]``), written by the same launch.
    """
    a, pe, pd = _flat(adj, phi_e, pdt)
    if with_rounds:
        mask, rounds = _bset.blocked_dense(pe, pd, a, eps=eps, with_rounds=True)
        return mask.reshape(phi_e.shape), rounds.reshape(phi_e.shape[:-2])
    return _bset.blocked_dense(pe, pd, a, eps=eps).reshape(phi_e.shape)


def blocked_tagged(route: torch.Tensor, improper: torch.Tensor) -> torch.Tensor:
    """Category-3 "tagged node" flags alone: route, improper (..., V, V)
    bool -> tagged (..., V) bool, through the packed rounds (the plain
    version's).  CPU tensors only: on the card the blocked-set kernel forms
    route and improper itself (:func:`blocked_set`)."""
    if route.device.type != "cpu":
        raise ValueError("blocked_tagged: no kernel takes route/improper; the card's "
                         "blocked sets go through blocked_set")
    lead, V = route.shape[:-2], route.shape[-1]
    return _bset.tagged_flags_plain(route.reshape(-1, V, V),
                                    improper.reshape(-1, V, V)).reshape(lead + (V,))


# ---------------------------------------------------------------------------
# Sparse route: factorization-free stage solves and the neighbor-list sweep
# ---------------------------------------------------------------------------

def sparse_chain_solve(phi_e: torch.Tensor, base: torch.Tensor, mult: torch.Tensor,
                       blk_nbr: torch.Tensor, blk_mask: torch.Tensor, *,
                       trans: int = 0, reverse: bool = False,
                       clamp: bool = False) -> torch.Tensor:
    """Sparse drop-in for :func:`fused_chain_solve`: the whole stage chain

        x_k = (I - M_k)^{-1} (base_k + mult_k * x_prev),
        M_k = Phi_k (trans=0) or Phi_k^T (trans=1),

    by blocked fixed-point sweeps over the nonzero 32 x 32 blocks: exact
    for loop-free (nilpotent) strategies, latched at +inf for divergent
    loopy candidates.  phi_e (..., K, V, V), base/mult (..., K, V), the
    instance's block lists blk_nbr/blk_mask (NB, BD), or a stacked family's
    (*M, NB, BD) with *M a prefix of phi_e's leading dims (each member's
    chains read its own lists) -> x (..., K, V); every chain in one launch.
    """
    K, V = base.shape[-2:]
    if blk_nbr.ndim > 2:
        blk_nbr = blk_nbr.reshape((-1,) + blk_nbr.shape[-2:])
        blk_mask = blk_mask.reshape((-1,) + blk_mask.shape[-2:])
    x = _ss.chain_solve_bsr(phi_e.reshape(-1, K, V, V).contiguous(), blk_nbr, blk_mask,
                            base.reshape(-1, K, V).contiguous(),
                            mult.reshape(-1, K, V).contiguous(),
                            trans=trans, reverse=reverse, clamp=clamp)
    return x.reshape(base.shape)


def blocked_set_nbr(adj: torch.Tensor, phi_e: torch.Tensor, pdt: torch.Tensor,
                    nbr: torch.Tensor, mask: torch.Tensor, *, eps: float,
                    with_rounds: bool = False):
    """Neighbor-list variant of :func:`blocked_set` (the sparse route): the
    same shapes plus the out-neighbor lists nbr/mask (V, D), or a stacked
    family's (*M, V, D) with *M adj's member dims (each member's rows read
    its own lists) -> the blocked mask, bit-equal to it wherever ``phi_e``
    routes only along listed edges (the fixed point reads route and improper
    on the lists alone), at O(E) work per round.  One launch covers every
    row batch.  ``with_rounds=True`` also returns the round counts, as
    :func:`blocked_set`.
    """
    a, pe, pd = _flat(adj, phi_e, pdt)
    if nbr.ndim > 2:
        nbr, mask = (x.reshape((-1,) + x.shape[-2:]) for x in (nbr, mask))
    if with_rounds:
        out, _, rounds = _ss.blocked_nbr(pe, pd, a, nbr, mask, eps=eps, with_rounds=True)
        return out.reshape(phi_e.shape), rounds.reshape(phi_e.shape[:-2])
    return _ss.blocked_nbr(pe, pd, a, nbr, mask, eps=eps).reshape(phi_e.shape)


def blocked_tagged_nbr(route: torch.Tensor, improper: torch.Tensor,
                       nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Neighbor-list variant of :func:`blocked_tagged`: route/improper
    (..., V, V) bool, nbr/mask (V, D) -> tagged (..., V) bool, bit-equal to
    it (the same monotone fixed point), both gathered onto the lists.  CPU
    tensors only, as :func:`blocked_tagged`."""
    if route.device.type != "cpu":
        raise ValueError("blocked_tagged_nbr: no kernel takes route/improper; the card's "
                         "blocked sets go through blocked_set_nbr")
    lead, V = route.shape[:-2], route.shape[-1]
    rv = _ss.gathered(route.reshape(-1, V, V), nbr) & mask
    iv = _ss.gathered(improper.reshape(-1, V, V), nbr)
    return _ss.tagged_nbr_plain(rv, iv, nbr).reshape(lead + (V,))


# ---------------------------------------------------------------------------
# Model kernels: attention and the SSD intra-chunk core
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """(B, S, H, hd) layout (``models.attention.sdpa``'s): q (B, S, H, hd),
    k/v (B, S, KV, hd) -> (B, S, H, hd).

    S is padded to a multiple of 128 as the reference's wrapper pads it,
    and the kernel is given the true length, so padded keys are masked in
    non-causal calls too (the reference passes the padded length there).
    """
    S = q.shape[1]
    pad = (-S) % _fa.PAD

    def heads_first(x):
        x = x.transpose(1, 2)
        return (F.pad(x, (0, 0, 0, pad)) if pad else x).contiguous()

    out = _fa.flash_attention_fwd(heads_first(q), heads_first(k), heads_first(v),
                                  causal=causal, window=window, seq_len=S)
    return out[:, :, :S].transpose(1, 2)


def ssd_chunk(xh: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor):
    """SSD intra-chunk core, ``models.ssm.ssd_chunked``'s call: xh
    (B, nc, Q, H, P), dt/cum (B, nc, Q, H), Bc/Cc (B, nc, Q, G, N), read by
    group -> (y_intra (B, nc, Q, H, P), state_c (B, nc, H, P, N)).

    A chunk shorter than the kernel's 128 rows (a prefill of S < 128
    tokens) is padded at its end with dt = 0, x = 0, B = C = 0 and cum held
    at its last value: a padded row adds nothing to a real row's output or
    to the state, and its own outputs are cut off.
    """
    Q = xh.shape[2]
    pad = _sc.CHUNK - Q
    if pad > 0:
        xh, Bc, Cc = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (xh, Bc, Cc))
        dt = F.pad(dt, (0, 0, 0, pad))
        cum = torch.cat([cum, cum[:, :, -1:].expand(-1, -1, pad, -1)], dim=2)
    y, state = _sc.ssd_chunk_fwd(*(x.contiguous() for x in (xh, dt, cum, Bc, Cc)))
    return y[:, :, :Q], state
