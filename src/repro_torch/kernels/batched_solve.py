"""Batched unpivoted LU and the fused chain solve of the GP stage systems.

Port of ``repro.kernels.batched_solve``.  Every GP iteration solves
O(ladder x apps x stages) small dense systems

    (I - Phi_k)   pdt = b      (marginal recursion (4), row form)
    (I - Phi_k)^T t   = inject (traffic fixed point, Section II)

whose matrices differ only by a transpose, so one factorization serves both.

  * :func:`lu_factor` — unpivoted LU of a (B, V, V) batch into packed L\\U
    factors.  ``I - Phi`` of a loop-free strategy is a nonsingular M-matrix,
    for which LU without pivoting exists and is stable; a loopy candidate's
    ~0 pivot carries inf/nan in that member only, and :func:`factor_ok`
    flags it.
  * :func:`lu_solve` — one right-hand side per member from its packed
    factor, ``A x = b`` (trans=0) or ``A^T x = b`` (trans=1): the two
    triangular sweeps.
  * :func:`chain_solve` — walks each member's K stages,
    ``x_k = A_k^{-1(T)}(base_k + mult_k * x_prev)``, with two triangular
    sweeps per stage from the packed factors.

Each wrapper launches its CUDA kernel (``csrc/batched_lu.cu``,
``csrc/lu_solve.cu``, ``csrc/chain_solve.cu``) for a CUDA tensor, in the
variant its launch plan picks by V (the factor in registers or shared
memory where it fits, in global memory above V = 239-241, where
``lu_factor`` and ``chain_solve`` run on a cluster of CTAs per member or
chain), and runs the plain PyTorch
version of the same arithmetic for a CPU tensor; the plain versions are
also the on-card oracles of ``chip_smoke.py``.  ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# |U_ii| below this is treated as a structurally singular member.
PIVOT_TINY = 1e-30


# lu_factor holds a matrix in registers up to this V (16 x 16 threads of
# at most 8 x 8 values each), in shared memory above it, and in global
# memory, a cluster of CTAs a member, where it does not fit there.
REG_TILE_MAX_V = 128
LU_THREADS = 256
CHAIN_THREADS = 128
# The global-memory variants (csrc/strip_sweep.cuh, the LU panels).
STRIP = 32
STRIP_THREADS = 256
PANEL_LD = STRIP + 4
_TILE_FLOATS = STRIP * (STRIP + 1)     # a strip's diagonal block, odd stride
# lu_factor's clusters: the trailing update's shared memory (128 staged rows
# of L, sixteen owned panels' U12 blocks, the L11 block), which the panel
# factor shares; every CTA owns at most 16 panels.  The variant takes V up
# to LU_MAX_V, the range of the single-block panel design before it.
_LU_UPDATE_FLOATS = 128 * PANEL_LD + 16 * STRIP * STRIP + _TILE_FLOATS
LU_MAX_V = 1614
# chain_solve's clusters: a warp per 32-row strip, at most 8 CTAs a cluster.
CHAIN_CLUSTER_MAX_V = 8 * 8 * STRIP


def lu_factor_plan(V: int) -> dict:
    """How :func:`lu_factor` launches at node count V.

    ``variant``: "registers" (V <= 128; ``tiles`` = ceil(V / 16) values per
    thread and dimension; in shared memory the published row, column and
    multipliers, 4 x 128 floats, and the V x (V | 1) tile the factor leaves
    through), "shared" (the V x (V | 1) tile factored in shared memory,
    V <= 241) or "clusters" (factored in place in global memory by 32-column
    panels, ``cluster`` CTAs a member, each owning every ``cluster``-th
    panel: the fewest, from 2, that leave each CTA at most 16 panels, so 2
    up to V = 1024 and 4 above; ``smem_bytes`` the trailing update's
    buffers, the same at every V).  Raises above V = 1614, where the
    single-block panel design before the clusters no longer fit its panel
    in shared memory.
    """
    tile = 4 * V * (V | 1)
    if V <= REG_TILE_MAX_V:
        plan = {"variant": "registers", "threads": LU_THREADS, "tiles": -(-V // 16),
                "cluster": None, "smem_bytes": 4 * 4 * REG_TILE_MAX_V + tile}
    elif tile <= _build.SMEM_LIMIT:
        plan = {"variant": "shared", "threads": LU_THREADS, "tiles": None, "cluster": None,
                "smem_bytes": tile}
    else:
        if V > LU_MAX_V:
            raise ValueError(
                f"lu_factor: V={V} is above {LU_MAX_V}, the largest V the dense factor "
                f"takes (where a {V} x {PANEL_LD}-float panel stopped fitting one block's "
                f"shared memory); take the sparse route at this size")
        plan = {"variant": "clusters", "threads": LU_THREADS, "tiles": None,
                "cluster": 2 if -(-V // STRIP) <= 2 * 16 else 4,
                "smem_bytes": 4 * _LU_UPDATE_FLOATS}
    return plan


def chain_solve_plan(V: int) -> dict:
    """How :func:`chain_solve` launches at node count V.

    ``variant`` "shared" (V <= 239): the factor, right-hand side, iterate
    and 2 x 32 gathered partials in shared memory, ``chunks`` = ceil(V /
    32) values of the forward sweep's y per lane; "clusters" (V <= 2048):
    the factor read from global memory, ``cluster`` CTAs of 256 threads a
    chain (the least power of two from 2 that gives every 32-row strip a
    warp of its own), the solved strips (two V-float buffers), 32 row sums
    and a 32 x 33 buffer a warp in shared memory; "strips": the factor read
    from global memory by strips of 32 rows by one 256-thread block, the
    right-hand side, the iterate and a 32 x 33 diagonal block in shared
    memory.  Raises where even those do not fit."""
    smem = 4 * (64 + V * (V | 1) + 2 * V)
    if smem <= _build.SMEM_LIMIT:
        plan = {"variant": "shared", "threads": CHAIN_THREADS, "chunks": -(-V // 32),
                "cluster": None, "smem_bytes": smem}
    elif V <= CHAIN_CLUSTER_MAX_V:
        c = 2
        while 8 * c < -(-V // STRIP):
            c *= 2
        plan = {"variant": "clusters", "threads": STRIP_THREADS, "chunks": None, "cluster": c,
                "smem_bytes": 4 * (2 * V + STRIP + 8 * _TILE_FLOATS)}
    else:
        plan = {"variant": "strips", "threads": STRIP_THREADS, "chunks": None,
                "cluster": None, "smem_bytes": 4 * (2 * V + _TILE_FLOATS)}
    _check_smem(plan["smem_bytes"], V, "chain_solve", "its right-hand side and iterate")
    return plan


def lu_solve_plan(V: int) -> dict:
    """How :func:`lu_solve` launches at node count V: ``variant`` "shared"
    (V <= 240: the V x (V | 1) factor and the right-hand side in shared
    memory, 128 threads) or "strips" (as :func:`chain_solve_plan`'s, the
    right-hand side and a 32 x 33 diagonal block in shared memory)."""
    smem = 4 * (V * (V | 1) + V)
    if smem <= _build.SMEM_LIMIT:
        plan = {"variant": "shared", "threads": CHAIN_THREADS, "smem_bytes": smem}
    else:
        plan = {"variant": "strips", "threads": STRIP_THREADS,
                "smem_bytes": 4 * (V + _TILE_FLOATS)}
    _check_smem(plan["smem_bytes"], V, "lu_solve", "its right-hand side")
    return plan


def _check_cuda(x: torch.Tensor, name: str, ndim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: want float32, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{name}: want {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_smem(nbytes: int, V: int, what: str, holds: str) -> None:
    """Raise where even the global-memory variant's shared memory (``holds``)
    exceeds what one block may use."""
    if nbytes > _build.SMEM_LIMIT:
        raise ValueError(
            f"{what}: V={V} needs {nbytes} B of shared memory per block for "
            f"{holds}, above the card's {_build.SMEM_LIMIT} B; take the sparse "
            f"route at this size")


# ---------------------------------------------------------------------------
# lu_factor
# ---------------------------------------------------------------------------

def lu_factor_plain(mats: torch.Tensor) -> torch.Tensor:
    """Right-looking unpivoted elimination: (B, V, V) -> packed (B, V, V).

    The same column steps as the kernel: divide column k below the
    diagonal by the pivot, then the rank-1 update of the trailing block.
    """
    a = mats.to(torch.float32).clone()
    V = a.shape[-1]
    for k in range(V - 1):
        l = a[:, k + 1:, k] / a[:, k, k, None]
        a[:, k + 1:, k] = l
        a[:, k + 1:, k + 1:] -= l[:, :, None] * a[:, k, None, k + 1:]
    return a


def lu_factor(mats: torch.Tensor, *, with_ok: bool = False):
    """Unpivoted LU of a (B, V, V) float32 batch -> packed (B, V, V) factors,
    and with ``with_ok`` also the (B,) bool :func:`factor_ok` flags.

    CUDA tensor: one launch of ``csrc/batched_lu.cu`` (the variant of
    :func:`lu_factor_plan`), which writes the flags beside the factors.
    CPU tensor: the plain version and :func:`factor_ok`.
    """
    if mats.device.type == "cpu":
        lu = lu_factor_plain(mats)
        return (lu, factor_ok(lu)) if with_ok else lu
    _check_cuda(mats, "lu_factor", 3)
    B, V, V2 = mats.shape
    if V != V2:
        raise ValueError(f"lu_factor: matrices must be square, got {tuple(mats.shape)}")
    variant = ("registers", "shared", "clusters").index(lu_factor_plan(V)["variant"])
    out = torch.empty_like(mats)
    ok = torch.empty(B, dtype=torch.bool, device=mats.device)
    fn = _build.function("batched_lu", "repro_lu_factor",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(mats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(mats.data_ptr(), out.data_ptr(), ok.data_ptr(), B, V, variant, stream)
    _build.check("batched_lu", rc, "lu_factor")
    lu_factor.launches += 1
    return (out, ok) if with_ok else out


lu_factor.launches = 0


def factor_ok(lu: torch.Tensor) -> torch.Tensor:
    """(...,) bool per-member condition flags from packed factors.

    Not ok: a non-finite entry, or a ~zero U pivot.  The batched analogue
    of LAPACK's ``info``; flagged members carry inf/nan forward to
    ``traffic_is_valid`` instead of raising.  The plain version of the
    flags ``csrc/batched_lu.cu`` writes beside the factors.
    """
    diag = torch.diagonal(lu, dim1=-2, dim2=-1)
    finite = torch.isfinite(lu).all(dim=-1).all(dim=-1)
    return finite & (diag.abs().amin(dim=-1) > PIVOT_TINY)


# ---------------------------------------------------------------------------
# chain_solve
# ---------------------------------------------------------------------------

def _two_sweep_plain(lu: torch.Tensor, b: torch.Tensor, trans: int) -> torch.Tensor:
    """Solve L U x = b (trans=0) or (L U)^T x = b (trans=1) per member.

    Both are a forward then a backward row sweep of the packed factor, read
    transposed for trans=1: U^T (lower, with diagonal) then L^T (unit upper).
    """
    m = lu.transpose(-1, -2) if trans else lu
    V = b.shape[-1]
    y = b.clone()
    for i in range(V):
        s = (m[:, i, :i] * y[:, :i]).sum(-1)
        y[:, i] = (y[:, i] - s) / m[:, i, i] if trans else y[:, i] - s
    for i in range(V - 1, -1, -1):
        s = (m[:, i, i + 1:] * y[:, i + 1:]).sum(-1)
        y[:, i] = y[:, i] - s if trans else (y[:, i] - s) / m[:, i, i]
    return y


def lu_solve_plain(lu: torch.Tensor, rhs: torch.Tensor, *,
                   trans: int = 0) -> torch.Tensor:
    """Plain two-sweep solve: lu (B, V, V), rhs (B, V) -> (B, V)."""
    return _two_sweep_plain(lu, rhs.to(torch.float32), trans)


def lu_solve(lu: torch.Tensor, rhs: torch.Tensor, *, trans: int = 0) -> torch.Tensor:
    """Solve packed-LU systems: lu (B, V, V), rhs (B, V) -> (B, V).

    CUDA tensors: one launch of ``csrc/lu_solve.cu``, one block per member
    (the variant of :func:`lu_solve_plan`).  CPU tensors: the plain version.
    Identity row permutation (the factors of :func:`lu_factor`).
    """
    if lu.device.type == "cpu":
        return lu_solve_plain(lu, rhs, trans=trans)
    _check_cuda(lu, "lu_solve lu", 3)
    _check_cuda(rhs, "lu_solve rhs", 2)
    B, V, V2 = lu.shape
    if V != V2 or rhs.shape != (B, V):
        raise ValueError(f"lu_solve: shapes lu {tuple(lu.shape)}, rhs "
                         f"{tuple(rhs.shape)} do not agree")
    if rhs.device != lu.device:
        raise ValueError("lu_solve: all inputs must be on one device")
    variant = ("shared", "strips").index(lu_solve_plan(V)["variant"])
    out = torch.empty_like(rhs)
    fn = _build.function("lu_solve", "repro_lu_solve",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(lu.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(lu.data_ptr(), rhs.data_ptr(), out.data_ptr(), B, V, int(trans), variant,
                stream)
    _build.check("lu_solve", rc, "lu_solve")
    lu_solve.launches += 1
    return out


lu_solve.launches = 0


def residuals(mats: torch.Tensor, x: torch.Tensor, rhs: torch.Tensor, *,
              trans: int = 0) -> torch.Tensor:
    """(B,) relative residuals ``|A x - b|_inf / (|b|_inf + 1)``; inf for a
    non-finite member (the per-member divergence flag)."""
    op = torch.einsum("bji,bj->bi" if trans else "bij,bj->bi",
                      mats.to(torch.float32), x.to(torch.float32))
    r = ((op - rhs).abs().amax(dim=-1)
         / (rhs.abs().amax(dim=-1) + 1.0))
    return torch.where(torch.isfinite(r), r, torch.inf)


def chain_solve_plain(lu: torch.Tensor, base: torch.Tensor, mult: torch.Tensor,
                      *, trans: int = 0, reverse: bool = False,
                      clamp: bool = False) -> torch.Tensor:
    """Plain chain solve: lu (B, K, V, V), base/mult (B, K, V) -> (B, K, V)."""
    B, K, V = base.shape
    x = torch.zeros((B, V), dtype=torch.float32, device=base.device)
    out = torch.empty((B, K, V), dtype=torch.float32, device=base.device)
    for k in (range(K - 1, -1, -1) if reverse else range(K)):
        x = _two_sweep_plain(lu[:, k], base[:, k] + mult[:, k] * x, trans)
        if clamp:
            x = torch.maximum(x, x.new_zeros(()))      # NaN stays NaN
        out[:, k] = x
    return out


def chain_solve(lu: torch.Tensor, base: torch.Tensor, mult: torch.Tensor,
                *, trans: int = 0, reverse: bool = False,
                clamp: bool = False) -> torch.Tensor:
    """Fused chain solve: lu (B, K, V, V), base/mult (B, K, V) -> (B, K, V).

    CUDA tensors: one launch of ``csrc/chain_solve.cu``, one block per
    chain, or a cluster of CTAs per chain above V = 239 (the variant of
    :func:`chain_solve_plan`).  CPU tensors: the plain version.
    Identity row permutation (the factors of :func:`lu_factor`).
    """
    if lu.device.type == "cpu":
        return chain_solve_plain(lu, base, mult, trans=trans, reverse=reverse,
                                 clamp=clamp)
    _check_cuda(lu, "chain_solve lu", 4)
    _check_cuda(base, "chain_solve base", 3)
    _check_cuda(mult, "chain_solve mult", 3)
    B, K, V, V2 = lu.shape
    if V != V2 or base.shape != (B, K, V) or mult.shape != (B, K, V):
        raise ValueError(
            f"chain_solve: shapes lu {tuple(lu.shape)}, base "
            f"{tuple(base.shape)}, mult {tuple(mult.shape)} do not agree")
    if base.device != lu.device or mult.device != lu.device:
        raise ValueError("chain_solve: all inputs must be on one device")
    variant = ("shared", "strips", "clusters").index(chain_solve_plan(V)["variant"])
    out = torch.empty_like(base)
    fn = _build.function("chain_solve", "repro_chain_solve",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with torch.cuda.device(lu.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(lu.data_ptr(), base.data_ptr(), mult.data_ptr(), out.data_ptr(),
                B, K, V, int(trans), int(reverse), int(clamp), variant, stream)
    _build.check("chain_solve", rc, "chain_solve")
    chain_solve.launches += 1
    return out


chain_solve.launches = 0
