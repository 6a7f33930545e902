"""Batched stage propagation: one Neumann step of the stage fixed points.

Port of ``repro.kernels.chain_propagate``.  For every stage s at once,

    out[s, :] = t[s, :] @ M[s, :, :] + src[s, :]

(traffic sweep: M = Phi, src = injections; marginal sweep: M = Phi^T,
src = local marginals).  :func:`solve_fixed_point` iterates it from zero,
which is exact for a loop-free (nilpotent) routing once the sweeps reach
the longest path.

:func:`propagate_step` launches ``csrc/chain_propagate.cu`` for CUDA
tensors and runs the plain PyTorch version for CPU tensors;
``propagate_step.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def propagate_step_plain(t: torch.Tensor, M: torch.Tensor,
                         src: torch.Tensor) -> torch.Tensor:
    """t, src (S, V); M (S, V, V) -> (S, V): the reference's einsum."""
    return torch.einsum("sv,svw->sw", t.to(torch.float32),
                        M.to(torch.float32)) + src.to(torch.float32)


def _check(x: torch.Tensor, name: str, ndim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: want float32, got {x.dtype}")
    if x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-dim tensor, got "
                         f"shape {tuple(x.shape)}")


def propagate_step(t: torch.Tensor, M: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """One sweep for all stages: t, src (S, V); M (S, V, V) -> (S, V).

    CUDA tensors: one launch of ``csrc/chain_propagate.cu`` over (stage,
    column tile).  CPU tensors: the plain version.
    """
    if t.device.type == "cpu":
        return propagate_step_plain(t, M, src)
    _check(t, "propagate_step t", 2)
    _check(M, "propagate_step M", 3)
    _check(src, "propagate_step src", 2)
    S, V = t.shape
    if M.shape != (S, V, V) or src.shape != (S, V):
        raise ValueError(f"propagate_step: shapes t {tuple(t.shape)}, M "
                         f"{tuple(M.shape)}, src {tuple(src.shape)} do not agree")
    if M.device != t.device or src.device != t.device:
        raise ValueError("propagate_step: all inputs must be on one device")
    out = torch.empty_like(t)
    fn = _build.function("chain_propagate", "repro_propagate_step",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(t.data_ptr(), M.data_ptr(), src.data_ptr(), out.data_ptr(), S, V, stream)
    _build.check("chain_propagate", rc, "propagate_step")
    propagate_step.launches += 1
    return out


propagate_step.launches = 0


def solve_fixed_point(M: torch.Tensor, src: torch.Tensor, *, sweeps: int) -> torch.Tensor:
    """Iterate ``out <- out @ M + src`` from zero, ``sweeps`` times: one
    :func:`propagate_step` per sweep."""
    t = torch.zeros_like(src, dtype=torch.float32)
    for _ in range(sweeps):
        t = propagate_step(t, M, src)
    return t
