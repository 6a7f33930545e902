"""Mamba-2 SSD intra-chunk core.

Port of ``repro.kernels.ssd_chunk`` (``ssd_chunk_fwd``, the Pallas
``_kernel``).  For one (batch, chunk, head) with Q tokens:

    w[i, j]  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j      (j <= i, else 0)
    y_intra  = w @ X                                         (Q, P)
    state_c  = sum_j exp(cum_{Q-1} - cum_j) * dt_j * X_j (x) B_j   (P, N)

Shapes: xh (B, nc, Q, H, P), dt/cum (B, nc, Q, H), Bc/Cc (B, nc, Q, G, N)
with ``H % G == 0``: head h reads group ``h // (H // G)`` (G = H is the
reference's repeated ``BH``/``CH`` form) -> y (B, nc, Q, H, P), state
(B, nc, H, P, N).

``cum`` falls along the chunk, so ``exp(cum_i - cum_j)`` overflows above
the diagonal: both routes keep that triangle out of the exponent (the
plain version masks inside it, as ``repro.models.ssm`` does; the kernel
never computes it).

  * :func:`ssd_chunk_plain` is the einsum form of ``repro.models.ssm``'s
    jnp path; the CPU route and the on-card oracle.
  * :func:`ssd_chunk_fwd` launches ``csrc/ssd_chunk.cu`` for CUDA tensors
    and takes the plain version for CPU tensors.  The kernel forms its
    products on the tensor cores in three-term TF32 (each float32 operand
    split into two TF32 parts; float32-level accuracy); every PyTorch
    product stays in full float32.

``ssd_chunk_fwd.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Shapes the CUDA kernel takes: the chunk length and the (head dim, state
# size) pairs.  N = 16 (Jamba's d_state) only at P = 64: at P = 32 the
# kernel's state tiling leaves its warps no column tile.
CHUNK = 128
SHAPES = ((32, 32), (32, 64), (32, 128), (64, 16), (64, 32), (64, 64), (64, 128))


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """(B, nc, Q, G, N) -> (B, nc, Q, H, N), group g serving heads
    g * rep .. (g + 1) * rep - 1."""
    G = x.shape[3]
    return x if G == H else x.repeat_interleave(H // G, dim=3)


def ssd_chunk_plain(xh: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    Bc: torch.Tensor, Cc: torch.Tensor):
    """Plain intra-chunk core -> (y_intra (B,nc,Q,H,P), state_c (B,nc,H,P,N)),
    float32 (float64 for float64 inputs: the kernel's yardstick)."""
    H, Q = xh.shape[3], xh.shape[2]
    real = torch.float64 if xh.dtype == torch.float64 else torch.float32
    xh, dt, cum = xh.to(real), dt.to(real), cum.to(real)
    BH, CH = _heads(Bc.to(real), H), _heads(Cc.to(real), H)
    scores = torch.einsum("bcqhn,bckhn->bchqk", CH, BH)
    ch = cum.permute(0, 1, 3, 2)                                   # (B,nc,H,Q)
    diff = ch[..., :, None] - ch[..., None, :]                     # (B,nc,H,Q,Q)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(torch.where(tri, diff, -1e9))
    w = torch.where(tri, scores * decay, 0.0)
    w = w * dt.permute(0, 1, 3, 2)[..., None, :]                   # weight by dt_j
    y = torch.einsum("bchqk,bckhp->bcqhp", w, xh)
    sdec = torch.exp(cum[:, :, -1:, :] - cum) * dt                 # (B,nc,Q,H)
    state = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", sdec, BH, xh)
    return y, state


def _check(x: torch.Tensor, name: str, ndim: int) -> None:
    if x.dtype != torch.float32 or x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"ssd_chunk {name}: want a contiguous {ndim}-dim float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def ssd_chunk_fwd(xh: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                  Bc: torch.Tensor, Cc: torch.Tensor):
    """Intra-chunk core, shapes as the module docstring says.

    CUDA tensors: one launch of ``csrc/ssd_chunk.cu``, one thread block per
    (batch * chunk, B/C group, tile of heads), C B^T formed once a block;
    Q = 128 (``ops.ssd_chunk`` pads a shorter chunk), (P, N) in ``SHAPES``,
    xh, Bc and Cc 16-byte aligned.  Raises ``ValueError`` for any other
    shape.  CPU tensors: :func:`ssd_chunk_plain`.
    """
    if xh.device.type == "cpu":
        return ssd_chunk_plain(xh, dt, cum, Bc, Cc)
    _check(xh, "xh", 5)
    _check(dt, "dt", 4)
    _check(cum, "cum", 4)
    _check(Bc, "Bc", 5)
    _check(Cc, "Cc", 5)
    Bsz, nc, Q, H, P = xh.shape
    G, N = Bc.shape[3], Bc.shape[4]
    if (dt.shape != (Bsz, nc, Q, H) or cum.shape != dt.shape
            or Bc.shape != (Bsz, nc, Q, G, N) or Cc.shape != Bc.shape or H % G
            or Q != CHUNK or (P, N) not in SHAPES):
        raise ValueError(f"ssd_chunk: shapes xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, cum {tuple(cum.shape)}, Bc "
                         f"{tuple(Bc.shape)}, Cc {tuple(Cc.shape)} not taken (Q "
                         f"{CHUNK}, (P, N) in {SHAPES}, H % G == 0)")
    if any(t.device != xh.device for t in (dt, cum, Bc, Cc)):
        raise ValueError("ssd_chunk: all inputs must be on one device")
    if any(t.data_ptr() % 16 for t in (xh, Bc, Cc)):
        raise ValueError("ssd_chunk: xh, Bc and Cc must be 16-byte aligned "
                         "(the kernel copies them 16 bytes at a time)")
    y = torch.empty_like(xh)
    state = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32, device=xh.device)
    fn = _build.function("ssd_chunk", "repro_ssd_chunk",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xh.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bc.data_ptr(),
                Cc.data_ptr(), y.data_ptr(), state.data_ptr(),
                Bsz * nc, H, G, P, N, stream)
    _build.check("ssd_chunk", rc, "ssd_chunk")
    ssd_chunk_fwd.launches += 1
    return y, state


ssd_chunk_fwd.launches = 0
