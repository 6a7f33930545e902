"""Blockwise online-softmax attention forward, causal and sliding-window.

Port of ``repro.kernels.flash_attention`` (``flash_attention_fwd``, the
Pallas ``_kernel``).  Layouts: q (B, H, S, hd), k/v (B, KV, S, hd) with
``H % KV == 0`` (GQA: head h reads KV head ``h // (H // KV)``), S padded
by the caller (``ops.flash_attention``); ``seq_len`` is the true length,
and keys at ``seq_len`` and beyond are masked.

  * :func:`flash_attention_plain` is the explicit masked softmax with the
    GQA repeat (``repro.kernels.ref.flash_attention``) plus ``seq_len``;
    the CPU route and the on-card oracle.
  * :func:`flash_attention_fwd` launches ``csrc/flash_attention.cu`` for
    CUDA tensors and takes the plain version for CPU tensors.  The kernel
    forms both products on the tensor cores in three-term TF32 (each
    float32 operand split into two TF32 parts; float32-level accuracy);
    every PyTorch product stays in full float32.

Masked scores take the reference's -1e30 sentinel (not -inf).  The kernel
keeps the reference kernel's running max from -1e30, zeroes the masked
probabilities and floors the denominator at 1e-30.  Every query row has a
key in reach on the model's path (its own position), where the two routes
compute one function.

``flash_attention_fwd.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# Query and key tile of the CUDA kernel; ``ops.flash_attention`` pads S to
# a multiple of PAD (the reference's 128-row blocks), which BQ/BK divide.
BQ = BK = 64
PAD = 128
HEAD_DIMS = (64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          seq_len: int | None = None) -> torch.Tensor:
    """q (B, H, S, hd), k/v (B, KV, S, hd) -> (B, H, S, hd) float32 (float64
    for float64 inputs: the yardstick the kernel's error is measured by)."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    real = torch.float64 if q.dtype == torch.float64 else torch.float32
    k = k.repeat_interleave(rep, dim=1).to(real)
    v = v.repeat_interleave(rep, dim=1).to(real)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(real) * hd ** -0.5, k)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = kp < (S if seq_len is None else seq_len)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"flash_attention {name}: want a contiguous 4-dim float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        seq_len: int | None = None) -> torch.Tensor:
    """q (B, H, S, hd), k/v (B, KV, S, hd) float32 -> (B, H, S, hd).

    CUDA tensors: one launch of ``csrc/flash_attention.cu``, one thread
    block of 4 warps per (b, h, 64-row query tile); S a multiple of 64, hd
    64 or 128.
    CPU tensors: :func:`flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     seq_len=seq_len)
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(x, name)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if (k.shape != (B, KV, S, hd) or v.shape != k.shape or KV < 1 or H % KV
            or S % BQ or hd not in HEAD_DIMS):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} not taken (S a "
                         f"multiple of {BQ}, hd in {HEAD_DIMS}, H % KV == 0)")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: all inputs must be on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned "
                         "(the kernel copies them 16 bytes at a time)")
    n = S if seq_len is None else int(seq_len)
    if not 0 < n <= S:
        raise ValueError(f"flash_attention: seq_len {n} outside (0, {S}]")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "repro_flash_attention",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, KV, S, hd, n, int(causal),
                0 if window is None else int(window), hd ** -0.5, stream)
    _build.check("flash_attention", rc, "flash_attention")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
