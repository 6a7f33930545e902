"""The tolerance decision behind the model kernels' tensor-core products.

``flash_attention.cu`` and ``ssd_chunk.cu`` multiply on TF32 tensor cores
in the error-compensated three-term form: each float32 operand x is split
as big = tf32(x) (``cvt.rna.tf32.f32``: the mantissa rounded to 10 bits,
ties away from zero) and small = tf32(x - big), and each product is
accumulated as small*big + big*small + big*big in float32.  This file
emulates both that form and single-pass TF32 in numpy, at the kernels'
contraction lengths and on inputs shaped like ``chip_smoke.py``'s, and
holds them to the port's model tolerance (``MODEL_TOL``: 2e-5 of the
largest |value|, the kernels against their plain versions):

  * three terms stay under MODEL_TOL / 10 against float64;
  * single-pass TF32 exceeds MODEL_TOL on the same inputs, which is why
    the kernels never use it.

The emulated ``mma.m16n8k8`` forms each k8 step's products exactly and
rounds the accumulator to float32 once per step.  Runs on the CPU.
"""

import numpy as np
import pytest

MODEL_TOL = 2e-5            # chip_smoke.MODEL_TOL
K_STEP = 8                  # the contraction depth of one mma.m16n8k8


def tf32(x):
    """``cvt.rna.tf32.f32``: float32 -> nearest TF32 value (10 mantissa
    bits), ties away from zero, as float32 with the low 13 bits zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """x -> (big, small), both TF32, big + small = x to 2^-22 |x|."""
    x = np.asarray(x, dtype=np.float32)
    big = tf32(x)
    return big, tf32(x - big)


def mma_sum(terms, K):
    """sum_k a[:, k] b[k, :] in k8 steps, each step's products exact
    (float64) and the float32 accumulator rounded once per step and term,
    the terms of a step in the order given: [(a, b), ...]."""
    M, N = terms[0][0].shape[0], terms[0][1].shape[1]
    acc = np.zeros((M, N), dtype=np.float32)
    for k0 in range(0, K, K_STEP):
        for a, b in terms:
            part = a[:, k0:k0 + K_STEP].astype(np.float64) @ b[k0:k0 + K_STEP].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def three_term(a, b):
    (ab, as_), (bb, bs) = split(a), split(b)
    return mma_sum([(as_, bb), (ab, bs), (ab, bb)], a.shape[1])


def single_pass(a, b):
    return mma_sum([(tf32(a), tf32(b))], a.shape[1])


def _cases():
    """{name: (a, b)} float32, shaped as the kernels' products at the
    smoke's full-width shapes (one query tile, one chunk and head)."""
    rng = np.random.default_rng(17)
    f32 = np.float32
    hd, S, Q, P, N = 128, 2048, 128, 64, 128
    out = {}
    # flash_attention: scores of 64 query rows against 64 keys (contract hd)
    q = (rng.standard_normal((64, hd)) * hd ** -0.5).astype(f32)
    k = rng.standard_normal((hd, 64)).astype(f32)
    out["flash-qk"] = (q, k)
    # P V over 2048 keys (32 tiles of 64): causal softmax rows of the last tile
    s = (rng.standard_normal((64, S)) * 1.5).astype(f32)
    rows = np.arange(S - 64, S)[:, None]
    s = np.where(np.arange(S)[None, :] <= rows, s, -np.inf)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    out["flash-pv"] = ((p / p.sum(axis=1, keepdims=True)).astype(f32),
                       rng.standard_normal((S, hd)).astype(f32))
    # ssd_chunk: C B^T over the state size, w X over the chunk, the state
    C = rng.standard_normal((Q, N)).astype(f32)
    B = rng.standard_normal((Q, N)).astype(f32)
    out["ssd-cb"] = (C, np.ascontiguousarray(B.T))
    dt = np.log1p(np.exp(rng.standard_normal(Q))).astype(f32)
    cum = np.cumsum(dt * -1.0).astype(f32)
    tri = np.tril(np.ones((Q, Q), dtype=bool))
    diff = np.where(tri, cum[:, None] - cum[None, :], -1e9).astype(f32)
    cb = (C.astype(np.float64) @ B.T.astype(np.float64)).astype(f32)
    w = np.where(tri, cb * np.exp(diff) * dt[None, :], 0.0).astype(f32)
    X = rng.standard_normal((Q, P)).astype(f32)
    out["ssd-wx"] = (w, X)
    sdec = (np.exp(cum[-1] - cum) * dt).astype(f32)
    out["ssd-state"] = (np.ascontiguousarray((X * sdec[:, None]).T), B)
    return out


CASES = _cases()


def _err(got, a, b):
    exact = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(got.astype(np.float64) - exact).max() / np.abs(exact).max())


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                   # TF32's spacing at 1
    x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23,
                  -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11], dtype=np.float32)
    assert tf32(x).tolist() == [one + ulp, one, -(one + ulp), one + 2 * ulp]
    big, small = split(np.array([np.pi], dtype=np.float32))
    assert abs(float(big[0]) + float(small[0]) - float(np.float32(np.pi))) <= 2.0 ** -22 * np.pi


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_term_tf32_within_a_tenth_of_the_model_tolerance(name):
    a, b = CASES[name]
    assert _err(three_term(a, b), a, b) < MODEL_TOL / 10


@pytest.mark.parametrize("name", sorted(CASES))
def test_single_pass_tf32_exceeds_the_model_tolerance(name):
    a, b = CASES[name]
    assert _err(single_pass(a, b), a, b) > MODEL_TOL
