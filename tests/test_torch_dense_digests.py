"""The dense route's kernels on the CPU side: digest inputs and launch plans.

``tests/data/torch_card_dense_digests.json`` holds, for every case of
``_torch_cases.dense_digest_cases``, the sha256 of the numpy inputs and of
the bytes the card's ``lu_factor`` and ``chain_solve`` wrote (made on the
card by ``tests/data/make_torch_card_digests.py``); the card tests and
``chip_smoke.py`` hold the kernels to those output digests bit for bit.
Here the inputs are regenerated and held to the file's input digests, so
that input drift shows on the CPU and not as a kernel mismatch on the card.
The wrappers' launch plans (register or shared-memory variant of
``lu_factor`` by V, block sizes, shared-memory bytes, the raise where the
shared tile does not fit) are host logic and are checked here; the card
test ``test_launch_plans_match_the_kernels`` holds their shared-memory
bytes to the CUDA sources.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially

from _torch_cases import (case_id, dense_digest_cases, digest_inputs,  # noqa: E402
                          np_lu_factor, sha256, stage_mats)
from repro_torch.kernels import batched_solve as bs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DIGESTS = os.path.join(os.path.dirname(__file__), "data", "torch_card_dense_digests.json")


def _doc():
    with open(DIGESTS) as fh:
        return json.load(fh)


def test_digest_file_covers_every_case():
    doc = _doc()
    specs = [{k: v for k, v in c.items() if k not in ("inputs", "outputs")}
             for c in doc["cases"]]
    assert specs == dense_digest_cases()
    assert doc["device"].startswith("NVIDIA H100")
    assert set(doc["kernel_sources"]) == {"batched_lu.cu", "chain_solve.cu", "two_sweep.cuh"}
    for c in doc["cases"]:
        want = {"lu", "ok"} if c["kernel"] == "lu_factor" else {"x"}
        assert set(c["outputs"]) == want


@pytest.mark.parametrize("case", dense_digest_cases(), ids=case_id)
def test_digest_inputs_regenerate(case):
    ref = {case_id(c): c for c in _doc()["cases"]}[case_id(case)]
    inputs = digest_inputs(case)
    assert {k: sha256(v) for k, v in inputs.items()} == ref["inputs"]
    if case["kernel"] == "lu_factor":
        mats = inputs["mats"]
        assert mats.shape == (case["B"], case["V"], case["V"]) and mats.dtype == np.float32
    else:
        B, K, V = case["B"], case["K"], case["V"]
        assert inputs["lu"].shape == (B, K, V, V) and inputs["base"].shape == (B, K, V)
        loopy = np.zeros(B, dtype=bool)
        loopy[case["loopy"]] = True
        fin = np.isfinite(inputs["lu"]).all(axis=(1, 2, 3))
        assert np.array_equal(fin, ~loopy)


def test_numpy_factor_is_the_plain_version_bit_for_bit():
    """The chain cases' factors (numpy) are the plain ``lu_factor`` on the
    CPU exactly: the same multiply, subtract and divide in float32."""
    mats = stage_mats(np.random.default_rng(7), 5, 40, loopy=(2,))
    got = np_lu_factor(mats)
    want = bs.lu_factor_plain(torch.from_numpy(mats)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("V,variant,tiles", [(1, "registers", 1), (16, "registers", 1),
                                             (17, "registers", 2), (100, "registers", 7),
                                             (128, "registers", 8), (129, "shared", None),
                                             (240, "shared", None), (241, "shared", None)])
def test_lu_factor_plan_by_node_count(V, variant, tiles):
    plan = bs.lu_factor_plan(V)
    assert plan["variant"] == variant and plan["tiles"] == tiles
    assert plan["threads"] == 256
    # the V x (V | 1) tile (an odd row stride against bank conflicts): the
    # registers variant stages its stores there, beside the published row,
    # column and multipliers (4 x 128 floats)
    tile = 4 * V * (V | 1)
    assert plan["smem_bytes"] == (2048 + tile if variant == "registers" else tile)
    assert plan["smem_bytes"] <= 232_448


@pytest.mark.parametrize("V,chunks", [(1, 1), (32, 1), (33, 2), (100, 4), (239, 8)])
def test_chain_solve_plan_by_node_count(V, chunks):
    plan = bs.chain_solve_plan(V)
    assert plan == {"variant": "shared", "threads": 128, "chunks": chunks, "cluster": None,
                    "smem_bytes": 4 * (64 + V * (V | 1) + 2 * V)}


@pytest.mark.parametrize("fn,V", [(bs.lu_factor_plan, 1615), (bs.lu_factor_plan, 2000),
                                  (bs.chain_solve_plan, 28_529), (bs.chain_solve_plan, 40_000)])
def test_plans_raise_where_the_shared_tile_does_not_fit(fn, V):
    """Above the shared tile's limit (V = 241 and 239) the global-memory
    variants take over (``tests/test_torch_dense_scale.py``); a plan raises
    only where their shared memory, the LU's 32-column panel or the chain's
    right-hand side and iterate, does not fit either."""
    with pytest.raises(ValueError, match="shared memory"):
        fn(V)


def test_lu_factor_with_ok_on_cpu_is_factor_ok():
    mats = stage_mats(np.random.default_rng(3), 6, 30, loopy=(4,))
    m = torch.from_numpy(mats)
    lu, ok = bs.lu_factor(m, with_ok=True)
    assert torch.equal(lu.view(torch.int32), bs.lu_factor(m).view(torch.int32))
    assert torch.equal(ok, bs.factor_ok(lu))
    assert ok.tolist() == [True] * 4 + [False, True]
    fact = ops.batched_factor(m.reshape(2, 3, 30, 30))
    assert torch.equal(fact.ok, ok.reshape(2, 3))
