"""The dense route's large-V kernels on the CPU side: digest inputs.

``tests/data/torch_card_dense_scale_digests.json`` holds, for every case of
``_torch_cases.dense_scale_digest_cases`` (``lu_factor`` and ``chain_solve``
at V = 300, 600 and 1000 in their global-memory variants, ``lu_factor`` at
V = 1100 and 1614, ``chain_solve`` at V = 2049, and ``lu_solve`` by
strips), the sha256 of the numpy inputs and of the bytes the card's
kernels wrote.  It was recorded on the card from the kernels as at commit
8ee676d, before their redesign on thread-block clusters, by
``tests/data/make_torch_card_digests.py --scale``; the card tests and
``chip_smoke.py`` hold the redesigned kernels to those output digests bit
for bit.  Here the inputs are regenerated, once per distinct input, and
held to the file's input digests, so that input drift shows on the CPU and
not as a kernel mismatch on the card.
"""

import json
import os

import numpy as np
import pytest

from _torch_cases import (case_id, dense_scale_cases, dense_scale_digest_cases,
                          digest_inputs, digest_key, sha256)

DIGESTS = os.path.join(os.path.dirname(__file__), "data",
                       "torch_card_dense_scale_digests.json")


def _doc():
    with open(DIGESTS) as fh:
        return json.load(fh)


def _distinct_inputs():
    """One case per distinct input (the trans/reverse/clamp variants share
    theirs)."""
    seen = {}
    for c in dense_scale_digest_cases():
        seen.setdefault(digest_key(c), c)
    return list(seen.values())


def test_scale_digest_file_covers_every_case():
    doc = _doc()
    specs = [{k: v for k, v in c.items() if k not in ("inputs", "outputs")}
             for c in doc["cases"]]
    assert specs == dense_scale_digest_cases()
    assert specs[:len(dense_scale_cases())] == dense_scale_cases()
    assert doc["device"].startswith("NVIDIA H100")
    assert set(doc["kernel_sources"]) == {"batched_lu.cu", "chain_solve.cu", "lu_solve.cu",
                                          "strip_sweep.cuh"}
    for c in doc["cases"]:
        want = {"lu", "ok"} if c["kernel"] == "lu_factor" else {"x"}
        assert set(c["outputs"]) == want
    assert {c["V"] for c in doc["cases"] if c["kernel"] == "lu_solve"} == {300, 600, 1000}


@pytest.mark.parametrize("case", _distinct_inputs(), ids=case_id)
def test_scale_digest_inputs_regenerate(case):
    ref = {case_id(c): c for c in _doc()["cases"]}[case_id(case)]
    inputs = digest_inputs(case)
    assert {k: sha256(v) for k, v in inputs.items()} == ref["inputs"]
    B, V = case["B"], case["V"]
    if case["kernel"] == "lu_factor":
        assert inputs["mats"].shape == (B, V, V) and inputs["mats"].dtype == np.float32
        return
    lu = inputs["lu"]
    fin = np.isfinite(lu).reshape(B, -1).all(axis=1)
    loopy = np.zeros(B, dtype=bool)
    loopy[case["loopy"]] = True
    assert np.array_equal(fin, ~loopy)
    if case["kernel"] == "lu_solve":
        assert lu.shape == (B, V, V) and inputs["rhs"].shape == (B, V)
    else:
        K = case["K"]
        assert lu.shape == (B, K, V, V) and inputs["base"].shape == (B, K, V)
