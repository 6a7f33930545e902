"""The sparse route's chain kernel on the CPU side: digest inputs and plans.

``tests/data/torch_card_bsr_digests.json`` holds, for every case of
``_torch_cases.bsr_digest_cases``, the sha256 of the numpy inputs and of
the bytes ``chain_solve_bsr`` wrote on the card (the iterates and the
sweep counts), made with the kernel the cluster design replaced
(``tests/data/make_torch_card_bsr_digests.py``); the card test
``test_bsr_chain_bit_equal_to_card_digests`` and ``chip_smoke.py``'s
``digests`` phase hold the kernel to them bit for bit.  Here the inputs
are regenerated and held to the file's input digests, and, since the
kernel and its plain version share one summation order, the plain version
on the CPU is held to the card's output digests too (the cases small
enough to run here).  The launch plan (cluster size, block rows a CTA,
shared or streamed blocks) is host logic and is checked here.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially

from _torch_cases import (bsr_case_inputs, bsr_digest_cases,  # noqa: E402
                          bsr_digest_inputs, bsr_topology, check_bsr_digest, sha256)
from repro_torch.kernels import sparse_solve as ss  # noqa: E402

DIGESTS = os.path.join(os.path.dirname(__file__), "data", "torch_card_bsr_digests.json")
CASES = bsr_digest_cases()


def _doc():
    with open(DIGESTS) as fh:
        return json.load(fh)


def _ref(case):
    return {c["label"]: c for c in _doc()["cases"]}[case["label"]]


def test_bsr_digest_file_covers_every_case():
    doc = _doc()
    specs = [{k: v for k, v in c.items() if k not in ("inputs", "outputs", "sweeps_total")}
             for c in doc["cases"]]
    assert specs == CASES
    assert doc["device"].startswith("NVIDIA H100")
    assert set(doc["kernel_sources"]) == {"bsr_chain.cu"}
    for c in doc["cases"]:
        assert set(c["outputs"]) == {"x", "sweeps"}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["label"])
def test_bsr_digest_inputs_regenerate(case):
    inputs = bsr_digest_inputs(case)
    assert {k: sha256(v) for k, v in inputs.items()} == _ref(case)["inputs"]
    B, K, V = case["B"], case["K"], case["V"]
    out_nbr, out_mask, blk_nbr, blk_mask = bsr_topology(case["topo"], V)
    assert inputs["vals"].shape == (B, K, V, out_nbr.shape[1])
    assert (inputs["vals"] >= 0).all() and (inputs["vals"][..., ~out_mask] == 0).all()
    assert blk_nbr.shape == {("sw", 1000): (32, 18), ("geant", 1000): (32, 27),
                             ("sw", 100): (4, 4)}[(case["topo"], V)]
    # every link of the strategies lies in an unmasked block
    rows = np.repeat(np.arange(V), out_nbr.shape[1])[out_mask.ravel()] // 32
    cols = out_nbr[out_mask] // 32
    for I, J in set(zip(rows.tolist(), cols.tolist())):
        assert J in blk_nbr[I][blk_mask[I]]


@pytest.mark.parametrize("case", [c for c in CASES if c["B"] * c["V"] <= 3600],
                         ids=lambda c: c["label"])
def test_bsr_plain_version_writes_the_card_digests(case):
    """The plain version on the CPU writes the bytes and sweep counts the
    card's kernel wrote: one summation order, every operation rounded once."""
    rep = check_bsr_digest(case, _ref(case), device="cpu", plain=False)
    assert rep["inputs_equal"]
    assert rep["outputs_equal"], rep["differ"]
    assert rep["sweeps_total"] == _ref(case)["sweeps_total"]
    if case["loops"]:
        # member 1 runs to the cap, member 3 latches at +inf
        assert rep["sweeps_max"] == case["V"] + 2 and rep["not_finite"] >= 1


def test_bsr_dense_phi_puts_the_values_on_the_links():
    case = CASES[-1]
    phi_e, blk_nbr, blk_mask, base, mult = bsr_case_inputs(case, "cpu")
    vals = bsr_digest_inputs(case)["vals"]
    out_nbr, out_mask, _, _ = bsr_topology(case["topo"], case["V"])
    assert phi_e.shape == (case["B"], case["K"], case["V"], case["V"])
    got = np.take_along_axis(phi_e.numpy(), np.broadcast_to(out_nbr, vals.shape), -1)
    assert np.array_equal(np.where(out_mask, got, 0.0), vals)
    assert float(phi_e.sum()) == pytest.approx(float(vals.sum(dtype=np.float64)), rel=1e-5)


@pytest.mark.parametrize("NB,BD,variant,cluster,rows", [
    (32, 18, "shared", 16, 2),       # metro-sw V=1000 (the ladder shape)
    (32, 27, "stream", 16, 2),       # metro-geant V=1000: 2 x 27 blocks do not fit
    (4, 4, "shared", 4, 1),          # sw-queue V=100
    (10, 9, "shared", 16, 1),        # metro-sw V=300
    (19, 14, "shared", 16, 2),       # metro-sw V=600
    (1, 1, "shared", 1, 1),
    (132, 3, "shared", 16, 9),       # V=4200: more block rows a CTA than warps
    (200, 9, "stream", 16, 13),      # V=6400: 13 x 9 blocks do not fit
])
def test_bsr_chain_plan(NB, BD, variant, cluster, rows):
    plan = ss.bsr_chain_plan(NB, BD)
    assert (plan["variant"], plan["cluster"], plan["rows"]) == (variant, cluster, rows)
    assert plan["cluster"] * plan["rows"] >= NB and plan["threads"] == 256
    blocks = 0 if variant == "stream" else rows * BD * 32 * 33
    assert plan["smem_bytes"] == 4 * (blocks + 2 * NB * 32 + rows * 32 + rows * BD * 32
                                      + 32 + 2 * rows * BD)
    assert plan["smem_bytes"] <= 232_448
