"""Regenerate the card digests of the dense route's CUDA kernels' outputs.

``torch_card_dense_digests.json`` (default): for every case of
``tests/_torch_cases.dense_digest_cases`` (V up to 240: the register and
shared-memory variants) the sha256 of the numpy inputs and of the bytes
that ``lu_factor`` (packed factors and ``factor_ok``'s flags) and
``chain_solve`` write on the card.  ``torch_card_dense_scale_digests.json``
(``--scale``): the same for every case of
``_torch_cases.dense_scale_digest_cases`` (V = 300, 600 and 1000: the
global-memory variants of ``lu_factor`` and ``chain_solve``, and
``lu_solve`` by strips; ``lu_factor`` at V = 1100 and 1614 and
``chain_solve`` at V = 2049).  The kernels of ``src/repro_torch/kernels/csrc``
are held to them bit for bit (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase ``digests``), so a redesign of any of them must keep
every float operation and its order.  Each file records the sha256 of the
kernel sources it was made with.  Run on the card, from the repository root
(no JAX needed):

    PYTHONPATH=src:tests python tests/data/make_torch_card_digests.py [--scale] [OUT]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_card_dense_digests.json")
OUT_SCALE = os.path.join(HERE, "torch_card_dense_scale_digests.json")
SOURCES = ("batched_lu.cu", "chain_solve.cu", "two_sweep.cuh")
SOURCES_SCALE = ("batched_lu.cu", "chain_solve.cu", "lu_solve.cu", "strip_sweep.cuh")


def card_outputs(case, inputs) -> dict:
    """{name: numpy array} of the kernels' outputs on the card."""
    import torch
    from _torch_cases import np
    from repro_torch.kernels import batched_solve as bs

    dev = torch.device("cuda")
    if case["kernel"] == "lu_factor":
        lu = bs.lu_factor(torch.from_numpy(inputs["mats"]).to(dev))
        ok = bs.factor_ok(lu)
        torch.cuda.synchronize()
        return {"lu": lu.cpu().numpy(), "ok": ok.cpu().numpy().astype(np.uint8)}
    t = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    if case["kernel"] == "lu_solve":
        x = bs.lu_solve(t["lu"], t["rhs"], trans=case["trans"])
    else:
        x = bs.chain_solve(t["lu"], t["base"], t["mult"], trans=case["trans"],
                           reverse=case["reverse"], clamp=case["clamp"])
    torch.cuda.synchronize()
    return {"x": x.cpu().numpy()}


def main(out: str, scale: bool) -> None:
    import torch
    from _torch_cases import (dense_digest_cases, dense_scale_digest_cases, digest_inputs,
                              sha256)
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("make_torch_card_digests: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cases = []
    for case in (dense_scale_digest_cases() if scale else dense_digest_cases()):
        inputs = digest_inputs(case)
        outputs = card_outputs(case, inputs)
        cases.append({**case, "inputs": {k: sha256(v) for k, v in inputs.items()},
                      "outputs": {k: sha256(v) for k, v in outputs.items()}})
        print(json.dumps({"case": cases[-1]["kernel"], "V": case["V"], "B": case["B"],
                          "outputs": cases[-1]["outputs"]}), flush=True)
    doc = {"about": "sha256 of the dense kernels' inputs and card outputs; "
                    "see tests/data/make_torch_card_digests.py",
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "kernel_sources": {name: hashlib.sha256((_build.CSRC / name).read_bytes())
                              .hexdigest() for name in (SOURCES_SCALE if scale else SOURCES)},
           "cases": cases}
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out}: {len(cases)} cases")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", action="store_true",
                    help="the V = 300 to 2049 cases (torch_card_dense_scale_digests.json)")
    ap.add_argument("out", nargs="?", help="where to write (default: the file named above)")
    args = ap.parse_args()
    main(args.out or (OUT_SCALE if args.scale else OUT), args.scale)
