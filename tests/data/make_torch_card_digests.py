"""Regenerate ``torch_card_dense_digests.json``: digests of the dense
route's two CUDA kernels' outputs on the card.

For every case of ``tests/_torch_cases.dense_digest_cases`` the file holds
the sha256 of the numpy inputs and of the bytes that ``lu_factor`` (packed
factors and ``factor_ok``'s flags) and ``chain_solve`` write on the card.
The kernels of ``src/repro_torch/kernels/csrc`` are held to them bit for
bit (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase ``digests``),
so a redesign of either kernel must keep every float operation and its
order.  The file records the sha256 of the kernel sources it was made
with.  Run on the card, from the repository root (no JAX needed):

    PYTHONPATH=src:tests python tests/data/make_torch_card_digests.py [OUT]
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_card_dense_digests.json")
SOURCES = ("batched_lu.cu", "chain_solve.cu", "two_sweep.cuh")


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
    x = bs.chain_solve(t["lu"], t["base"], t["mult"], trans=case["trans"],
                       reverse=case["reverse"], clamp=case["clamp"])
    torch.cuda.synchronize()
    return {"x": x.cpu().numpy()}


def main(out: str) -> None:
    import torch
    from _torch_cases import dense_digest_cases, digest_inputs, sha256
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("make_torch_card_digests: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cases = []
    for case in dense_digest_cases():
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
                              .hexdigest() for name in SOURCES},
           "cases": cases}
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out}: {len(cases)} cases")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else OUT)
