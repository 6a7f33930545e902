"""Regenerate ``torch_card_bsr_digests.json``: digests of the sparse
route's blocked chain kernel (``bsr_chain``) on the card.

For every case of ``tests/_torch_cases.bsr_digest_cases`` the file holds
the sha256 of the numpy inputs and of the bytes ``chain_solve_bsr`` writes
on the card: the iterates ``x`` and the per-stage sweep counts.  The
kernel of ``src/repro_torch/kernels/csrc/bsr_chain.cu`` is held to them
bit for bit (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
``digests``), so a redesign must keep every float operation and its order.
The file records the sha256 of the kernel source it was made with (the
file in the repository was made with the kernel of commit f4ca93a).  Run on
the card, from the repository root (no JAX needed):

    PYTHONPATH=src:tests python tests/data/make_torch_card_bsr_digests.py [OUT]
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_card_bsr_digests.json")


def card_outputs(case) -> dict:
    """{name: numpy array} of the kernel's outputs on the card."""
    import torch
    from _torch_cases import bsr_case_inputs
    from repro_torch.kernels import sparse_solve as ss

    phi_e, blk_nbr, blk_mask, base, mult = bsr_case_inputs(case, torch.device("cuda"))
    x, sweeps = ss.chain_solve_bsr(phi_e, blk_nbr, blk_mask, base, mult, trans=case["trans"],
                                   reverse=case["reverse"], clamp=case["clamp"],
                                   with_sweeps=True)
    torch.cuda.synchronize()
    return {"x": x.cpu().numpy(), "sweeps": sweeps.cpu().numpy()}


def main(out: str) -> None:
    import torch
    from _torch_cases import bsr_digest_cases, bsr_digest_inputs, sha256
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("make_torch_card_bsr_digests: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cases = []
    for case in bsr_digest_cases():
        inputs = bsr_digest_inputs(case)
        outputs = card_outputs(case)
        cases.append({**case, "inputs": {k: sha256(v) for k, v in inputs.items()},
                      "outputs": {k: sha256(v) for k, v in outputs.items()},
                      "sweeps_total": int(outputs["sweeps"].sum())})
        print(json.dumps({"case": case["label"], "outputs": cases[-1]["outputs"],
                          "sweeps_total": cases[-1]["sweeps_total"]}), flush=True)
    doc = {"about": "sha256 of the bsr_chain kernel's inputs and card outputs; "
                    "see tests/data/make_torch_card_bsr_digests.py",
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "kernel_sources": {"bsr_chain.cu": hashlib.sha256(
               (_build.CSRC / "bsr_chain.cu").read_bytes()).hexdigest()},
           "cases": cases}
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out}: {len(cases)} cases")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else OUT)
