#!/usr/bin/env python3
"""The serving path alone on one card: ``chip_smoke.py``'s ``build``,
``model_kernels``, ``serve``, ``moe`` and ``hybrid`` phases, in that order.

    python3 scripts/serve_phases.py [--phases model_kernels,serve,moe,hybrid]

Prints the card's ``nvidia-smi`` name and power limit, then the phases'
JSON lines as ``chip_smoke.py`` prints them (the model kernels against
their plain versions; the cached prefill and decode checks of
internlm2-1.8b, mamba2-780m and gemma2-9b at full width, the decode step
timed at each check's cache, the engine, the blockwise forward, the
launcher; mixtral-8x22b's MoE layer, drops, forwards, cached decode and
engine; jamba-v0.1-52b's forward, cached decode and engine), and last one
line with each kernel's launches over the cached prefills and mixtral's
and jamba's forwards and each phase's seconds.  ``build`` always runs;
``--phases`` picks the others (``--phases moe``: the MoE phase alone;
``--phases model_kernels,hybrid``: the kernels and the hybrid).  It fails
where a check of those phases fails.  A few minutes on one H100
(``--phases moe``: about 2 with the build), against the whole smoke's
14-20.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src"), os.path.join(HERE, "tests")]

import chip_smoke as cs  # noqa: E402

PHASES = {"model_kernels": lambda: cs.phase_model_kernels(None),
          "serve": cs.phase_serve, "moe": cs.phase_moe, "hybrid": cs.phase_hybrid}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated, run in this script's order "
                         f"(default: {','.join(PHASES)})")
    args = ap.parse_args(argv)
    picked = args.phases.split(",")
    unknown = sorted(set(picked) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {list(PHASES)}")
    if not torch.cuda.is_available():
        print("serve_phases: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets the TF32 flags)

    t0 = time.perf_counter()
    print(cs.phase_device(), flush=True)
    cs.phased("build", cs.phase_build, None)
    launches = {}
    for name, fn in PHASES.items():
        if name in picked:
            launches[name] = cs.phased(name, fn)
    cs.emit({"launches": {k: v for k, v in launches.items() if k != "model_kernels"},
             "seconds": cs.PHASE_SECONDS, "total_s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
