#!/usr/bin/env python3
"""The serving path alone on one card: ``chip_smoke.py``'s ``build``,
``model_kernels`` and ``serve`` phases, in that order.

    python3 scripts/serve_phases.py

Prints the card's ``nvidia-smi`` name and power limit, then the phases'
JSON lines as ``chip_smoke.py`` prints them (the cached prefill and decode
checks of internlm2-1.8b, mamba2-780m and gemma2-9b at full width, the
decode step timed at each check's cache, the engine, the blockwise
forward, the launcher), and last one line with each kernel's launches over
the cached prefills and each phase's seconds.  It fails where a check of
those phases fails.  About 4 minutes, against the whole smoke's 13-15.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src"), os.path.join(HERE, "tests")]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serve_phases: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets the TF32 flags)

    t0 = time.perf_counter()
    print(cs.phase_device(), flush=True)
    cs.phased("build", cs.phase_build, None)
    cs.phased("model_kernels", cs.phase_model_kernels, None)
    launches = cs.phased("serve", cs.phase_serve)
    cs.emit({"serve_launches": launches, "seconds": cs.PHASE_SECONDS,
             "total_s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
