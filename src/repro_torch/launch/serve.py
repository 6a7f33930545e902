"""Serving launcher: batched requests through the continuous-batching engine
(reduced config unless ``--full-width``), the inference side end to end,
on CUDA unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --requests 8 --max-new 16 [--device cpu] [--full-width]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.network import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published configuration, not the reduced one")
    args = ap.parse_args(argv)

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"serve: {exc}", file=sys.stderr)
        return 1
    cfg = configs.get(args.arch, reduced=not args.full_width)
    model = Model(cfg, device=dev).init(0)
    eng = ServeEngine(model, slots=args.slots, max_len=128)

    rng = np.random.default_rng(0)
    t0 = time.time()
    uids = [
        eng.submit(rng.integers(0, cfg.vocab, size=args.prompt_len),
                   max_new=args.max_new)
        for _ in range(args.requests)
    ]
    done = eng.run()
    dt = time.time() - t0
    toks = sum(len(v) for v in done.values())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"served {len(done)}/{len(uids)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks / dt:.1f} tok/s on {where})")
    for uid in sorted(done):
        print(f"  req {uid}: {done[uid]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
