"""Where a blocked-set kernel's time goes, phase by phase, on one CUDA card.

    python3 scripts/blocked_set_phases.py [--clusters 1,2,4,8,16] [--csrc DIR] [--out FILE]

Builds ``csrc/tagged.cu`` and ``csrc/tagged_nbr.cu`` with their phase
stamps compiled in (``-DREPRO_BLOCKED_STAMPS``) into
``build/blocked_set_phases/``: thread 0 of each CTA reads the card's
``%globaltimer`` (ns) at its start, after the shared memory is set, after
the bits are formed, after the cluster barrier, after the fixed point and
after its rows of the mask are written (a CTA barrier there; the tagged
flags, not asked for here, come after).  Runs
them on the inputs of ``chip_smoke.py``'s cases: the sw-queue iterate and
its congested variant (B = 90, V = 100), the first ladder rung of
``without_sparse(metro_instance("sw", V))`` at V = 300 and 1000 (B = 9),
metro-sw V = 1000 at ``init_phi`` and congested sw-queue on the neighbor
lists, at the wrappers' cluster size and at the others ``--clusters``
names.  Each output is checked against the plain version.  One JSON line a
(case, cluster size): device ms a launch (``torch.profiler``, 20 calls), the
CTAs' start spread and span, the rounds, and each phase's median and
largest duration over the CTAs in µs (``init``, ``form``, ``csync``,
``rounds``, ``write``, ``cta``).  The stamps cost a few instructions a CTA.
``--csrc DIR`` builds the two sources (and the ``blocked_sets.cuh`` beside
them) from ``DIR`` in place of the package's, into
``build/blocked_set_phases/variant/``: a design change of the kernels, timed
phase by phase on the same inputs, against a run without it in one call.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "blocked_set_phases")
PHASES = ("init", "form", "csync", "rounds", "write")


def build(csrc, out):
    """One ``nvcc`` per source of ``csrc`` into ``out``, both at once, with
    the stamps compiled in (``-DREPRO_BLOCKED_STAMPS``, see
    ``csrc/blocked_sets.cuh``): {name: loaded library}."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in ("tagged", "tagged_nbr"):
        so = os.path.join(out, name + ".so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DREPRO_BLOCKED_STAMPS", "-o", so,
               os.path.join(csrc, name + ".cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def cases():
    """(label, instance, phi_e, pdt, sparse) on the card."""
    from repro_torch.core import engine, gp, marginals, network

    out = []
    inst = network.table_ii_instance("sw-queue")
    phi = gp.solve(inst, alpha=0.1, max_iters=10, patience=10**6, tol=0.0).phi
    out.append(("sw-queue-iterate", inst, phi.e, marginals.marginals(inst, phi).pdt, False))
    hot = network.table_ii_instance("sw-queue", rate_scale=4.0)
    hp = gp.solve(hot, alpha=0.1, max_iters=3, patience=10**6, tol=0.0).phi
    out.append(("sw-queue-congested", hot, hp.e,
                marginals.marginals(hot, gp.init_phi(hot)).pdt, False))
    for V in (300, 1000):
        d = network.without_sparse(network.metro_instance("sw", V))
        p0 = gp.init_phi(d)
        cands, _, _ = engine.ladder_candidates(d, p0, 0.1)
        out.append((f"metro-sw-V{V}-dense", d, cands.e[1].contiguous(),
                    marginals.marginals(d, p0).pdt, False))
    metro = network.metro_instance("sw", 1000)
    mp = gp.init_phi(metro)
    out.append(("metro-sw", metro, mp.e, marginals.marginals(metro, mp).pdt, True))
    hs = network.with_sparse(network.table_ii_instance("sw-queue", rate_scale=2.0))
    hsp = gp.solve(hs, alpha=0.1, max_iters=10, patience=10**6, tol=0.0).phi
    out.append(("sw-queue-congested-nbr", hs, hsp.e,
                marginals.marginals(hs, gp.init_phi(hs)).pdt, True))
    return out


def device_ms(fn, calls=20):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "tagged_" in e.key]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / n if n else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", default="", help="other cluster sizes to run, e.g. 4,8")
    ap.add_argument("--csrc", default=CSRC,
                    help="build tagged.cu and tagged_nbr.cu from this directory (a variant "
                         "of the kernels' sources) in place of the package's")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("blocked_set_phases: no CUDA device", file=sys.stderr)
        return 1
    csrc = os.path.abspath(args.csrc)
    libs = build(csrc, OUT if csrc == CSRC else os.path.join(OUT, "variant"))
    from repro_torch.core import engine
    from repro_torch.kernels import blocked_sets as bset
    from repro_torch.kernels import sparse_solve as ss

    vp, i = ctypes.c_void_p, ctypes.c_int
    dense = libs["tagged"].repro_tagged_dense
    dense.argtypes, dense.restype = [vp] * 6 + [i] * 5 + [ctypes.c_float, i, vp], i
    nbr = libs["tagged_nbr"].repro_tagged_nbr
    nbr.argtypes, nbr.restype = [vp] * 8 + [i] * 6 + [ctypes.c_float, i, i, vp], i
    eps = engine.BLOCK_EPS
    extra = [int(c) for c in args.clusters.split(",") if c]
    lines = []
    for label, inst, pe, pdt, sparse in cases():
        V = inst.V
        pe3, pd2 = pe.reshape(-1, V, V).contiguous(), pdt.reshape(-1, V).contiguous()
        adj3 = inst.adj.reshape(-1, V, V).contiguous()
        B, per, W = pe3.shape[0], pe3.shape[0] // adj3.shape[0], -(-V // 32)
        D = inst.out_nbr.shape[1] if sparse else 0
        want = (ss.blocked_nbr_plain(pe3, pd2, adj3, inst.out_nbr, inst.out_mask, eps=eps)
                if sparse else bset.blocked_dense_plain(pe3, pd2, adj3, eps=eps))
        out = torch.empty((B, V, V), dtype=torch.bool, device="cuda")
        vec = int(V % 4 == 0)
        plan_c = bset.cluster_for(V)
        for C in sorted({plan_c, *[c for c in extra if c < 2 * W]}):
            WR = -(-W // C)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                if sparse:
                    return nbr(pe3.data_ptr(), pd2.data_ptr(), adj3.data_ptr(),
                               inst.out_nbr.data_ptr(), inst.out_mask.data_ptr(), out.data_ptr(),
                               None, None, B, V, D, per, C, WR, eps, vec, 0, stream)
                return dense(pe3.data_ptr(), pd2.data_ptr(), adj3.data_ptr(), out.data_ptr(),
                             None, None, B, V, per, C, WR, eps, vec, stream)

            if call() != 0:
                raise RuntimeError(f"{label} C={C}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{label} C={C}: the mask differs from the plain version")
            ms = device_ms(call)
            call()
            torch.cuda.synchronize()
            n = B * C
            buf = (ctypes.c_ulonglong * (8 * n))()
            lib = libs["tagged_nbr" if sparse else "tagged"]
            stamps = lib.repro_blocked_stamps
            stamps.argtypes, stamps.restype = [vp, i], i
            if stamps(ctypes.cast(buf, vp), n) != 0:
                raise RuntimeError("reading the stamps failed")
            rows = [list(buf[8 * k:8 * k + 8]) for k in range(n)]
            t0 = min(r[0] for r in rows)
            phases = {name: [r[k + 1] - r[k] for r in rows] for k, name in enumerate(PHASES)}
            phases["cta"] = [r[5] - r[0] for r in rows]
            line = {"case": label, "kernel": "tagged_nbr" if sparse else "tagged", "B": B,
                    "V": V, "cluster": C, "plan": C == plan_c, "device_ms": ms,
                    "span_us": (max(r[5] for r in rows) - t0) / 1e3,
                    "start_spread_us": (max(r[0] for r in rows) - t0) / 1e3,
                    "rounds": max(r[6] for r in rows),
                    **{f"{k}_med_us": statistics.median(x) / 1e3 for k, x in phases.items()},
                    **{f"{k}_max_us": max(x) / 1e3 for k, x in phases.items()}}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
