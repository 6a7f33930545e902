#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what it computes.

    python3 chip_smoke.py [--prev DIR] [--parent TREE]

Runs from the root of a checkout and needs one card; it builds the port's
CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` into
``build/repro_torch_kernels/``.  ``--prev DIR`` names a directory holding
earlier versions of the redesigned kernels: ``bsr_chain.cu`` (as at
commit f4ca93a), ``batched_lu.cu``, ``chain_solve.cu`` and
``strip_sweep.cuh`` (as at commit 8ee676d: the global-memory variants
before their clusters), ``flash_attention.cu`` and ``ssd_chunk.cu`` (as at
commit 14c1039), ``tagged.cu`` and ``tagged_nbr.cu`` (as at commit
5b53a6a: the packed-word and gathered-bool kernels, before the blocked
sets became one launch), unpacked with ``git show``: those DIR holds are
built beside the others and timed against the redesigned kernels in the
``kernel`` (sw-queue, metro-sw and V = 300 / 600 / 1000) and
``model_kernels`` phases.  ``--parent TREE`` (a checkout of the parent
commit, e.g. ``git archive`` under ``build/``) adds the ``versus_parent``
phase.  One JSON line per
phase:

  1. device  — ``nvidia-smi`` name and power limit, torch/CUDA versions, TF32.
  2. build   — the nine kernels, one ``nvcc`` each, all started together
     (with ``--prev``, the earlier sources too); ``ptxas`` registers and
     spills of each kernel.
  3. kernels — each kernel against its plain PyTorch version on the card, at
     the shapes Algorithm 1 gives it on sw-queue (V=100, 30 apps, 3 stages),
     on the inputs of a 10-iteration iterate and its ladder candidates:
     lu_factor at B=90 (the iterate) and B=1080 (the 12-rung ladder);
     chain_solve for the traffic sweep (30 chains, trans=1), the marginal
     sweep (30 chains, trans=0, reverse, clamp) and the ladder (360 chains);
     tagged (the dense blocked-set kernel: ``phi_e``, ``pdt`` and ``adj`` in,
     the (B, V, V) blocked mask out) at B=90 on the iterate and on congested
     inputs.  Float kernels within 1e-5 relative (they sum in another order
     and fuse multiply-adds), tagged bool-equal (mask and tagged flags, the
     flags also the dense sweep's) and one launch, the kernel alone in the
     profiler's trace; ``lu_factor``'s own ``ok`` flags equal to
     ``factor_ok`` of its factors.  With
     ``--prev``, ``lu_factor`` and ``chain_solve`` also against their earlier
     versions (commit 8ee676d; these variants are unchanged there) on the
     same inputs: output bytes equal, and ``prev_ms`` the earlier kernel's
     device time per launch, timed in turns (earlier, new, new, earlier;
     ``abba_ms``); ``tagged`` against the composition of commit 5b53a6a it
     replaces (route, worse and improper as tensors, packed words, the
     earlier kernel, unpacking, the four-term OR): the same mask, and
     ``prev_ms`` / ``prev_launches_per_call`` the composition's whole
     device time and launches per call, in turns.  ``ms`` is
     the kernel's device time per launch from ``torch.profiler`` (the
     per-call event time if the trace shows no device events);
     ``event_ms``, ``plain_ms`` and ``library_ms`` are per call: CUDA
     events around a run of back-to-back calls, median of 25 runs after a
     warm-up.
  3b. digests — ``lu_factor`` (factors and ``ok``) and ``chain_solve`` on
     every case of ``tests/data/torch_card_dense_digests.json`` (the card
     digests of commit 2e984dd's kernels; the register and shared-memory
     variants of ``lu_factor``, V from 1 to 240) and, with ``lu_solve`` by
     strips, of ``tests/data/torch_card_dense_scale_digests.json`` (commit
     8ee676d's global-memory variants at V = 300, 600, 1000, before their
     clusters): output bytes equal to the digests, within 1e-5 of the plain
     versions; and ``bsr_chain`` on every case of
     ``tests/data/torch_card_bsr_digests.json`` (the earlier kernel: the
     metro-sw ladder shape, metro-geant, the loopy sw-queue ladder, every
     trans/reverse/clamp variant): iterates and sweep counts bit-equal to
     the digests and to the plain version; a mismatch names the outputs and
     the largest difference against the plain version.
  4. solve   — the main path, ``gp.solve(table_ii_instance("sw-queue"),
     alpha=0.1, max_iters=400)`` on the card, with every kernel's launch
     count set to 0 just before and read just after; then held against the
     JAX reference's solve (``tests/data/torch_ref_sw_queue.json``): cost
     history prefix and final cost within 1e-5, and both iteration counts
     reproduced by replaying the stall latch on each history, whose first
     disagreement must fall where the two costs differ by less than the
     latch's own 1e-6 threshold.
  5. profile — ``torch.profiler`` over one 32-step chunk of the main path:
     device time per step by kernel, launches per step, and the device's
     idle share against the solve phase's unprofiled ms per step.
  6. parity  — the same trajectory with the stall latch off, over the
     reference's iteration count: same count, cost history within 1e-5.
  7. sparse kernels — the metro path's two kernels against their plain
     versions on the card: ``bsr_chain`` (the blocked chain solve) on
     metro-sw V=1000 at ``init_phi`` (traffic, marginal and the 36-member
     ladder sweeps), on metro-geant V=1000 (traffic, the widest block
     rows) and on the congested sw-queue ladder (rate_scale 2) with
     routing loops put into three members; ``tagged_nbr`` (the
     neighbor-list blocked-set kernel, the whole mask in one launch) on
     metro-sw V=1000 and on congested sw-queue inputs.  Values within 1e-5
     with the same +inf entries and the same sweep counts (kernel and plain
     version share one summation order); tagged_nbr bool-equal (mask,
     tagged flags and round counts; the mask also the dense kernel's), and
     with ``--prev`` against commit 5b53a6a's composition as ``tagged``.  The ``bsr_chain``
     wrapper launches its kernel alone (it reads ``phi_e``; no gather):
     ``gather_ms_before`` is the ``block_values`` gather the earlier kernel
     needed.  With ``--prev``, the earlier kernel on the same inputs: bit-equal
     iterates and sweep counts, timed in turns kernel against kernel
     (``abba_ms``) and gather plus kernel against the new kernel
     (``abba_with_gather_ms``).
  8. metro   — the second main path, ``gp.solve(metro_instance("sw",
     1000))``, on the sparse route, with every launch count set to 0 just
     before the default solve and read just after: ``bsr_chain`` and
     ``tagged_nbr`` launched on every step, the dense kernels never.  Held
     against the JAX reference (``tests/data/torch_ref_metro_sw1000.npz``):
     stage traffic and ``dD/dt`` at ``init_phi`` within 1e-5 relative to
     max(|ref|, 1), the default solve's iteration count equal and its cost
     history within 1e-5, a 32-step latch-off solve's cost history within
     1e-5.
  9. metro_profile — ``torch.profiler`` over one 32-step chunk of the
     metro solve: device time per step, top device operations, idle share
     against the metro phase's unprofiled ms per step.
  9b. kernel (dense, large V) — ``lu_factor`` (32-column panels, a
     cluster of CTAs a member), ``chain_solve`` (32-row strips, a cluster a
     chain, a warp a strip), ``lu_solve`` (32-row strips) and ``tagged``
     (a cluster of 16 CTAs a row batch) against their plain versions at
     V = 300, 600 and 1000, on the ladder candidates and stage systems of
     ``without_sparse(metro_instance("sw", V))`` (within 1e-5, ``ok`` flags
     equal; ``torch.linalg.lu_factor`` / ``lu_solve`` beside them) and on
     the seeded cases of ``_torch_cases.dense_scale_cases``.  With
     ``--prev``, ``lu_factor`` and ``chain_solve`` also against commit
     8ee676d's single-block variants on the same ladder inputs: output bytes
     equal, ``prev_ms``, ``abba_ms`` and ``speedup``.
  9c. dense_scale — ``gp.solve(without_sparse(metro_instance("sw", V)))``
     at V = 300 and 600 on the dense route, its launches counted, against
     the port's sparse route on the same instance (default and latch-off
     solves, one step's rung costs and every ladder candidate's flows,
     within 1e-5) and at V=300 against the reference's ``solver="dense"``
     solve (``tests/data/torch_ref_dense_sw300.npz``).

  10. model_kernels — the edge-serving path's two kernels against their plain
     versions on the card, within 2e-5 of the plain version's largest
     |value|: ``flash_attention`` at internlm2-1.8b's full width (B=4,
     H=16, KV=8, S=2048, hd=128) causal, with a 512-token window, at
     S=2000 (padded to 2048), and at hd=64 (32 heads, 4 KV heads);
     ``ssd_chunk`` at mamba2-780m's (B=4, 16 chunks of 128, H=48, P=64,
     N=128, one B/C group), at one chunk, and through ``ops.ssd_chunk`` at
     a 32-token prefill it pads to 128 rows.  ``library_ms`` of the
     attention is ``scaled_dot_product_attention`` in float32 (timed only).
     Both kernels form their products on the tensor cores in three-term
     TF32 (float32-accurate; no PyTorch product uses TF32): each row also
     gives the kernel's and the plain version's largest error against the
     plain version evaluated in float64 (``max_rel_err_f64``,
     ``plain_max_rel_err_f64``), and ``bound_tc_ms``, the bound at the
     three-term rate (495 / 3 TFLOP/s; for ``ssd_chunk`` with C B^T once
     per chunk and group) beside ``bound_ms`` at the CUDA cores' 67.  With
     ``--prev``, the earlier kernels (commit 14c1039, float32 CUDA cores)
     on the same inputs: their float64 error (``prev_max_rel_err_f64``)
     and device ms timed in turns (``prev_ms``, ``abba_ms``, ``speedup``);
     not bit-equal, since the tensor-core products round otherwise.
  11. edge    — the paper's DNN vertical split (``tests/data/torch_ref_edge.json``):
     the two-chain instance (internlm2-1.8b and mamba2-780m cut in 2
     segments, 2048 tokens per packet, on Abilene) built by the port, its
     chains and fields bit-equal to the reference's; the GP step from each
     of the reference's 52 iterates (rung costs, step cost and strategy
     within 1e-5, the rung equal or a float32 tie); the latch-off solve
     within 1e-5 up to its first rung flip, which must be a tie; the
     default solve, its count replayed by the stall latch, its final cost
     beside the reference's (the reference does not converge there: its
     cost oscillates until the stall latch stops it), and where each
     segment is offloaded.  The same chains at a CPU capacity of 0.04,
     where the reference's cost falls at every step: the default solve
     free-running, its count, whole history and final cost within 1e-5.
     Then each model at full width on the card from
     a seed (B=4 packets of 2048 seeded tokens): a monolithic forward with
     the launch counts set to 0 just before and read just after
     (``flash_attention`` 24 times, ``ssd_chunk`` 48 times, nothing
     else), the split forward through the chain's segment bounds with the
     activation packet shipped through host memory (within 1e-6 of the
     monolithic logits), and the forward through the plain versions
     (within 1e-3 relative).
  12. edge_profile — ``torch.profiler`` over one forward of each model:
     device ms in cuBLAS products, ``flash_attention``, ``ssd_chunk`` and
     the rest, and the idle share against the unprofiled forward.

  13. kernel (lu_solve, propagate_step) — the last two kernels against their
     plain versions, within 1e-5 relative: ``lu_solve`` on the sw-queue
     stage factors (B=90 iterate and B=1080 ladder, trans 1 and 0) and at
     V=240 (the shared-memory limit), with ``torch.linalg.lu_solve`` on
     identity pivots beside it; a member made singular on purpose flags inf
     in ``ops.batched_solve`` and leaves the others bit for bit as they are
     alone.  ``propagate_step`` on the stage matrices as propagation
     operators (S=90 and 1080 at V=100) and at the reference bench's S=90,
     V=128, with ``torch.baddbmm`` beside it.
  14. oracle — the two kernels as the solver's oracles on the sw-queue
     10-iteration iterate: the fused chain (traffic trans=1 forward,
     marginals trans=0 reverse clamp) against a per-stage loop of
     ``ops.batched_solve_factored`` launches, and
     ``solve_fixed_point(phi.e[:, 0], r, sweeps=V)`` at ``init_phi`` against
     the stage-0 traffic of ``traffic.flows``, each within 1e-5 relative.
     The only path that runs the two kernels: their launch counts are this
     phase's.
  15. sweep fig6 — ``run_sweep("fig6-congestion", alpha=0.1,
     max_iters=300)`` four ways (GP, ``accel=True``, SPOC and LCOF masks),
     each also one member at a time through ``run_sweep_serial``, and GP
     through ``run_sweep_chained``.  One line per member (final cost,
     iterations, seconds), each held to the reference's golden runs
     (``tests/data/torch_ref_sweep.npz``) under
     ``_torch_cases.sweep_parity`` / ``chained_parity``; batched against
     serial within 1e-4 (GP and the baselines); the paper's claim, GP's
     final cost at most SPOC's and LCOF's within 1e-5, at every scale.
  16. sweep fig5 — the eight Table II networks at ``FIG5_RATE``, full size
     (the V=100 pair included), GP and both baselines, ``alpha=0.1,
     max_iters=250``: the same lines and checks.  Where the reference's own
     GP stops above SPOC (connected-er, geant: its stall latch), the claim
     is held within 1e-4.
  16b. sweep fig7 / ensemble / mixed — ``fig7-packetsize`` (GP, SPOC,
     LCOF), ``seed-ensemble`` (32 Abilene seeds: GP and ``accel=True``) and
     ``mixed-topology`` (GP, SPOC, LCOF) batched (the CPU tests hold their
     one-by-one runs), every member under ``sweep_parity`` with the run from
     a jittered start as its own witness; the members of
     ``_torch_cases.SWEEP_KNOWN_FAULTS["cuda"]`` must fail it, and only as
     recorded (``known_fault_holds``: a known fault that passes, fails
     otherwise, or is not run, fails the phase).  In every sweep phase the
     port's runs from a jittered start (and, for an accelerated member's
     one-by-one line, its one-by-one run from that start) are made only
     for the lines that fail without them.
  16c. online_trace — the event layer (``tests/data/torch_ref_online.npz``):
     for the fig6 fleet (Abilene at the six Fig. 6 scales, two spare
     application slots, 50 events) and the full-width sw-queue fleet (V=100,
     30 + 2 applications, scales 0.5 and 1.0, 16 events), the port's
     ``events.random_trace`` equal to the stored trace event for event and
     every post-event member's fields bit-equal to the stored ones; then
     ``run_sweep("online-trace")`` batched and one by one, one ``sweep``
     line per member under ``sweep_parity`` against the reference's batched
     cold solve, batched against one by one within 1e-4 (but for the
     members of ``_torch_cases.ONLINE_KNOWN_FAULTS["cuda"]``, which must
     fail as recorded: a ``TIE_BRANCH`` line with a run that differs from it
     only by float32 rounding, the member batched with its neighbour or
     from a start moved by one ulp, ending on the reference's branch; their
     one-by-one path's own spread from moved starts is reported), and 32
     batched steps profiled (ms per batched step, device ms and launches per step,
     idle share).  Then the 12 warm re-solves with frozen applications: on
     each event's member, the port's ``repair_phi`` of the reference's live
     strategy within 1e-5 of the reference's, its gate
     (``per_app_residual > 1e-4``) on the reference's repaired strategy
     equal to the reference's (or a witnessed tie), ``gp.solve(app_mask=)``
     under ``sweep_parity`` with the reference's other stage solver and its
     latch-off run as witnesses (the stricter stall-latch contract
     reported as ``latch_contract``), and the same solve stepped one
     iteration a chunk with the frozen applications' rows bit-equal to the
     start's on every committed iterate.  ``lu_factor``, ``chain_solve`` and ``tagged``
     launch in the phase.
  16d. simulate — the packet simulator on Abilene at rate 1.5: on the
     reference's GP strategy the stored ``SimResult`` (``n_delivered`` and
     ``mean_queue_occupancy`` equal, ``mean_delay`` within
     ``_torch_cases.SIM_MEAN_TOL``, ``predicted_delay`` within 1e-5); on
     the port's own GP output Little's law within 30%.
  16e. online_service — the online GP service (``serve/online.py``) against
     the reference's ``OnlineSolver`` runs (``tests/data/
     torch_ref_service.npz``) under ``_torch_cases.event_parity``: every
     event's exact report fields, costs within 1e-5, counts, and each
     re-convergence segment's history within 1e-5 with its count replayed
     by the service's stop test, up to the event's first departure.  The
     fig6 50-event trace teacher-forced from the stored pre-event state of
     each event; then free-running from the port's own cold start (each
     member held up to its first departure, then to the survival claims,
     and every served cost held one-sidedly to the port's cold accelerated
     solve of the post-event instance, the reference's stored one where the
     port's stops uncertified); the four-event sequence of
     ``tests/test_online.py``; the 100-event chaos trace (the port's
     ``chaos_trace`` equal to the stored one) with fault injection and
     ``debug=True``; the parts one after another.  Every departure needs a
     witness that float32 rounding decides it (``_torch_cases.
     departure_witness``: the choice tied in float64, a one-ulp move of the
     departing step's input taking the reference's decision or moving its
     cost as far, or a one-ulp start taking the reference's branch), and
     every event is held to the survival claims.  One line per event, the
     totals beside the reference's, one event profiled (device ms, idle
     share); ``lu_factor``, ``chain_solve`` and ``tagged`` launch.
  17. sweep_profile — ``torch.profiler`` over 32 batched iterations of the
     Fig. 6 family and of Fig. 5's sw-queue group: device time per step by
     kernel, launches per step, idle share.
  18. versus_parent (``--parent TREE`` only) — ``scripts/compare_solve.py
     TREE . --profile`` on the sw-queue solve, 32 metro-sw steps, 32 dense
     V = 300 steps and the batched Fig. 6 GP sweep, parent, change, change,
     parent, each in its own process: wall times, launches and device ms per
     step, and the cost histories' digests, equal in all four runs.

Then the ``kernels`` line (each kernel's ``launches`` counted over the
main path it lies on: the sw-queue default solve for the dense route's
three, the metro-sw one for the sparse route's two, one full-width
forward for the model kernels, and the oracle phase for ``lu_solve`` and
``propagate_step``, which lie on no solver path; ``prev_ms`` and
``prev_commit`` for the seven redesigned kernels, the commit their earlier
versions come from (for ``tagged`` and ``tagged_nbr`` the composition they
replace, with ``prev_launches_per_call``); ``prev_ms`` null for the others and without
``--prev``; ``bound_tc_ms`` for the two model kernels), the card's
``nvidia-smi`` line, and the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the script exits non-zero without the last line.  Without CUDA, or
without the rest of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(HERE, "tests")
GOLDEN = os.path.join(TESTS, "data", "torch_ref_sw_queue.json")
GOLDEN_METRO = os.path.join(TESTS, "data", "torch_ref_metro_sw1000.npz")
GOLDEN_EDGE = os.path.join(TESTS, "data", "torch_ref_edge.json")
GOLDEN_SWEEP = os.path.join(TESTS, "data", "torch_ref_sweep.npz")
DIGESTS = os.path.join(TESTS, "data", "torch_card_dense_digests.json")
SCALE_DIGESTS = os.path.join(TESTS, "data", "torch_card_dense_scale_digests.json")
BSR_DIGESTS = os.path.join(TESTS, "data", "torch_card_bsr_digests.json")
GOLDEN_DENSE = os.path.join(TESTS, "data", "torch_ref_dense_sw300.npz")
GOLDEN_ONLINE = os.path.join(TESTS, "data", "torch_ref_online.npz")
GOLDEN_SERVICE = os.path.join(TESTS, "data", "torch_ref_service.npz")

# The metro phase's final strategy check, entry by entry: strategy entries
# are fractions in [0, 1] (float32 spacing 6e-8 just below 1), and the
# reference's strategy moves by about 1e-4 over its 32 latch-off steps.
PHI_TOL = 1e-6

# Published peaks of one H100 SXM (NVIDIA data sheet), for the bounds.
PEAK_BYTES = 3.35e12        # HBM3, bytes/s
PEAK_FP32 = 67e12           # float32 outside the tensor cores, FLOP/s
# Dense TF32 on the tensor cores (495 TFLOP/s) over the three products of the
# error-compensated split the model kernels use: float32-accurate products.
PEAK_TF32X3 = 495e12 / 3
REPS = 25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = REPS) -> float:
    """Device time per ``fn()`` call: CUDA events around a run of
    back-to-back calls (as many as fill about 2 ms, at most 50), median of
    ``reps`` runs after a warm-up (fewer for the slow plain versions)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = max(1, min(50, int(2e-3 / max(time.perf_counter() - t0, 1e-6))))
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    return statistics.median(out)


EMPTY_TRACES = []   # the function of each trace retaken for having no device event


def device_kernels(fn, calls: int = 1) -> dict:
    """{kernel name: (device ms in all, launches)} of the CUDA kernels that
    ``calls`` runs of ``fn`` launch, from ``torch.profiler`` after a
    warm-up; empty if the trace holds no device events.  A trace with no
    device event at all is taken again, twice at most, and its function is
    recorded in ``EMPTY_TRACES`` (printed before the kernels line): now and then
    one comes back empty on the card, cause not found (the warning
    torch's profiler prints about ``acc_events`` is not it: torch 2.11
    prints it at the first trace of every process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {ev.key: (ev.self_device_time_total / 1e3, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
        if out:
            break
        EMPTY_TRACES.append(getattr(fn, "__qualname__", repr(fn)))
    return out


def kernel_ms(fn, symbol: str):
    """Device time per launch of the kernel named ``symbol`` in 20 calls of
    ``fn`` (``torch.profiler``), or None if the trace does not show it."""
    hits = [v for k, v in device_kernels(fn, 20).items() if symbol in k]
    total = sum(ms for ms, _ in hits)
    return total / sum(n for _, n in hits) if total > 0 else None


def timed(fn, symbol: str) -> dict:
    """``ms``: the kernel's device time per launch where the profiler shows
    it, else the per-call event time; ``event_ms``: per call, launch
    included."""
    ev, dev = time_ms(fn), kernel_ms(fn, symbol)
    return {"ms": ev if dev is None else dev, "event_ms": ev,
            "ms_source": "events" if dev is None else "profiler"}


def bound(nbytes: float, flops: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want, mask=None) -> tuple[float, float]:
    """(max abs error, max error relative to max(|want|, 1))."""
    got, want = got.double(), want.double()
    if mask is not None:
        got, want = got[mask], want[mask]
    d = (got - want).abs()
    return float(d.max()), float((d / want.abs().clamp_min(1.0)).max())


CARD = None      # the card's nvidia-smi name and power limit, for every timing line


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    global CARD
    CARD = smi
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 off")
    return smi


# The sources of the redesigned kernels (``batched_lu`` and ``chain_solve``,
# earlier versions as at commit 8ee676d; ``bsr_chain``, as at commit
# f4ca93a; ``flash_attention`` and ``ssd_chunk``, as at commit 14c1039),
# built from their earlier versions (``--prev DIR``, whichever of them DIR
# holds) to be timed beside the new ones.
PREV_SOURCES = ("batched_lu", "chain_solve", "bsr_chain", "flash_attention", "ssd_chunk",
                "tagged", "tagged_nbr")
PREV_COMMIT_MODELS = "14c1039"
PREV_COMMIT_DENSE = "8ee676d"
PREV_COMMIT_TAGGED = "5b53a6a"
PREV_BUILD = os.path.join(HERE, "build", "prev_kernels")


def phase_build(prev_dir=None):
    """Build the nine kernels (one ``nvcc`` each, all at once); with
    ``prev_dir``, also the earlier ``batched_lu.cu``, ``chain_solve.cu``,
    ``bsr_chain.cu``, ``flash_attention.cu`` and ``ssd_chunk.cu`` found
    there, alongside."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    prev = {}
    if prev_dir:
        os.makedirs(PREV_BUILD, exist_ok=True)
        for src in PREV_SOURCES:
            if not os.path.exists(os.path.join(prev_dir, f"{src}.cu")):
                continue
            out = os.path.join(PREV_BUILD, f"{src}.so")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                   os.path.join(prev_dir, f"{src}.cu")]
            prev[src] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
    report = _build.build_all()
    for src, proc in prev.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"nvcc of the earlier {src}.cu:\n{log}")
    ptxas = {name: [ln.strip() for ln in r["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, r in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {n: r["seconds"] for n, r in report.items()},
          "ptxas": ptxas, "dir": str(_build.BUILD_DIR),
          "prev": sorted(prev) if prev else None})
    return PrevKernels(sorted(prev)) if prev else None


class PrevKernels:
    """The earlier kernels built from ``--prev DIR`` (their own C entry
    points, loaded with ctypes from ``build/prev_kernels``): the earlier
    ``lu_factor`` and ``chain_solve`` (commit 8ee676d, each in the variant
    that commit's launch plan picks by V), ``bsr_chain``
    (commit f4ca93a, which reads the gathered blocks of ``block_values``),
    and ``flash_attention`` and ``ssd_chunk`` (commit 14c1039, on the
    float32 CUDA cores; the same C entry points as the new ones).  ``has``
    names those built."""

    def __init__(self, has):
        import ctypes

        vp, i = ctypes.c_void_p, ctypes.c_int
        self.has = set(has)

        def fn(src, symbol, argtypes):
            f = getattr(ctypes.CDLL(os.path.join(PREV_BUILD, f"{src}.so")), symbol)
            f.argtypes, f.restype = argtypes, i
            return f

        if "batched_lu" in self.has:
            self._lu = fn("batched_lu", "repro_lu_factor", [vp] * 3 + [i] * 3 + [vp])
        if "chain_solve" in self.has:
            self._chain = fn("chain_solve", "repro_chain_solve", [vp] * 4 + [i] * 7 + [vp])
        if "bsr_chain" in self.has:
            self._bsr = fn("bsr_chain", "repro_bsr_chain", [vp] * 6 + [i] * 6 + [vp])
        if "flash_attention" in self.has:
            self._flash = fn("flash_attention", "repro_flash_attention",
                             [vp] * 4 + [i] * 8 + [ctypes.c_float, vp])
        if "ssd_chunk" in self.has:
            self._ssd = fn("ssd_chunk", "repro_ssd_chunk", [vp] * 7 + [i] * 5 + [vp])
        if "tagged" in self.has:
            self._tagged = fn("tagged", "repro_tagged", [vp] * 3 + [i] * 4 + [vp])
        if "tagged_nbr" in self.has:
            self._tagged_nbr = fn("tagged_nbr", "repro_tagged_nbr", [vp] * 5 + [i] * 3 + [vp])

    @staticmethod
    def _stream():
        import torch

        return torch.cuda.current_stream().cuda_stream

    def lu_factor(self, mats):
        """The earlier factors (its ``ok`` flags are not compared here)."""
        import torch
        from repro_torch.kernels import _build

        out = torch.empty_like(mats)
        ok = torch.empty(mats.shape[0], dtype=torch.bool, device=mats.device)
        B, V, _ = mats.shape
        # its plan: registers to V = 128, shared memory while the tile fits, panels
        variant = 0 if V <= 128 else 1 if 4 * V * (V | 1) <= _build.SMEM_LIMIT else 2
        require(self._lu(mats.data_ptr(), out.data_ptr(), ok.data_ptr(), B, V, variant,
                         self._stream()) == 0, "earlier lu_factor launch")
        return out

    def chain_solve(self, lu, base, mult, *, trans=0, reverse=False, clamp=False):
        import torch
        from repro_torch.kernels import _build

        out = torch.empty_like(base)
        B, K, V = base.shape
        # its plan: the factor in shared memory where it fits, else strips
        variant = 0 if 4 * (64 + V * (V | 1) + 2 * V) <= _build.SMEM_LIMIT else 1
        require(self._chain(lu.data_ptr(), base.data_ptr(), mult.data_ptr(), out.data_ptr(),
                            B, K, V, int(trans), int(reverse), int(clamp), variant,
                            self._stream()) == 0, "earlier chain_solve launch")
        return out


    def bsr_chain(self, bvals, blk_nbr, base, mult, *, reverse=False, clamp=False):
        """The earlier kernel on gathered blocks: (x, sweeps)."""
        import torch

        out = torch.empty_like(base)
        sweeps = torch.empty(base.shape[:2], dtype=torch.int32, device=base.device)
        B, K, V = base.shape
        NB, BD = blk_nbr.shape
        require(self._bsr(bvals.data_ptr(), blk_nbr.data_ptr(), base.data_ptr(),
                          mult.data_ptr(), out.data_ptr(), sweeps.data_ptr(), B, K, NB, BD, V,
                          int(reverse) | (int(clamp) << 1), self._stream()) == 0,
                "earlier bsr_chain launch")
        return out, sweeps

    def flash_attention(self, q, k, v, *, causal=True, window=None, seq_len=None):
        """The earlier attention kernel; the wrapper's checks hold for it too."""
        import torch

        out = torch.empty_like(q)
        B, H, S, hd = q.shape
        require(self._flash(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            B, H, k.shape[1], S, hd, S if seq_len is None else int(seq_len),
                            int(causal), 0 if window is None else int(window), hd ** -0.5,
                            self._stream()) == 0, "earlier flash_attention launch")
        return out

    def ssd_chunk(self, xh, dt, cum, Bc, Cc):
        """The earlier SSD kernel: (y, state)."""
        import torch

        Bsz, nc, Q, H, P = xh.shape
        G, N = Bc.shape[3], Bc.shape[4]
        y = torch.empty_like(xh)
        state = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32, device=xh.device)
        require(self._ssd(xh.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bc.data_ptr(),
                          Cc.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz * nc, H, G, P, N,
                          self._stream()) == 0, "earlier ssd_chunk launch")
        return y, state


    def blocked_set(self, adj, phi_e, pdt, eps):
        """The blocked mask as commit 5b53a6a computes it on the dense
        route (its ``engine.blocked_sets`` and ``ops.blocked_tagged``): route,
        worse and improper as V x V tensors, both packed into int32 words by
        int64 arithmetic and padded to Vp rows, its packed-word kernel,
        unpacked, and the four-term OR."""
        import torch
        from repro_torch.kernels import _build
        from repro_torch.kernels import blocked_sets as bset

        route = phi_e > 0.0
        worse = pdt[..., None, :] > pdt[..., :, None] + eps
        improper = route & worse
        lead, V = route.shape[:-2], route.shape[-1]
        Vp, W = bset.padded_nodes(V)

        def packed(x):
            bits = bset.pack_bits(x.reshape(-1, V, V))
            pad = bits.new_zeros((bits.shape[0], Vp - V, bits.shape[2]))
            return torch.cat([bits, pad], dim=1).contiguous()

        r, i = packed(route), packed(improper)
        words = torch.empty((r.shape[0], W), dtype=torch.int32, device=r.device)
        # its plan: both word matrices in shared memory where they fit
        variant = 0 if 4 * (2 * Vp * W + 2 * W) <= _build.SMEM_LIMIT else 1
        require(self._tagged(r.data_ptr(), i.data_ptr(), words.data_ptr(), r.shape[0], Vp, W,
                             variant, self._stream()) == 0, "earlier tagged launch")
        tagged = bset.unpack_bits(words, V).reshape(lead + (V,))
        return (~adj[..., None, None, :, :]) | improper | worse | tagged[..., None, :]

    def blocked_set_nbr(self, adj, phi_e, pdt, nbr, mask, eps):
        """The sparse route's blocked mask as commit 5b53a6a computes it:
        V x V route, worse and improper, both gathered onto the neighbor
        lists, its gathered-bool kernel, and the four-term OR."""
        import torch

        route = phi_e > 0.0
        worse = pdt[..., None, :] > pdt[..., :, None] + eps
        improper = route & worse
        lead, V = route.shape[:-2], route.shape[-1]
        idx = nbr.expand(route.reshape(-1, V, V).shape[:1] + nbr.shape)
        rv = torch.gather(route.reshape(-1, V, V), -1, idx) & mask
        iv = torch.gather(improper.reshape(-1, V, V), -1, idx)
        B, _, D = rv.shape
        out = torch.empty((B, V), dtype=torch.bool, device=rv.device)
        rounds = torch.empty((B,), dtype=torch.int32, device=rv.device)
        require(self._tagged_nbr(rv.data_ptr(), iv.data_ptr(), nbr.data_ptr(), out.data_ptr(),
                                 rounds.data_ptr(), B, V, D, self._stream()) == 0,
                "earlier tagged_nbr launch")
        tagged = out.reshape(lead + (V,))
        return (~adj[..., None, None, :, :]) | improper | worse | tagged[..., None, :]


def _versus_prev(old_fn, new_fn, new_out, symbol, what, prev_commit,
                 same_bits: bool = True) -> dict:
    """The redesigned kernel against its earlier version (``old_fn``, None
    without ``--prev``) on the same inputs: outputs bit-equal (with
    ``same_bits``), and device ms per launch timed in turns (old, new, new,
    old); ``prev_ms`` the mean of the two old times.  The model kernels
    pass ``same_bits=False``: their tensor-core products round otherwise
    than the earlier kernels' float32 FMAs, so each is held to the plain
    version (and to its float64 evaluation) instead."""
    import torch

    if not old_fn:
        return {"prev_ms": None, "prev_commit": prev_commit}
    old_out = old_fn()
    old_out, new_out = ((old_out, new_out) if isinstance(old_out, tuple)
                        else ((old_out,), (new_out,)))
    if same_bits:
        require(all(torch.equal(o.view(torch.int32), n.view(torch.int32))
                    for o, n in zip(old_out, new_out)),
                f"{what}: bit-equal to the earlier kernel")

    def dev_ms(fn):
        ms = kernel_ms(fn, symbol)
        return time_ms(fn) if ms is None else ms

    abba = [dev_ms(old_fn), dev_ms(new_fn), dev_ms(new_fn), dev_ms(old_fn)]
    prev_ms = (abba[0] + abba[3]) / 2
    return {"prev_ms": prev_ms, "abba_ms": abba, "speedup": prev_ms / ((abba[1] + abba[2]) / 2),
            "bit_equal_prev": True if same_bits else None, "prev_commit": prev_commit}


def function_ms(fn, calls: int = 20) -> tuple:
    """(device ms, kernel launches) per call of ``fn``, every kernel it
    launches counted (``torch.profiler`` over ``calls`` calls); (None,
    None) if the trace holds no device events."""
    kern = device_kernels(fn, calls)
    ms = sum(v for v, _ in kern.values())
    return (ms / calls, sum(n for _, n in kern.values()) / calls) if ms > 0 else (None, None)


def _blocked_row(new, plain, old, got, symbol, what, nbytes):
    """The timing and launch columns of one blocked-set case: the kernel
    (``new``, one launch: the profiler's trace shows it alone), its plain
    version, the bound (bytes: phi, pdt, adj and the mask once; the
    rounds' operations are a few per edge and round), and with ``old``
    (``--prev``) the composition of commit 5b53a6a that the kernel replaces
    on the same inputs: bool-equal, its whole device time and launches per
    call, timed in turns against the kernel (old, new, new, old)."""
    import torch

    launched = device_kernels(new, 3)
    require(len(launched) == 1 and symbol in next(iter(launched)),
            f"{what}: one launch, the kernel alone: {sorted(launched)}")
    b_ms, b_by = bound(nbytes, 0)
    row = {**timed(new, symbol), "launches_per_call": 1,
           "plain_ms": time_ms(plain, reps=3), "library_ms": None,
           "bound_ms": b_ms, "bound_by": b_by, "prev_commit": PREV_COMMIT_TAGGED}
    if not old:
        return {**row, "prev_ms": None}
    require(torch.equal(old(), got), f"{what}: bool-equal to the composition of the parent")
    turns = [function_ms(old), function_ms(new), function_ms(new), function_ms(old)]
    ev = [time_ms(old), time_ms(new), time_ms(new), time_ms(old)]
    prev_ms = (turns[0][0] + turns[3][0]) / 2
    return {**row, "prev_ms": prev_ms, "abba_ms": [t[0] for t in turns],
            "prev_launches_per_call": turns[0][1], "speedup": prev_ms / ((turns[1][0] + turns[2][0]) / 2),
            "prev_event_ms": (ev[0] + ev[3]) / 2, "abba_event_ms": ev,
            "bit_equal_prev": True}


def _dense_blocked_row(label, inst, pe, pdt, prev, **extra):
    """One case of the dense blocked-set kernel: ``ops.blocked_set`` on the
    card against the plain version (mask and tagged flags), the scan and
    the numpy contract's flags (the dense sweep), and the parent's
    composition with ``prev``."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import blocked_sets as bset
    from repro_torch.kernels import ops

    V = inst.V
    eps = engine.BLOCK_EPS
    adj3, pe3, pd2 = (x.contiguous() for x in (inst.adj.reshape(-1, V, V),
                                               pe.reshape(-1, V, V), pdt.reshape(-1, V)))
    B = pe3.shape[0]

    def new():
        return ops.blocked_set(inst.adj, pe, pdt, eps=eps)

    got = new()
    mask, tagged = bset.blocked_dense(pe3, pd2, adj3, eps=eps, with_tagged=True)
    want, want_tagged = bset.blocked_dense_plain(pe3, pd2, adj3, eps=eps, with_tagged=True)
    require(torch.equal(got.reshape(-1, V, V), mask) and torch.equal(mask, want)
            and torch.equal(tagged, want_tagged),
            f"tagged {label}: mask and tagged flags bool-equal to the plain version")
    route = pe3 > 0.0
    improper = route & (pd2[:, None, :] > pd2[:, :, None] + eps)
    require(torch.equal(tagged, bset.tagged_scan_dense(route, improper)),
            f"tagged {label}: tagged flags equal the dense sweep")
    plan = bset.blocked_dense_plan(V)
    row = {"shape": [B, V], "members": adj3.shape[0], "cluster": plan["cluster"],
           "words_per_cta": plan["words"], "tagged_nodes": int(tagged.sum()),
           "improper_links": int(improper.sum()), "max_abs_err": 0.0, **extra,
           **_blocked_row(new, lambda: bset.blocked_dense_plain(pe3, pd2, adj3, eps=eps),
                          prev and "tagged" in prev.has
                          and (lambda: prev.blocked_set(inst.adj, pe, pdt, eps)),
                          got, "tagged_dense_kernel", f"tagged {label}",
                          pe3.numel() * 4 + pd2.numel() * 4 + adj3.numel() + got.numel())}
    emit({"phase": "kernel", "name": "tagged", "case": label, **row})
    return row


def phase_kernels(prev=None):
    """Each kernel vs its plain version at the main path's shapes; with
    ``prev`` (the earlier kernels), the two redesigned ones also against
    their earlier versions, bit for bit and in time."""
    import torch
    from repro_torch.core import engine, gp, marginals, network, traffic
    from repro_torch.kernels import batched_solve as bs
    from repro_torch.kernels import ops

    # a 10-iteration iterate: fractional splits, unlike the integral init
    inst = network.table_ii_instance("sw-queue")
    V = inst.V
    phi = gp.solve(inst, alpha=0.1, max_iters=10, patience=10**6, tol=0.0).phi
    cands, _, _ = engine.ladder_candidates(inst, phi, 0.1)
    eye = torch.eye(V, device=phi.e.device)
    results = {}

    # lu_factor: the iterate's 90 stage systems and the ladder's 1080
    lu_rows = []
    for label, pe in (("iterate", phi.e), ("ladder", cands.e)):
        mats = (eye - pe).reshape(-1, V, V).contiguous()
        B = mats.shape[0]
        (got, ok_kernel), want = bs.lu_factor(mats, with_ok=True), bs.lu_factor_plain(mats)
        ok_got, ok_want = bs.factor_ok(got), bs.factor_ok(want)
        require(torch.equal(ok_got, ok_want), f"lu_factor {label}: ok flags")
        require(torch.equal(ok_kernel, ok_got), f"lu_factor {label}: kernel ok = factor_ok")
        good = ok_want.nonzero().squeeze(-1)
        abs_e, rel_e = rel_err(got[good], want[good])
        require(rel_e <= 1e-5, f"lu_factor {label}: rel err {rel_e}")
        flops = B * sum(2 * (V - k - 1) ** 2 + (V - k - 1) for k in range(V - 1))
        b_ms, b_by = bound(2 * mats.numel() * 4, flops)
        row = {"shape": [B, V, V], "members_not_ok": int((~ok_want).sum()),
               "max_abs_err": abs_e, "max_rel_err": rel_e,
               **timed(lambda: bs.lu_factor(mats), "lu_kernel"),
               "plain_ms": time_ms(lambda: bs.lu_factor_plain(mats)),
               "library_ms": time_ms(lambda: torch.linalg.lu_factor(mats)),
               "bound_ms": b_ms, "bound_by": b_by,
               "variant": bs.lu_factor_plan(V)["variant"],
               **_versus_prev(prev and "batched_lu" in prev.has
                              and (lambda: prev.lu_factor(mats)),
                              lambda: bs.lu_factor(mats), got, "lu_kernel",
                              f"lu_factor {label}", PREV_COMMIT_DENSE)}
        emit({"phase": "kernel", "name": "lu_factor", "case": label, **row})
        lu_rows.append(row)
    results["lu_factor"] = lu_rows

    # chain_solve: traffic sweep, marginal sweep, ladder traffic sweep
    fact = traffic.stage_factors(phi.e)
    fl = traffic.flows(inst, phi, fact)
    pdt_b = marginals.pdt_base(inst, phi, traffic.link_marginals(inst, fl.F),
                               traffic.comp_marginals(inst, fl.G))
    cfact = traffic.stage_factors(cands.e)
    cases = (("traffic", fact, *traffic.chain_inputs(inst, phi), 1, False, False),
             ("marginals", fact, pdt_b, phi.c, 0, True, True),
             ("ladder", cfact, *traffic.chain_inputs(inst, cands), 1, False, False))
    chain_rows = []
    for label, fa, base, mult, trans, reverse, clamp in cases:
        K = base.shape[-2]
        lu = fa.lu.reshape(-1, K, V, V).contiguous()
        b2 = base.reshape(-1, K, V).contiguous()
        m2 = mult.reshape(-1, K, V).contiguous()
        B = b2.shape[0]
        kw = dict(trans=trans, reverse=reverse, clamp=clamp)
        got = bs.chain_solve(lu, b2, m2, **kw)
        want = bs.chain_solve_plain(lu, b2, m2, **kw)
        ok = fa.ok.reshape(B, K).all(dim=-1)
        fin = torch.isfinite(want).all(dim=-1).all(dim=-1) & ok
        require(torch.equal(torch.isfinite(got).all(dim=-1).all(dim=-1) & ok, fin),
                f"chain_solve {label}: finite members")
        abs_e, rel_e = rel_err(got[fin], want[fin])
        require(rel_e <= 1e-5, f"chain_solve {label}: rel err {rel_e}")
        b_ms, b_by = bound(B * K * (V * V + 3 * V) * 4, B * K * (2 * V * V + 2 * V))
        row = {"shape": [B, K, V], "trans": trans, "reverse": reverse,
               "clamp": clamp, "chains_not_finite": int((~fin).sum()),
               "max_abs_err": abs_e, "max_rel_err": rel_e,
               **timed(lambda: bs.chain_solve(lu, b2, m2, **kw), "chain_kernel"),
               "plain_ms": time_ms(lambda: bs.chain_solve_plain(lu, b2, m2, **kw)),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               **_versus_prev(prev and "chain_solve" in prev.has
                              and (lambda: prev.chain_solve(lu, b2, m2, **kw)),
                              lambda: bs.chain_solve(lu, b2, m2, **kw), got,
                              "chain_kernel", f"chain_solve {label}", PREV_COMMIT_DENSE)}
        emit({"phase": "kernel", "name": "chain_solve", "case": label, **row})
        chain_rows.append(row)
    results["chain_solve"] = chain_rows

    # tagged (the dense blocked-set kernel): the iterate's blocked-set
    # inputs, and a congested variant (routes of a 3-iteration iterate at
    # four times the rates under the init strategy's marginals: stale
    # marginals make improper links)
    m = marginals.marginals(inst, phi, fl, fact)
    hot = network.table_ii_instance("sw-queue", rate_scale=4.0)
    hot_phi = gp.solve(hot, alpha=0.1, max_iters=3, patience=10**6, tol=0.0).phi
    hot_pdt = marginals.marginals(hot, gp.init_phi(hot)).pdt
    tag_rows = []
    for label, pe, pdt in (("iterate", phi.e, m.pdt), ("congested", hot_phi.e, hot_pdt)):
        tag_rows.append(_dense_blocked_row(label, inst, pe, pdt, prev))
    results["tagged"] = tag_rows
    ops.reset_launch_counts()
    return results


def digest_case_inputs(pool):
    """The seeded numpy inputs of every dense digest and dense-scale case
    (``_torch_cases.digest_inputs``: about 60 s of host work, 13 s of it
    the 720-chain case and 30 s the V = 2049 chains' factors), submitted to ``pool``'s processes so that they are
    made while ``nvcc`` builds the kernels: {``digest_key``: future}."""
    from _torch_cases import (dense_digest_cases, dense_scale_digest_cases, digest_inputs,
                              digest_key)

    out = {}
    for c in dense_digest_cases() + dense_scale_digest_cases():
        if digest_key(c) not in out:
            out[digest_key(c)] = pool.submit(digest_inputs, c)
    return out


def phase_digests(inputs):
    """The redesigned kernels held to the card digests of the kernels they
    were redesigned from: the dense route's two (``tests/data/
    torch_card_dense_digests.json``, the kernels of commit 2e984dd, V <= 240;
    ``tests/data/torch_card_dense_scale_digests.json``, commit 8ee676d's
    global-memory variants at V = 300, 600, 1000, ``lu_factor`` at V = 1100
    and 1614, ``chain_solve`` by strips at V = 2049, and ``lu_solve`` by
    strips): every case's output bytes equal, the kernel's ``ok`` equal to
    ``factor_ok``, within 1e-5 of the plain version; and ``bsr_chain`` (``tests/data/
    torch_card_bsr_digests.json``, the kernel of commit f4ca93a): the iterates and the
    sweep counts bit-equal to the digests and to the plain version.  On a
    mismatch the line gives the largest difference against the plain
    version."""
    from _torch_cases import (bsr_digest_cases, bsr_topology, case_id, check_bsr_digest,
                              check_dense_digest, dense_digest_cases,
                              dense_scale_digest_cases, digest_key)
    from repro_torch.kernels import batched_solve as bs
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_solve as ss

    refs = {}
    for path in (DIGESTS, SCALE_DIGESTS):
        with open(path) as fh:
            refs.update({case_id(c): c for c in json.load(fh)["cases"]})
    failed = []
    for case in dense_digest_cases() + dense_scale_digest_cases():
        rep = check_dense_digest(case, refs[case_id(case)],
                                 inputs=inputs[digest_key(case)].result())
        plan = {"lu_factor": bs.lu_factor_plan, "chain_solve": bs.chain_solve_plan,
                "lu_solve": bs.lu_solve_plan}[case["kernel"]](case["V"])
        rep["variant"] = plan["variant"]
        emit({"phase": "digests", **rep})
        if not (rep["inputs_equal"] and rep["outputs_equal"] and rep["finite_equal"]
                and rep.get("ok_equal", True) and rep["max_rel_err"] <= 1e-5):
            failed.append(rep["case"])
    with open(BSR_DIGESTS) as fh:
        refs = {c["label"]: c for c in json.load(fh)["cases"]}
    for case in bsr_digest_cases():
        rep = check_bsr_digest(case, refs[case["label"]])
        plan = ss.bsr_chain_plan(*bsr_topology(case["topo"], case["V"])[2].shape)
        emit({"phase": "digests", "kernel": "bsr_chain", **rep,
              "variant": plan["variant"], "cluster": plan["cluster"]})
        if not (rep["inputs_equal"] and rep["outputs_equal"] and rep["plain_equal"]):
            failed.append(rep["case"])
    require(not failed, f"digests: {failed}")
    ops.reset_launch_counts()


def _rel_hist(got, want) -> float:
    import torch

    got = torch.as_tensor(got, dtype=torch.float64).cpu()
    want = torch.as_tensor(want, dtype=torch.float64)
    return float(((got - want).abs() / want.abs().clamp_min(1e-9)).max())


def phase_solve(ref):
    """The main path on the card, held against the reference's solve."""
    import torch
    from _torch_cases import stall_stop
    from repro_torch.core import conditions, gp, network
    from repro_torch.kernels import ops

    inst = network.table_ii_instance("sw-queue")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = gp.solve(inst, alpha=0.1, max_iters=400)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = min(400, -(-res.iterations // gp._SOLVE_CHUNK) * gp._SOLVE_CHUNK)
    resid = float(conditions.sufficiency_residual(inst, res.phi))
    hist = res.cost_history.cpu()
    ref_hist = ref["cost_history"]
    n = min(len(hist), len(ref_hist))
    prefix = _rel_hist(hist[:n], ref_hist[:n])
    final = abs(res.final_cost - ref_hist[-1]) / abs(ref_hist[-1])
    # the iteration counts: the stall latch replayed on each history, and
    # the first iteration at which the two latches disagree
    card_stop, card_imp = stall_stop(hist.numpy())
    ref_stop, ref_imp = stall_stop(ref_hist)
    flips = [i for i, (a, b) in enumerate(zip(ref_imp, card_imp), 1) if a != b]
    flip = flips[0] if flips else None
    flip_rel = _rel_hist(hist[flip:flip + 1], ref_hist[flip:flip + 1]) if flips else 0.0
    emit({"phase": "solve", "scenario": "sw-queue", "iterations": res.iterations,
          "reference_iterations": ref["iterations"], "final_cost": res.final_cost,
          "reference_final_cost": ref["cost_history"][-1],
          "final_cost_rel": final, "prefix_len": n, "prefix_max_rel": prefix,
          "stall_replay": {"card_stop": card_stop, "reference_stop": ref_stop,
                           "first_disagreement": flip,
                           "cost_rel_there": flip_rel},
          "sufficiency_residual": resid, "wall_s": wall, "steps_run": steps,
          "ms_per_step": wall / steps * 1e3,
          "ms_per_committed_iteration": wall / res.iterations * 1e3,
          "launches": launches,
          "launches_per_step": {k: v / steps for k, v in launches.items()}})
    require(bool(torch.isfinite(hist).all()) and res.phi.e.shape == (30, 3, 100, 100),
            "finite costs, strategy of the expected shape")
    dense = ("lu_factor", "chain_solve", "tagged")
    require(all(launches[k] > 0 for k in dense)
            and not any(v for k, v in launches.items() if k not in dense),
            f"every kernel of the dense route launched, no other: {launches}")
    require(prefix <= 1e-5, f"cost history prefix within 1e-5 of the reference: {prefix}")
    require(final <= 1e-5, f"final cost within 1e-5 of the reference: {final}")
    require((card_stop, ref_stop) == (res.iterations, ref["iterations"]),
            f"the stall latch replays both counts: {(card_stop, ref_stop)}")
    require(flip_rel < 1e-6, f"latches disagree where costs differ by {flip_rel}")
    return launches, wall / steps * 1e3


def phase_profile(ms_per_step: float) -> None:
    """Where a GP step's device time goes: ``torch.profiler`` over one
    32-step chunk of the main path; the idle share is measured against the
    unprofiled ``ms_per_step`` of the solve phase."""
    from repro_torch.core import gp, network

    inst = network.table_ii_instance("sw-queue")
    phi0 = gp.init_phi(inst)
    steps = gp._SOLVE_CHUNK
    kern = device_kernels(lambda: gp.solve(inst, phi0, alpha=0.1, max_iters=steps,
                                           patience=10**6, tol=0.0))
    per_step = {k: ms / steps for k, (ms, _) in kern.items()}
    busy = sum(per_step.values())
    traced = busy > 0
    ours = {name: sum(v for k, v in per_step.items() if sym in k)
            for name, sym in (("lu_factor", "lu_kernel"),
                              ("chain_solve", "chain_kernel"),
                              ("tagged", "tagged_dense_kernel"))}
    others = sorted(((v, k) for k, v in per_step.items()
                     if not any(s in k for s in ("lu_kernel", "chain_kernel",
                                                 "tagged_dense_kernel"))), reverse=True)
    emit({"phase": "profile", "steps": steps,
          "device_ms_per_step": busy if traced else None,
          "kernels_ms_per_step": ours,
          "other_ms_per_step": busy - sum(ours.values()),
          "device_launches_per_step": sum(n for _, n in kern.values()) / steps,
          "idle_share": 1 - busy / ms_per_step if traced else None,
          "top_other": [[k[:80], v] for v, k in others[:6]]})


def phase_parity(ref):
    """Stall latch off, over the reference's iteration count."""
    from repro_torch.core import gp, network

    inst = network.table_ii_instance("sw-queue")
    res = gp.solve(inst, alpha=0.1, max_iters=ref["iterations"], patience=10**6,
                   tol=0.0)
    err = _rel_hist(res.cost_history, ref["cost_history"])
    emit({"phase": "parity", "iterations": res.iterations,
          "reference_iterations": ref["iterations"], "cost_history_max_rel": err})
    require(res.iterations == ref["iterations"], "same iteration count")
    require(err <= 1e-5, f"cost history within 1e-5 of the reference: {err}")


def _bsr_row(label, inst, phi_e, base, mult, trans, reverse=False, clamp=False, prev=None):
    """One ``bsr_chain`` case: the kernel against its plain version (and
    with ``prev`` against the earlier kernel, bit for bit and timed in turns,
    kernel alone and with the ``block_values`` gather it needed) on the
    inputs of one chain call of a GP step."""
    import torch
    from repro_torch.kernels import sparse_solve as ss

    K, V = base.shape[-2:]
    pe = phi_e.reshape(-1, K, V, V).contiguous()
    M = pe.transpose(-1, -2) if trans else pe
    blk_nbr, blk_mask = inst.blk_nbr, inst.blk_mask
    bvals = ss.block_values(M, blk_nbr, blk_mask).contiguous()
    b2 = base.reshape(-1, K, V).contiguous()
    m2 = mult.reshape(-1, K, V).contiguous()
    B = b2.shape[0]
    NB, BD = blk_nbr.shape
    kw = dict(reverse=reverse, clamp=clamp)

    def new():
        return ss.chain_solve_bsr(pe, blk_nbr, blk_mask, b2, m2, trans=trans,
                                  with_sweeps=True, **kw)

    got, sweeps = new()
    want, sweeps_plain = ss.chain_solve_bsr_plain(bvals, blk_nbr, b2, m2,
                                                  with_sweeps=True, **kw)
    require(torch.equal(sweeps, sweeps_plain), f"bsr_chain {label}: sweep counts")
    require(torch.equal(torch.isinf(got), torch.isinf(want))
            and not bool(torch.isnan(got).any()), f"bsr_chain {label}: +inf entries")
    fin = torch.isfinite(want)
    abs_e, rel_e = rel_err(got, want, fin) if bool(fin.any()) else (0.0, 0.0)
    require(rel_e <= 1e-5, f"bsr_chain {label}: rel err {rel_e}")
    # the card path gathers nothing: the trace shows no kernel but its own
    launched = sorted(device_kernels(new, 3))
    require(all("bsr_chain" in k for k in launched),
            f"bsr_chain {label}: the wrapper launches the kernel alone: {launched}")
    total_sweeps = int(sweeps.sum())
    # only the unmasked blocks carry work; the masked slots pad BD with zeros
    nnz = int(blk_mask.sum())
    nbytes = (B * K * nnz * 32 * 32 + 3 * b2.numel() + sweeps.numel()) * 4 + nnz * 8
    b_ms, b_by = bound(nbytes, total_sweeps * nnz * 32 * 32 * 2)
    plan = ss.bsr_chain_plan(NB, BD)
    resident = None
    if plan["cluster"] == 16:
        import ctypes

        from repro_torch.kernels import _build

        n = ctypes.c_int(-1)
        fn = _build.function("bsr_chain", "repro_bsr_chain_max_clusters",
                             [ctypes.c_int] * 4 + [ctypes.c_void_p])
        require(fn(NB, BD, plan["rows"], int(plan["variant"] == "stream"), ctypes.byref(n)) == 0,
                "bsr_chain: cluster occupancy query")
        resident = n.value
    row = {"shape": [B, K, NB, BD, 32, 32], "V": V, "nonzero_blocks": nnz,
           "trans": trans, "reverse": reverse, "clamp": clamp,
           "variant": plan["variant"], "cluster": plan["cluster"], "rows_per_cta": plan["rows"],
           "clusters_resident": resident,
           "sweeps_total": total_sweeps, "sweeps_max": int(sweeps.max()),
           "members_at_cap": int((sweeps == V + 2).any(dim=-1).sum()),
           "members_not_finite": int((~fin.all(dim=-1).all(dim=-1)).sum()),
           "bit_equal": bool(torch.equal(got, want)),
           "max_abs_err": abs_e, "max_rel_err": rel_e,
           **timed(new, "bsr_chain"),
           "plain_ms": time_ms(lambda: ss.chain_solve_bsr_plain(bvals, blk_nbr, b2,
                                                                m2, **kw), reps=5),
           "gather_ms_before": time_ms(lambda: ss.block_values(M, blk_nbr, blk_mask)),
           "gather_ms_after": 0.0, "launched": launched,
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    if prev is not None and "bsr_chain" in prev.has:
        def old():
            return prev.bsr_chain(bvals, blk_nbr, b2, m2, **kw)

        def old_gathered():
            return prev.bsr_chain(ss.block_values(M, blk_nbr, blk_mask).contiguous(),
                                  blk_nbr, b2, m2, **kw)

        row.update(_versus_prev(old, new, (got, sweeps), "bsr_chain", f"bsr_chain {label}",
                                "f4ca93a"))
        turns = [time_ms(old_gathered), time_ms(new), time_ms(new), time_ms(old_gathered)]
        row.update({"prev_with_gather_ms": (turns[0] + turns[3]) / 2,
                    "abba_with_gather_ms": turns,
                    "speedup_with_gather": (turns[0] + turns[3]) / (turns[1] + turns[2])})
    else:
        row.update({"prev_ms": None, "prev_commit": "f4ca93a"})
    emit({"phase": "kernel", "name": "bsr_chain", "case": label, **row})
    return row


def _tagged_nbr_row(label, inst, pe, pdt, prev):
    """One case of the neighbor-list blocked-set kernel: ``ops.
    blocked_set_nbr`` on the card against the plain version (mask, tagged
    flags, round counts), the dense sweep's flags and the dense kernel's
    mask, and the parent's composition with ``prev``."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import blocked_sets as bset
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_solve as ss

    V = inst.V
    eps = engine.BLOCK_EPS
    nbr, mask = inst.out_nbr, inst.out_mask
    adj3, pe3, pd2 = (x.contiguous() for x in (inst.adj.reshape(-1, V, V),
                                               pe.reshape(-1, V, V), pdt.reshape(-1, V)))
    B, D = pe3.shape[0], nbr.shape[1]

    def new():
        return ops.blocked_set_nbr(inst.adj, pe, pdt, nbr, mask, eps=eps)

    got = new()
    out, tagged, rounds = ss.blocked_nbr(pe3, pd2, adj3, nbr, mask, eps=eps, with_rounds=True)
    want = ss.blocked_nbr_plain(pe3, pd2, adj3, nbr, mask, eps=eps, with_rounds=True)
    require(torch.equal(got.reshape(-1, V, V), out)
            and all(torch.equal(a, b) for a, b in zip((out, tagged, rounds), want)),
            f"tagged_nbr {label}: mask, flags and rounds bool-equal to the plain version")
    route = pe3 > 0.0
    improper = route & (pd2[:, None, :] > pd2[:, :, None] + eps)
    require(torch.equal(tagged, bset.tagged_scan_dense(route, improper)),
            f"tagged_nbr {label}: equals the dense sweep")
    require(torch.equal(out, bset.blocked_dense(pe3, pd2, adj3, eps=eps)),
            f"tagged_nbr {label}: equals the dense blocked-set kernel")
    # the mask is written whole; the edges carry the rounds' work
    edges = int(mask.sum())
    plan = ss.blocked_nbr_plan(V, D)
    row = {"shape": [B, V, D], "edges": edges, "cluster": plan["cluster"],
           "words_per_cta": plan["words"], "tagged_nodes": int(tagged.sum()),
           "improper_links": int(improper.sum()), "rounds_max": int(rounds.max()),
           "rounds_total": int(rounds.sum()), "max_abs_err": 0.0,
           **_blocked_row(new, lambda: ss.blocked_nbr_plain(pe3, pd2, adj3, nbr, mask, eps=eps),
                          prev and "tagged_nbr" in prev.has
                          and (lambda: prev.blocked_set_nbr(inst.adj, pe, pdt, nbr, mask, eps)),
                          got, "tagged_nbr_mask_kernel", f"tagged_nbr {label}",
                          B * edges * 4 + pd2.numel() * 4 + adj3.numel() + got.numel()
                          + nbr.numel() * 9)}
    emit({"phase": "kernel", "name": "tagged_nbr", "case": label, **row})
    return row


def phase_sparse_kernels(prev=None):
    """The metro path's kernels vs their plain versions at its shapes (and
    with ``prev`` the redesigned ``bsr_chain`` and the neighbor-list
    blocked sets against their earlier versions)."""
    from _torch_cases import with_loops
    from repro_torch.core import engine, gp, marginals, network, traffic
    from repro_torch.kernels import ops

    bsr_rows, tag_rows = [], []
    # metro-sw V=1000 at init_phi: the three chain calls of a step
    metro = network.metro_instance("sw", 1000)
    phi = gp.init_phi(metro)
    fl = traffic.flows(metro, phi)
    m = marginals.marginals(metro, phi, fl)
    cands, _, _ = engine.ladder_candidates(metro, phi, 0.1)
    bsr_rows.append(_bsr_row("metro-sw-traffic", metro, phi.e,
                             *traffic.chain_inputs(metro, phi), 1, prev=prev))
    bsr_rows.append(_bsr_row(
        "metro-sw-marginals", metro, phi.e,
        marginals.pdt_base(metro, phi, m.Dp, m.Cp), phi.c, 0, True, True, prev=prev))
    tag_rows.append(_tagged_nbr_row("metro-sw", metro, phi.e, m.pdt, prev))
    bsr_rows.append(_bsr_row("metro-sw-ladder", metro, cands.e,
                             *traffic.chain_inputs(metro, cands), 1, prev=prev))
    del cands, fl, m
    # metro-geant V=1000: the widest block rows (BD=27)
    geant = network.metro_instance("geant", 1000)
    gphi = gp.init_phi(geant)
    bsr_rows.append(_bsr_row("metro-geant-traffic", geant, gphi.e,
                             *traffic.chain_inputs(geant, gphi), 1, prev=prev))
    # congested sw-queue: a 10-iteration iterate's ladder, three members
    # made loopy (the latch and the cap), and stale-marginal tagged inputs
    hot = network.with_sparse(network.table_ii_instance("sw-queue", rate_scale=2.0))
    hphi = gp.solve(hot, alpha=0.1, max_iters=10, patience=10**6, tol=0.0).phi
    hc, _, _ = engine.ladder_candidates(hot, hphi, 0.1)
    loopy = hc._replace(e=with_loops(hc.e, hot.r, hot.out_nbr))
    row = _bsr_row("sw-queue-ladder-loopy", hot, loopy.e,
                   *traffic.chain_inputs(hot, loopy), 1, prev=prev)
    require(row["members_at_cap"] >= 1 and row["members_not_finite"] >= 1,
            "bsr_chain loopy case: one member at the cap, one latched")
    bsr_rows.append(row)
    stale = marginals.marginals(hot, gp.init_phi(hot)).pdt
    tag_rows.append(_tagged_nbr_row("sw-queue-congested", hot, hphi.e, stale, prev))
    ops.reset_launch_counts()
    return {"bsr_chain": bsr_rows, "tagged_nbr": tag_rows}


def phase_metro(ref):
    """The metro path on the card, held against the reference's solve."""
    import numpy as np
    import torch
    from repro_torch.core import conditions, gp, marginals, network, traffic
    from repro_torch.kernels import ops

    inst = network.metro_instance("sw", 1000)
    require(traffic.resolve_solver("auto", inst) == "sparse",
            "metro-sw V=1000 takes the sparse route")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phi0 = gp.init_phi(inst)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t_init, _ = traffic.stage_traffic(inst, phi0)
    pdt_init = marginals.marginals(inst, phi0).pdt
    errs = {}
    for name, got in (("t0", t_init), ("pdt0", pdt_init)):
        want = torch.from_numpy(ref[name]).to(got.device)
        require(torch.equal(torch.isfinite(got), torch.isfinite(want)),
                f"metro {name}: finite entries")
        errs[name] = rel_err(got, want)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = gp.solve(inst, phi0, alpha=0.1, max_iters=int(ref["max_iters"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = min(int(ref["max_iters"]),
                -(-res.iterations // gp._SOLVE_CHUNK) * gp._SOLVE_CHUNK)
    hist = res.cost_history.cpu()
    ref_hist = ref["cost_history"].astype(np.float64)
    default_rel = _rel_hist(hist, ref_hist) if len(hist) == len(ref_hist) else None

    n_off = int(ref["latch_off_iterations"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = gp.solve(inst, phi0, alpha=0.1, max_iters=n_off, patience=10**6, tol=0.0)
    torch.cuda.synchronize()
    off_wall = time.perf_counter() - t0
    off_rel = _rel_hist(off.cost_history, ref["latch_off_cost_history"].astype(np.float64))
    # the cost does not move in float32 over these steps, the strategy does:
    # hold the card's final strategy (on the out-neighbor lists) to the
    # reference's, and measure how far the reference's moved from phi0
    nbr, mask = inst.out_nbr, inst.out_mask

    def on_edges(e):
        return torch.where(mask, torch.gather(e, -1, nbr.expand(e.shape[:-1] + nbr.shape[-1:])),
                           0.0)

    want_e = torch.from_numpy(ref["latch_off_phi_e_nbr"]).to(nbr.device)
    want_c = torch.from_numpy(ref["latch_off_phi_c"]).to(nbr.device)
    phi_err = max(float((on_edges(off.phi.e) - want_e).abs().max()),
                  float((off.phi.c - want_c).abs().max()))
    e0 = on_edges(phi0.e)
    ref_moved = max(float((want_e - e0).abs().max()), float((want_c - phi0.c).abs().max()))
    card_moved = max(float((on_edges(off.phi.e) - e0).abs().max()),
                     float((off.phi.c - phi0.c).abs().max()))
    resid = float(conditions.sufficiency_residual(inst, res.phi))
    emit({"phase": "metro", "instance": "metro_instance('sw', 1000)",
          "V": inst.V, "edges": int(inst.adj.sum()), "A": inst.A, "K1": inst.K1,
          "NB_BD": list(inst.blk_nbr.shape), "D": inst.max_degree,
          "init_phi_s": init_s,
          "t0_max_abs_err": errs["t0"][0], "t0_max_rel_err": errs["t0"][1],
          "pdt0_max_abs_err": errs["pdt0"][0], "pdt0_max_rel_err": errs["pdt0"][1],
          "iterations": res.iterations, "reference_iterations": int(ref["iterations"]),
          "cost_history_max_rel": default_rel, "final_cost": res.final_cost,
          "sufficiency_residual": resid, "wall_s": wall, "steps_run": steps,
          "ms_per_step": wall / steps * 1e3, "launches": launches,
          "launches_per_step": {k: v / steps for k, v in launches.items()},
          "latch_off_iterations": off.iterations,
          "latch_off_cost_history_max_rel": off_rel,
          "latch_off_phi_max_abs_err": phi_err,
          "latch_off_phi_moved": {"reference": ref_moved, "card": card_moved},
          "latch_off_ms_per_step": off_wall / n_off * 1e3})
    require(bool(torch.isfinite(hist).all())
            and res.phi.e.shape == (inst.A, inst.K1, 1000, 1000),
            "finite costs, strategy of the expected shape")
    for name in ("t0", "pdt0"):
        require(errs[name][1] <= 1e-5, f"metro {name} within 1e-5: {errs[name]}")
    require(res.iterations == int(ref["iterations"]),
            f"default solve's count {res.iterations} vs {int(ref['iterations'])}")
    require(default_rel is not None and default_rel <= 1e-5,
            f"default cost history within 1e-5: {default_rel}")
    require(off.iterations == n_off, "latch-off count")
    require(off_rel <= 1e-5, f"latch-off cost history within 1e-5: {off_rel}")
    require(ref_moved > 10 * PHI_TOL,
            f"the reference's strategy moves ({ref_moved}), so the check below tells")
    require(phi_err <= PHI_TOL,
            f"latch-off final strategy within {PHI_TOL} of the reference: {phi_err}")
    require(launches["lu_factor"] == launches["chain_solve"] == launches["tagged"] == 0,
            f"the dense kernels never launch on the metro path: {launches}")
    require(launches["bsr_chain"] >= 3 * steps and launches["tagged_nbr"] >= steps,
            f"bsr_chain 3 and tagged_nbr 1 launches per step: {launches}")
    return launches, off_wall / n_off * 1e3


def phase_metro_profile(ms_per_step: float) -> None:
    """Where a metro step's device time goes (the ``profile`` phase's
    method, on ``metro_instance("sw", 1000)``)."""
    from repro_torch.core import gp, network

    inst = network.metro_instance("sw", 1000)
    phi0 = gp.init_phi(inst)
    steps = gp._SOLVE_CHUNK
    kern = device_kernels(lambda: gp.solve(inst, phi0, alpha=0.1, max_iters=steps,
                                           patience=10**6, tol=0.0))
    per_step = {k: ms / steps for k, (ms, _) in kern.items()}
    busy = sum(per_step.values())
    traced = busy > 0
    ours = {name: sum(v for k, v in per_step.items() if sym in k)
            for name, sym in (("bsr_chain", "bsr_chain"),
                              ("tagged_nbr", "tagged_nbr_mask_kernel"))}
    top = sorted(((v, k) for k, v in per_step.items()), reverse=True)
    emit({"phase": "metro_profile", "steps": steps,
          "device_ms_per_step": busy if traced else None,
          "kernels_ms_per_step": ours,
          "other_ms_per_step": busy - sum(ours.values()),
          "device_launches_per_step": sum(n for _, n in kern.values()) / steps,
          "idle_share": 1 - busy / ms_per_step if traced else None,
          "top": [[k[:80], v] for v, k in top[:10]]})

# ---------------------------------------------------------------------------
# The dense route above the kernels' shared-memory limits (V = 300, 600, 1000)
# ---------------------------------------------------------------------------

DENSE_SCALE_V = (300, 600, 1000)
DENSE_SOLVE_V = (300, 600)        # benchmarks/gp_scaling.py's dense leg
ROUTE_TOL = 1e-5                  # dense route vs sparse route, relative


def _dense_iterate(V):
    """``without_sparse(metro_instance("sw", V))``, its ``init_phi``, the
    ladder candidates there, and the marginals' ``pdt``."""
    from repro_torch.core import engine, gp, marginals, network

    inst = network.without_sparse(network.metro_instance("sw", V))
    phi = gp.init_phi(inst)
    cands, _, _ = engine.ladder_candidates(inst, phi, 0.1)
    return inst, phi, cands, marginals.marginals(inst, phi).pdt


def phase_dense_scale_kernels(inputs, prev=None):
    """``lu_factor``, ``chain_solve``, ``lu_solve`` and ``tagged`` in their
    global-memory variants against their plain versions at V = 300, 600 and
    1000: on the stage systems and ladder candidates of
    ``without_sparse(metro_instance("sw", V))`` (within 1e-5, the ``ok``
    flags equal; ``torch.linalg.lu_factor`` and ``lu_solve`` beside them)
    and on the seeded cases of ``_torch_cases.dense_scale_cases`` (a
    singular, a tiny and a loopy member); with ``prev``, ``lu_factor`` and
    ``chain_solve`` against commit 8ee676d's variants on the same ladder
    inputs (bytes equal, timed in turns)."""
    import torch
    from _torch_cases import case_id, check_dense_digest, dense_scale_cases, digest_key
    from repro_torch.core import traffic
    from repro_torch.kernels import batched_solve as bs
    from repro_torch.kernels import ops

    rows = {"lu_factor": [], "chain_solve": [], "lu_solve": [], "tagged": []}
    for V in DENSE_SCALE_V:
        inst, phi, cands, pdt = _dense_iterate(V)
        eye = torch.eye(V, device="cuda")
        mats = (eye - cands.e).reshape(-1, V, V).contiguous()
        B = mats.shape[0]
        (lu, ok), want = bs.lu_factor(mats, with_ok=True), bs.lu_factor_plain(mats)
        require(torch.equal(ok, bs.factor_ok(want)) and torch.equal(ok, bs.factor_ok(lu)),
                f"lu_factor V={V}: ok flags")
        abs_e, rel_e = rel_err(lu[ok], want[ok])
        require(rel_e <= 1e-5, f"lu_factor V={V}: rel err {rel_e}")
        flops = B * sum(2 * (V - k - 1) ** 2 + (V - k - 1) for k in range(V - 1))
        b_ms, b_by = bound(2 * mats.numel() * 4 + B, flops)
        row = {"case": f"metro-sw-V{V}-ladder", "shape": [B, V, V],
               "variant": bs.lu_factor_plan(V)["variant"], "members_not_ok": int((~ok).sum()),
               "max_abs_err": abs_e, "max_rel_err": rel_e,
               "cluster": bs.lu_factor_plan(V)["cluster"],
               **timed(lambda: bs.lu_factor(mats), "lu_kernel_cluster"),
               "plain_ms": time_ms(lambda: bs.lu_factor_plain(mats), reps=1),
               "library_ms": time_ms(lambda: torch.linalg.lu_factor(mats), reps=5),
               "bound_ms": b_ms, "bound_by": b_by,
               **_versus_prev(prev and "batched_lu" in prev.has
                              and (lambda: prev.lu_factor(mats)),
                              lambda: bs.lu_factor(mats), lu, "lu_kernel",
                              f"lu_factor V={V}", PREV_COMMIT_DENSE)}
        emit({"phase": "kernel", "name": "lu_factor", **row})
        rows["lu_factor"].append(row)

        # the ladder's traffic sweep on its factors
        fa = traffic.stage_factors(cands.e)
        base, mult = traffic.chain_inputs(inst, cands)
        K = base.shape[-2]
        lu3 = fa.lu.reshape(-1, K, V, V).contiguous()
        b2, m2 = base.reshape(-1, K, V).contiguous(), mult.reshape(-1, K, V).contiguous()
        Bc = b2.shape[0]
        got = bs.chain_solve(lu3, b2, m2, trans=1)
        want = bs.chain_solve_plain(lu3, b2, m2, trans=1)
        okc = fa.ok.reshape(Bc, K).all(-1)
        require(torch.equal(torch.isfinite(got).all(-1).all(-1) & okc,
                            torch.isfinite(want).all(-1).all(-1) & okc),
                f"chain_solve V={V}: finite chains")
        abs_e, rel_e = rel_err(got[okc], want[okc])
        require(rel_e <= 1e-5, f"chain_solve V={V}: rel err {rel_e}")
        b_ms, b_by = bound(Bc * K * (V * V + 3 * V) * 4, Bc * K * (2 * V * V + 2 * V))
        row = {"case": f"metro-sw-V{V}-ladder", "shape": [Bc, K, V], "trans": 1,
               "variant": bs.chain_solve_plan(V)["variant"],
               "cluster": bs.chain_solve_plan(V)["cluster"],
               "max_abs_err": abs_e, "max_rel_err": rel_e,
               **timed(lambda: bs.chain_solve(lu3, b2, m2, trans=1), "chain_kernel_cluster"),
               "plain_ms": time_ms(lambda: bs.chain_solve_plain(lu3, b2, m2, trans=1), reps=1),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               **_versus_prev(prev and "chain_solve" in prev.has
                              and (lambda: prev.chain_solve(lu3, b2, m2, trans=1)),
                              lambda: bs.chain_solve(lu3, b2, m2, trans=1), got, "chain_kernel",
                              f"chain_solve V={V}", PREV_COMMIT_DENSE)}
        emit({"phase": "kernel", "name": "chain_solve", **row})
        rows["chain_solve"].append(row)

        # lu_solve: the iterate's stage systems, traffic right-hand sides
        fi = traffic.stage_factors(phi.e)
        lui = fi.lu.reshape(-1, V, V).contiguous()
        rhs = traffic.chain_inputs(inst, phi)[0].reshape(-1, V).contiguous()
        Bs = lui.shape[0]
        got = bs.lu_solve(lui, rhs, trans=1)
        want = bs.lu_solve_plain(lui, rhs, trans=1)
        abs_e, rel_e = rel_err(got, want)
        require(rel_e <= 1e-5, f"lu_solve V={V}: rel err {rel_e}")
        piv = torch.arange(1, V + 1, dtype=torch.int32, device="cuda").expand(Bs, V).contiguous()
        b_ms, b_by = bound(Bs * (V * V + 2 * V) * 4, 2 * Bs * V * V)
        row = {"case": f"metro-sw-V{V}-iterate-trans1", "shape": [Bs, V, V], "trans": 1,
               "variant": bs.lu_solve_plan(V)["variant"],
               "max_abs_err": abs_e, "max_rel_err": rel_e,
               **timed(lambda: bs.lu_solve(lui, rhs, trans=1), "solve_kernel_strips"),
               "plain_ms": time_ms(lambda: bs.lu_solve_plain(lui, rhs, trans=1), reps=1),
               "library_ms": time_ms(lambda: torch.linalg.lu_solve(lui, piv, rhs[..., None],
                                                                   adjoint=True), reps=5),
               "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "kernel", "name": "lu_solve", **row})
        rows["lu_solve"].append(row)

        # tagged: the ladder's first rung under the iterate's marginals
        # (stale-marginal improper links make the rounds do work)
        rows["tagged"].append(_dense_blocked_row(f"metro-sw-V{V}", inst, cands.e[1], pdt,
                                                 prev))
        del inst, phi, cands, pdt, mats, lu, fa, lu3, fi
    failed = []
    for case in dense_scale_cases():
        rep = check_dense_digest(case, None, inputs=inputs[digest_key(case)].result())
        emit({"phase": "kernel", "name": case["kernel"], "case": case_id(case),
              "seeded": True, **{k: rep[k] for k in ("ok_equal", "finite_equal",
                                                     "max_abs_diff", "max_rel_err")
                                 if k in rep}})
        if not (rep.get("ok_equal", True) and rep["finite_equal"]
                and rep["max_rel_err"] <= 1e-5):
            failed.append(rep["case"])
    require(not failed, f"dense scale seeded cases: {failed}")
    ops.reset_launch_counts()
    return rows


def phase_dense_scale(ref):
    """The dense route at V = 300 and 600 (``benchmarks/gp_scaling.py``'s
    dense leg): ``gp.solve(without_sparse(metro_instance("sw", V)))``, every
    launch counted, held against the port's own sparse route on the same
    instance (the default solve's count and cost history, a latch-off
    solve's cost history and final strategy, within 1e-5; one step's rung
    costs, rung and every ladder candidate's stage traffic and flows through
    either route's stage solver, within 1e-5) and at V=300 against the
    reference's ``solver="dense"`` solve (``tests/data/
    torch_ref_dense_sw300.npz``: the traffic and marginals at ``init_phi``,
    the default solve's count and history, the latch-off history and final
    strategy on the out-neighbor lists)."""
    import numpy as np
    import torch
    from repro_torch.core import engine, gp, marginals, network, traffic
    from repro_torch.kernels import ops

    n_off = int(ref["latch_off_iterations"])
    for V in DENSE_SOLVE_V:
        sparse = network.metro_instance("sw", V)
        dense = network.without_sparse(sparse)
        require(traffic.resolve_solver("auto", dense) == "batched_lu"
                and traffic.resolve_solver("auto", sparse) == "sparse",
                f"dense_scale V={V}: the two routes")
        phi0 = gp.init_phi(dense)
        runs = {}
        for route, inst in (("dense", dense), ("sparse", sparse)):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = gp.solve(inst, phi0, alpha=0.1, max_iters=400)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            t0 = time.perf_counter()
            off = gp.solve(inst, phi0, alpha=0.1, max_iters=n_off, patience=10**6, tol=-1.0)
            torch.cuda.synchronize()
            runs[route] = (res, off, launches, wall, (time.perf_counter() - t0) / n_off * 1e3)
        (rd, od, ld, wd, msd), (rs, os_, ls, ws, mss) = runs["dense"], runs["sparse"]
        require(ld["lu_factor"] > 0 and ld["chain_solve"] > 0 and ld["tagged"] > 0
                and ld["bsr_chain"] == ld["tagged_nbr"] == 0,
                f"dense_scale V={V}: the dense kernels run the dense route: {ld}")
        require(ls["lu_factor"] == ls["chain_solve"] == ls["tagged"] == 0,
                f"dense_scale V={V}: the sparse route factors nothing: {ls}")
        hist_rel = (_rel_hist(rd.cost_history, rs.cost_history.cpu())
                    if rd.iterations == rs.iterations else None)
        off_rel = _rel_hist(od.cost_history, os_.cost_history.cpu())
        phi_route = max(float((od.phi.e - os_.phi.e).abs().max()),
                        float((od.phi.c - os_.phi.c).abs().max()))
        # one step's ladder on its kernel inputs, through either route
        a = torch.tensor(0.1, device="cuda")
        sd, ss_ = engine.gp_step(dense, phi0, a), engine.gp_step(sparse, phi0, a)
        cands, _, _ = engine.ladder_candidates(sparse, phi0, a)
        fd = traffic.flows(dense.lifted, cands, solver="batched_lu")
        fs = traffic.flows(sparse.lifted, cands, solver="sparse")
        def route_rel(x, y):
            fin = torch.isfinite(y)
            if not torch.equal(torch.isfinite(x), fin):
                return float("inf")
            return rel_err(x, y, fin)[1] if bool(fin.any()) else 0.0

        ladder = {"rung_equal": bool(torch.equal(sd.rung, ss_.rung)),
                  "ladder_costs_rel": route_rel(sd.ladder_costs, ss_.ladder_costs),
                  **{f"{f}_rel": route_rel(getattr(fd, f), getattr(fs, f))
                     for f in ("t", "g", "F", "G")}}
        line = {"phase": "dense_scale", "V": V, "instance": f"without_sparse(metro_instance"
                f"('sw', {V}))", "iterations": rd.iterations,
                "sparse_iterations": rs.iterations, "cost_history_rel_sparse": hist_rel,
                "final_cost": rd.final_cost, "latch_off_iterations": od.iterations,
                "latch_off_rel_sparse": off_rel, "latch_off_phi_max_abs_sparse": phi_route,
                "ladder_vs_sparse": ladder, "launches_dense": ld,
                "wall_s_dense": wd, "wall_s_sparse": ws,
                "latch_off_ms_per_step_dense": msd, "latch_off_ms_per_step_sparse": mss}
        checks = [(hist_rel is not None and hist_rel <= ROUTE_TOL,
                   f"default solves {rd.iterations} / {rs.iterations}, history {hist_rel}"),
                  (off_rel <= ROUTE_TOL, f"latch-off history vs sparse {off_rel}"),
                  (phi_route <= PHI_TOL, f"latch-off strategy vs sparse {phi_route}"),
                  (ladder["rung_equal"] and all(v <= ROUTE_TOL for k, v in ladder.items()
                                                if k != "rung_equal"), f"ladder {ladder}")]
        if V == int(ref["V"]):
            t_init, _ = traffic.stage_traffic(dense, phi0)
            pdt_init = marginals.marginals(dense, phi0).pdt
            nbr, mask = sparse.out_nbr, sparse.out_mask
            e_nbr = torch.where(mask, torch.gather(od.phi.e, -1, nbr.expand(
                od.phi.e.shape[:-1] + nbr.shape[-1:])), 0.0)
            golden = {"t0_rel": rel_err(t_init, torch.from_numpy(ref["t0"]).cuda())[1],
                      "pdt0_rel": rel_err(pdt_init, torch.from_numpy(ref["pdt0"]).cuda())[1],
                      "reference_iterations": int(ref["iterations"]),
                      "cost_history_rel": (_rel_hist(rd.cost_history, ref["cost_history"]
                                                     .astype(np.float64))
                                           if rd.iterations == int(ref["iterations"])
                                           else None),
                      "latch_off_rel": _rel_hist(od.cost_history,
                                                 ref["latch_off_cost_history"]
                                                 .astype(np.float64)),
                      "latch_off_phi_max_abs": max(
                          float((e_nbr - torch.from_numpy(ref["latch_off_phi_e_nbr"]).cuda())
                                .abs().max()),
                          float((od.phi.c - torch.from_numpy(ref["latch_off_phi_c"]).cuda())
                                .abs().max()))}
            line["reference_dense"] = golden
            checks += [(golden["t0_rel"] <= 1e-5 and golden["pdt0_rel"] <= 1e-5,
                        f"t0/pdt0 vs the reference {golden}"),
                       (golden["cost_history_rel"] is not None
                        and golden["cost_history_rel"] <= 1e-5,
                        f"default solve vs the reference {golden}"),
                       (golden["latch_off_rel"] <= 1e-5
                        and golden["latch_off_phi_max_abs"] <= PHI_TOL,
                        f"latch-off solve vs the reference {golden}")]
        emit(line)
        for ok, what in checks:
            require(ok, f"dense_scale V={V}: {what}")
        del sparse, dense, runs, cands, fd, fs
    ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# The edge-serving path: the model kernels, the chain instance, the forwards
# ---------------------------------------------------------------------------

EDGE_B, EDGE_S = 4, 2048          # packets of a full-width forward
MODEL_TOL = 2e-5                  # kernel vs plain version, relative to max |plain|
FORWARD_TOL = 1e-3                # logits through the kernels vs the plain versions
SPLIT_TOL = 1e-6                  # split vs monolithic logits


def _max_rel(got, want) -> tuple[float, float]:
    """(max abs error, max abs error relative to max |want|)."""
    d = float((got.double() - want.double()).abs().max())
    return d, d / max(float(want.double().abs().max()), 1e-30)


def _flash_row(label, B, H, KV, S, hd, causal=True, window=None, seed=0, prev=None):
    """One ``flash_attention`` case at the (B, H, S, hd) layout the kernel
    takes, S padded to a multiple of 128 as ``ops.flash_attention`` pads it;
    with ``prev``, the earlier kernel on the same inputs (its error against
    the float64 plain version beside the new one's, timed in turns)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    Sp = -(-S // fa.PAD) * fa.PAD
    q, k, v = (torch.randn((B, h, S, hd), generator=g, device="cuda") for h in (H, KV, KV))
    qp, kp, vp = (F.pad(x, (0, 0, 0, Sp - S)).contiguous() for x in (q, k, v))
    kw = dict(causal=causal, window=window, seq_len=S)
    got = fa.flash_attention_fwd(qp, kp, vp, **kw)[:, :, :S]
    want = fa.flash_attention_plain(qp, kp, vp, **kw)[:, :, :S]
    require(bool(torch.isfinite(got).all()), f"flash_attention {label}: finite")
    abs_e, rel_e = _max_rel(got, want)
    require(rel_e <= MODEL_TOL, f"flash_attention {label}: rel err {rel_e}")
    exact = fa.flash_attention_plain(qp.double(), kp.double(), vp.double(), **kw)[:, :, :S]
    errs = {"max_rel_err_f64": _max_rel(got, exact)[1],
            "plain_max_rel_err_f64": _max_rel(want, exact)[1]}
    old = prev and "flash_attention" in prev.has and functools.partial(
        prev.flash_attention, qp, kp, vp, **kw)
    if old:
        errs["prev_max_rel_err_f64"] = _max_rel(old()[:, :, :S], exact)[1]
    del exact
    # work this run needs: the (query, key) pairs in reach of the real rows
    qi = torch.arange(S, device="cuda")[:, None]
    ki = torch.arange(S, device="cuda")[None, :]
    reach = torch.ones((S, S), dtype=torch.bool, device="cuda")
    if causal:
        reach &= ki <= qi
    if window is not None:
        reach &= ki > qi - window
    pairs = int(reach.sum())
    nbytes, flops = (2 * B * H * S * hd + 2 * B * KV * S * hd) * 4, 4 * B * H * pairs * hd
    b_ms, b_by = bound(nbytes, flops)
    if window is None:
        def lib():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    else:
        def lib():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=reach, enable_gqa=True)

    def new():
        return fa.flash_attention_fwd(qp, kp, vp, **kw)

    row = {"shape": [B, H, KV, S, hd], "padded_S": Sp, "causal": causal, "window": window,
           "max_abs_err": abs_e, "max_rel_err": rel_e, **errs,
           **timed(new, "flash_kernel"),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(qp, kp, vp, **kw)),
           "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
           "bound_tc_ms": bound(nbytes, flops, PEAK_TF32X3)[0],
           **_versus_prev(old, new, None, "flash_kernel", f"flash_attention {label}",
                          PREV_COMMIT_MODELS, same_bits=False)}
    emit({"phase": "model_kernels", "name": "flash_attention", "case": label, **row})
    return row


def _ssd_row(label, B, nc, H, P, N, G=1, seed=0, prev=None):
    """One ``ssd_chunk`` case on Mamba-2-like inputs: dt = softplus(normal),
    A = -(1..H) (the initialiser's), B and C read by group; with ``prev``,
    the earlier kernel on the same inputs, as in :func:`_flash_row`."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_chunk as sc

    g = torch.Generator(device="cuda").manual_seed(seed)
    Q = sc.CHUNK
    xh = torch.randn((B, nc, Q, H, P), generator=g, device="cuda")
    dt = F.softplus(torch.randn((B, nc, Q, H), generator=g, device="cuda"))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    cum = torch.cumsum(dt * A, dim=2)
    Bc = torch.randn((B, nc, Q, G, N), generator=g, device="cuda")
    Cc = torch.randn((B, nc, Q, G, N), generator=g, device="cuda")
    args = (xh, dt, cum, Bc, Cc)
    y, st = sc.ssd_chunk_fwd(*args)
    yw, sw = sc.ssd_chunk_plain(*args)
    require(bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()),
            f"ssd_chunk {label}: finite")
    (ya, yr), (sa, sr) = _max_rel(y, yw), _max_rel(st, sw)
    require(max(yr, sr) <= MODEL_TOL, f"ssd_chunk {label}: rel err y {yr}, state {sr}")
    ye, se = sc.ssd_chunk_plain(*(x.double() for x in args))

    def f64(out):
        return max(_max_rel(out[0], ye)[1], _max_rel(out[1], se)[1])

    errs = {"max_rel_err_f64": f64((y, st)), "plain_max_rel_err_f64": f64((yw, sw))}
    old = prev and "ssd_chunk" in prev.has and functools.partial(prev.ssd_chunk, *args)
    if old:
        errs["prev_max_rel_err_f64"] = f64(old())
    del ye, se
    tri = Q * (Q + 1) // 2
    flops = B * nc * H * (tri * (2 * N + 2 * P + 3) + 2 * Q * N * P + 3 * Q)
    # the least work: C B^T once per chunk and group
    least = B * nc * (G * tri * 2 * N + H * (tri * (2 * P + 3) + 2 * Q * N * P + 3 * Q))
    nbytes = (xh.numel() + 2 * dt.numel() + 2 * Bc.numel() + y.numel() + st.numel()) * 4
    b_ms, b_by = bound(nbytes, flops)

    def new():
        return sc.ssd_chunk_fwd(*args)

    row = {"shape": [B, nc, Q, H, P, N, G], "max_abs_err": max(ya, sa),
           "max_rel_err_y": yr, "max_rel_err_state": sr, **errs,
           **timed(new, "ssd_chunk_kernel"),
           "plain_ms": time_ms(lambda: sc.ssd_chunk_plain(*args)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bound_tc_ms": bound(nbytes, least, PEAK_TF32X3)[0],
           "bound_tc_by": bound(nbytes, least, PEAK_TF32X3)[1],
           **_versus_prev(old, new, None, "ssd_chunk_kernel", f"ssd_chunk {label}",
                          PREV_COMMIT_MODELS, same_bits=False)}
    emit({"phase": "model_kernels", "name": "ssd_chunk", "case": label, **row})
    return row


def _ssd_short_check(Q=32, B=4, H=48, P=64, N=128):
    """``ops.ssd_chunk`` on one chunk of a prefill shorter than the kernel's
    128 rows (padded by the wrapper) against the plain version unpadded."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc

    g = torch.Generator(device="cuda").manual_seed(Q)
    xh = torch.randn((B, 1, Q, H, P), generator=g, device="cuda")
    dt = F.softplus(torch.randn((B, 1, Q, H), generator=g, device="cuda"))
    cum = torch.cumsum(dt * -torch.arange(1, H + 1, dtype=torch.float32, device="cuda"), 2)
    Bc = torch.randn((B, 1, Q, 1, N), generator=g, device="cuda")
    Cc = torch.randn((B, 1, Q, 1, N), generator=g, device="cuda")
    before = sc.ssd_chunk_fwd.launches
    y, st = ops.ssd_chunk(xh, dt, cum, Bc, Cc)
    launched = sc.ssd_chunk_fwd.launches - before
    yw, sw = sc.ssd_chunk_plain(xh, dt, cum, Bc, Cc)
    (_, yr), (_, sr) = _max_rel(y, yw), _max_rel(st, sw)
    emit({"phase": "model_kernels", "name": "ssd_chunk", "case": f"short-prefill-S{Q}",
          "shape": [B, 1, Q, H, P, N, 1], "launches": launched,
          "max_rel_err_y": yr, "max_rel_err_state": sr})
    require(launched == 1 and tuple(y.shape) == (B, 1, Q, H, P) and max(yr, sr) <= MODEL_TOL,
            f"ssd_chunk short prefill S={Q}: launches {launched}, rel err y {yr}, state {sr}")


def phase_model_kernels(prev=None):
    """The edge path's two kernels vs their plain versions at its shapes
    (with ``prev``, against their earlier versions too)."""
    from repro_torch.kernels import ops

    flash = [
        _flash_row("internlm2-causal", 4, 16, 8, 2048, 128, prev=prev),
        _flash_row("internlm2-window512", 4, 16, 8, 2048, 128, window=512, seed=1, prev=prev),
        _flash_row("internlm2-S2000-padded", 4, 16, 8, 2000, 128, seed=2, prev=prev),
        _flash_row("hd64-tinyllama-heads", 4, 32, 4, 2048, 64, seed=3, prev=prev),
    ]
    ssd = [
        _ssd_row("mamba2-S2048", 4, 16, 48, 64, 128, prev=prev),
        _ssd_row("mamba2-S128", 4, 1, 48, 64, 128, seed=1, prev=prev),
    ]
    _ssd_short_check()
    ops.reset_launch_counts()
    return {"flash_attention": flash, "ssd_chunk": ssd}


def _edge_instance(ref):
    """The chain instance of the golden file, built by the port on the card,
    held bit-equal to the reference's."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core import chain, network

    chains = [chain.chain_from_arch(configs.get(a), n_segments=ref["n_segments"],
                                    tokens_per_packet=ref["tokens_per_packet"],
                                    flops_unit=ref["flops_unit"], bits_unit=ref["bits_unit"])
              for a in ref["archs"]]
    for c, want in zip(chains, ref["chains"]):
        require(c.name == want["name"] and np.array_equal(c.L, np.asarray(want["L"]))
                and np.array_equal(c.w, np.asarray(want["w"])),
                f"chain {c.name}: L and w bit-equal to the reference's")
    inst = chain.instance_from_chains(
        network.TOPOLOGIES[ref["topology"]](), chains, sources=ref["sources"],
        rates=ref["rates"], dests=ref["dests"], link_capacity=ref["link_capacity"],
        comp_capacity=ref["comp_capacity"])
    for f, want in ref["instance"].items():
        if f in ("link_kind", "comp_kind"):
            require(getattr(inst, f) == want, f"instance {f}")
            continue
        got = getattr(inst, f).cpu()
        require(torch.equal(got, torch.tensor(want, dtype=got.dtype)),
                f"instance {f} equal to the reference's")
    return chains, inst


def phase_edge_gp(ref):
    """GP on the chain instance, held to the reference (golden file): the
    step from each reference iterate, then the free-running solves."""
    import numpy as np
    import torch
    from _torch_cases import edge_step_parity, free_run_split, stall_stop, stepped_rungs
    from repro_torch.core import gp, traffic

    chains, inst = _edge_instance(ref)
    lo, alpha = ref["latch_off"], ref["alpha"]
    step = edge_step_parity(inst, lo, alpha)
    costs, rungs = stepped_rungs(inst, alpha, lo["iterations"])
    off = gp.solve(inst, alpha=alpha, max_iters=lo["iterations"], patience=10**6, tol=0.0)
    hist = off.cost_history.double().cpu().numpy()
    flip, tied, prefix = free_run_split(hist, rungs, lo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gp.solve(inst, alpha=alpha, max_iters=ref["max_iters"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dh = res.cost_history.double().cpu().numpy()
    m = min(len(dh), len(hist))
    g = traffic.flows(inst, res.phi).g.cpu()
    offload = {c.name: {f"segment {k + 1}": {str(i): round(float(g[a, k, i]), 4)
                                              for i in range(inst.V) if g[a, k, i] > 1e-3}
                        for k in range(c.n_tasks)}
               for a, c in enumerate(chains)}
    ref_default = ref["default"]
    emit({"phase": "edge", "part": "gp", "instance": "abilene, 2 chains "
          f"{ref['archs']}, {ref['tokens_per_packet']} tokens per packet",
          "L": [c.L.tolist() for c in chains], "w": [c.w.tolist() for c in chains],
          "step_parity": step,
          "latch_off": {"iterations": off.iterations, "reference_iterations": lo["iterations"],
                        "first_rung_flip": flip, "flip_is_tie": tied,
                        "prefix_max_rel": prefix},
          "default": {"iterations": res.iterations,
                      "reference_iterations": ref_default["iterations"],
                      "final_cost": res.final_cost,
                      "reference_final_cost": ref_default["cost_history"][-1],
                      "reference_final_residual": ref_default["final_residual"],
                      "reference_cost_range": [min(ref_default["cost_history"]),
                                               max(ref_default["cost_history"])],
                      "stall_replay": [stall_stop(dh)[0], stall_stop(ref_default["cost_history"])[0]],
                      "wall_s": wall},
          "offload_nodes": offload})
    require(step["inf_mismatch"] == 0 and step["ladder_max_rel"] <= 1e-5,
            f"rung costs within 1e-5 at every reference iterate: {step}")
    require(step["step_max_rel"] <= 1e-5 and step["phi_max_abs"] <= 1e-5,
            f"each step's cost and strategy within 1e-5: {step}")
    require(not step["untied_flips"], f"every rung flip is a tie: {step}")
    require(np.array_equal(hist[1:], costs), "stepped and solved histories equal")
    require(off.iterations == lo["iterations"], "latch-off count")
    require(tied and prefix <= 1e-5,
            f"latch-off history within 1e-5 up to its first rung flip ({flip}), a tie")
    require(np.array_equal(dh[:m], hist[:m]), "default solve follows the latch-off one")
    require(stall_stop(dh)[0] == res.iterations
            and stall_stop(ref_default["cost_history"])[0] == ref_default["iterations"],
            "the stall latch replays both default counts")
    if flip is None or flip + 1 >= ref_default["iterations"]:
        require(res.iterations == ref_default["iterations"]
                and abs(res.final_cost - ref_default["cost_history"][-1])
                <= 1e-5 * abs(ref_default["cost_history"][-1]),
                "no flip before the reference's stop: same count and final cost")
    _edge_steady_solve(ref, chains)
    return chains


def _edge_steady_solve(ref, chains):
    """The edge chains at the golden file's ``steady`` CPU capacity, where
    the reference's cost falls at every step: the card's free-running
    default solve holds the reference's count, whole history and final
    cost within 1e-5."""
    import numpy as np
    from _torch_cases import stall_stop
    from repro_torch.core import chain, gp, network

    st = ref["steady"]
    inst = chain.instance_from_chains(
        network.TOPOLOGIES[ref["topology"]](), chains, sources=ref["sources"],
        rates=ref["rates"], dests=ref["dests"], link_capacity=ref["link_capacity"],
        comp_capacity=st["comp_capacity"])
    res = gp.solve(inst, alpha=ref["alpha"], max_iters=ref["max_iters"])
    hist = res.cost_history.double().cpu().numpy()
    same = len(hist) == len(st["cost_history"])
    rel = _rel_hist(hist, st["cost_history"]) if same else float("inf")
    final = abs(res.final_cost - st["cost_history"][-1]) / st["cost_history"][-1]
    emit({"phase": "edge", "part": "gp_steady", "comp_capacity": st["comp_capacity"],
          "iterations": res.iterations, "reference_iterations": st["iterations"],
          "history_max_rel": rel, "final_cost": res.final_cost,
          "reference_final_cost": st["cost_history"][-1], "final_cost_rel": final,
          "cost_falls_every_step": bool(np.all(np.diff(hist) < 0)),
          "stall_replay": stall_stop(hist)[0]})
    require(res.iterations == st["iterations"] and stall_stop(hist)[0] == res.iterations,
            f"steady solve: {res.iterations} iterations, reference {st['iterations']}")
    require(rel <= 1e-5 and final <= 1e-5,
            f"steady solve: history within {rel}, final cost within {final} of the reference's")


def _forward_profile(name, model, batch, ms_forward):
    """``edge_profile``: where one forward's device time goes."""
    kern = device_kernels(lambda: model.apply(batch))
    busy = sum(ms for ms, _ in kern.values())
    traced = busy > 0

    def part(k):
        low = k.lower()
        if "flash_kernel" in k:
            return "flash_attention"
        if "ssd_chunk_kernel" in k:
            return "ssd_chunk"
        if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas")):
            return "cublas_products"
        return "rest"

    split = {"cublas_products": 0.0, "flash_attention": 0.0, "ssd_chunk": 0.0, "rest": 0.0}
    for k, (ms, _) in kern.items():
        split[part(k)] += ms
    top = sorted(((ms, k) for k, (ms, _) in kern.items() if part(k) == "rest"), reverse=True)
    emit({"phase": "edge_profile", "model": name,
          "device_ms": busy if traced else None, "device_ms_by_part": split,
          "device_launches": sum(n for _, n in kern.values()),
          "idle_share": 1 - busy / ms_forward if traced else None,
          "top_rest": [[k[:80], ms] for ms, k in top[:6]]})


@contextlib.contextmanager
def through_plain_versions():
    """Within this block the model kernels' wrappers are swapped for their
    plain versions (``ops`` looks them up at each call), for the plain
    forward that the kernels' forward is held to; the launch counters of
    ``ops.KERNELS`` stay with the kernels."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc

    saved = fa.flash_attention_fwd, sc.ssd_chunk_fwd
    fa.flash_attention_fwd, sc.ssd_chunk_fwd = fa.flash_attention_plain, sc.ssd_chunk_plain
    try:
        yield
    finally:
        fa.flash_attention_fwd, sc.ssd_chunk_fwd = saved


def phase_edge_forwards(chains, seed: int = 0):
    """Each chain's model at full width on the card: a monolithic forward, the
    split forward of the chain's two segments, and the forward through the
    plain versions; then ``edge_profile``."""
    import torch
    from repro_torch import configs
    from repro_torch.core import chain
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    launches = {}
    for i, prof in enumerate(chains):
        cfg = configs.get(prof.name)
        kernel = "flash_attention" if cfg.layer_kind(0) == "attn" else "ssd_chunk"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = transformer.Model(cfg).init(seed + i)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        g = torch.Generator(device="cuda").manual_seed(seed + 100 + i)
        batch = {"tokens": torch.randint(0, cfg.vocab, (EDGE_B, EDGE_S), generator=g,
                                         device="cuda")}
        # the split forward: segment bounds of the chain (chain.py:65)
        lo, mid, hi = (int(b) for b in chain.segment_bounds(cfg.n_layers, prof.n_tasks))
        with torch.no_grad():
            x = model.apply_layers(model.embed(batch), lo, mid)
            packet = x.cpu()                                  # shipped between nodes
            split = model.head(model.apply_layers(packet.to(model.device), mid, hi))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = model.apply(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        launches[kernel] = counts[kernel]
        with through_plain_versions():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = model.apply(batch)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        s_abs, s_rel = _max_rel(split, logits)
        p_abs, p_rel = _max_rel(logits, plain)
        emit({"phase": "edge", "part": "forward", "model": cfg.name, "params": n_params,
              "init_s": init_s, "batch": [EDGE_B, EDGE_S],
              "segments": [[lo, mid], [mid, hi]],
              "packet": {"shape": list(packet.shape), "bytes": packet.numel() * 4},
              "logits_shape": list(logits.shape),
              "split_max_abs_err": s_abs, "split_max_rel_err": s_rel,
              "split_bit_equal": bool(torch.equal(split, logits)),
              "plain_max_abs_err": p_abs, "plain_max_rel_err": p_rel,
              "launches": counts, "ms_per_forward": ms,
              "tokens_per_s": EDGE_B * EDGE_S / (ms / 1e3),
              "plain_ms_per_forward": plain_ms,
              "peak_gb": torch.cuda.max_memory_allocated() / 2**30})
        require(bool(torch.isfinite(logits).all())
                and tuple(logits.shape) == (EDGE_B, EDGE_S, cfg.vocab),
                f"{cfg.name}: finite logits of the expected shape")
        require(s_rel <= SPLIT_TOL, f"{cfg.name}: split vs monolithic {s_rel}")
        require(p_rel <= FORWARD_TOL, f"{cfg.name}: kernels vs plain forward {p_rel}")
        require(counts[kernel] == cfg.n_layers
                and all(v == 0 for k, v in counts.items() if k != kernel),
                f"{cfg.name}: {kernel} launched once per layer, nothing else: {counts}")
        _forward_profile(cfg.name, model, batch, ms)
        del model, logits, split, plain, x, packet
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return launches


# ---------------------------------------------------------------------------
# The evaluation sweeps: lu_solve, propagate_step, the oracles, Figs. 5 and 6
# ---------------------------------------------------------------------------

ORACLE_TOL = 1e-5                 # oracle phase, relative to max(|value|, 1)
CLAIM_TOL = 1e-5                  # GP's final cost at most a baseline's, relative


def _sw_iterate():
    """sw-queue, its 10-iteration iterate (stall latch off) and ladder."""
    from repro_torch.core import engine, gp, network

    inst = network.table_ii_instance("sw-queue")
    phi = gp.solve(inst, alpha=0.1, max_iters=10, patience=10**6, tol=0.0).phi
    cands, _, _ = engine.ladder_candidates(inst, phi, 0.1)
    return inst, phi, cands


def _lu_solve_row(label, lu, rhs, trans):
    """``lu_solve`` against its plain version; ``torch.linalg.lu_solve``
    with identity pivots beside it."""
    import torch
    from repro_torch.kernels import batched_solve as bs

    B, V = rhs.shape
    got = bs.lu_solve(lu, rhs, trans=trans)
    want = bs.lu_solve_plain(lu, rhs, trans=trans)
    ok = bs.factor_ok(lu)
    fin = ok & torch.isfinite(want).all(-1)
    require(torch.equal(ok & torch.isfinite(got).all(-1), fin),
            f"lu_solve {label}: finite members")
    abs_e, rel_e = rel_err(got[fin], want[fin])
    require(rel_e <= 1e-5, f"lu_solve {label}: rel err {rel_e}")
    piv = torch.arange(1, V + 1, dtype=torch.int32, device=lu.device).expand(B, V).contiguous()
    b3 = rhs[..., None].contiguous()
    b_ms, b_by = bound(B * (V * V + 2 * V) * 4, 2 * B * V * V)
    row = {"case": label, "shape": [B, V, V], "trans": trans,
           "members_not_ok": int((~ok).sum()), "max_abs_err": abs_e, "max_rel_err": rel_e,
           **timed(lambda: bs.lu_solve(lu, rhs, trans=trans), "solve_kernel"),
           "plain_ms": time_ms(lambda: bs.lu_solve_plain(lu, rhs, trans=trans)),
           "library_ms": time_ms(lambda: torch.linalg.lu_solve(lu, piv, b3,
                                                               adjoint=bool(trans))),
           "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernel", "name": "lu_solve", **row})
    return row


def _propagate_row(label, t, M, src):
    """``propagate_step`` against its plain version (the reference's
    einsum); ``torch.baddbmm`` beside it."""
    import torch
    from repro_torch.kernels import chain_propagate as cp

    S, V = t.shape
    got, want = cp.propagate_step(t, M, src), cp.propagate_step_plain(t, M, src)
    abs_e, rel_e = rel_err(got, want)
    require(rel_e <= 1e-5, f"propagate_step {label}: rel err {rel_e}")
    b_ms, b_by = bound(S * (V * V + 3 * V) * 4, 2 * S * V * V)
    row = {"case": label, "shape": [S, V, V], "max_abs_err": abs_e, "max_rel_err": rel_e,
           **timed(lambda: cp.propagate_step(t, M, src), "propagate_kernel"),
           "plain_ms": time_ms(lambda: cp.propagate_step_plain(t, M, src)),
           "library_ms": time_ms(lambda: torch.baddbmm(src[:, None], t[:, None], M)),
           "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernel", "name": "propagate_step", **row})
    return row


def phase_solve_kernels():
    """``lu_solve`` and ``propagate_step`` vs their plain versions: the
    sw-queue stage factors (B=90 iterate, B=1080 ladder, both ``trans``),
    V=240 (the shared-memory limit), a singular member; the stage matrices
    as propagation operators (S=90 and 1080 at V=100) and the reference
    bench's S=90, V=128."""
    import numpy as np
    import torch
    from _torch_cases import stage_mats
    from repro_torch.core import traffic
    from repro_torch.kernels import batched_solve as bs
    from repro_torch.kernels import ops

    inst, phi, cands = _sw_iterate()
    V = inst.V
    g = torch.Generator(device="cuda").manual_seed(14)
    solve_rows = []
    for label, pe in (("iterate", phi.e), ("ladder", cands.e)):
        lu = traffic.stage_factors(pe).lu.reshape(-1, V, V).contiguous()
        rhs = torch.rand((lu.shape[0], V), generator=g, device="cuda")
        for trans in (1, 0):
            solve_rows.append(_lu_solve_row(f"{label}-trans{trans}", lu, rhs, trans))
    rng = np.random.default_rng(240)
    big = bs.lu_factor(torch.from_numpy(stage_mats(rng, 16, 240)).cuda())
    rhs = torch.rand((16, 240), generator=g, device="cuda")
    for trans in (1, 0):
        solve_rows.append(_lu_solve_row(f"V240-trans{trans}", big, rhs, trans))
    # a singular member flags itself and leaves the others exactly as alone
    mats = torch.from_numpy(stage_mats(rng, 90, V, loopy=(7,))).cuda()
    x, resid = ops.batched_solve(mats, rhs[:1, :V].expand(90, V).contiguous(), trans=1)
    good = torch.arange(90, device="cuda") != 7
    alone, _ = ops.batched_solve(mats[good].contiguous(),
                                 rhs[:1, :V].expand(89, V).contiguous(), trans=1)
    emit({"phase": "kernel", "name": "lu_solve", "case": "singular-member",
          "flagged_inf": bool(torch.isinf(resid[7])),
          "others_max_resid": float(resid[good].max()),
          "others_bit_equal_alone": bool(torch.equal(x[good], alone))})
    require(bool(torch.isinf(resid[7])) and float(resid[good].max()) < 1e-5
            and torch.equal(x[good], alone),
            "lu_solve: the singular member flags inf, the others untouched")

    prop_rows = []
    t = traffic.flows(inst, phi).t.reshape(-1, V).contiguous()
    prop_rows.append(_propagate_row("iterate", t, phi.e.reshape(-1, V, V).contiguous(),
                                    torch.rand(t.shape, generator=g, device="cuda")))
    M = torch.rand((90, 128, 128), generator=g, device="cuda") * 0.05
    prop_rows.append(_propagate_row("bench-V128", torch.zeros((90, 128), device="cuda"), M,
                                    torch.rand((90, 128), generator=g, device="cuda")))
    Mc = cands.e.reshape(-1, V, V).contiguous()
    prop_rows.append(_propagate_row("ladder", torch.rand((Mc.shape[0], V), generator=g,
                                                         device="cuda"), Mc,
                                    torch.rand((Mc.shape[0], V), generator=g,
                                               device="cuda")))
    ops.reset_launch_counts()
    return {"lu_solve": solve_rows, "propagate_step": prop_rows}


def phase_oracle():
    """The two kernels as the oracles of the solver, on the card: the fused
    chain against a per-stage loop of ``lu_solve`` launches, and the
    Neumann fixed point against the stage traffic.  Their launch counts are
    read over this phase, the only path that runs them."""
    import torch
    from repro_torch.core import gp, marginals, traffic
    from repro_torch.kernels import ops

    inst, phi, _ = _sw_iterate()
    V, K1 = inst.V, inst.K1
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fact = traffic.stage_factors(phi.e)
    fl = traffic.flows(inst, phi, fact)
    pdt_b = marginals.pdt_base(inst, phi, traffic.link_marginals(inst, fl.F),
                               traffic.comp_marginals(inst, fl.G))
    out = {}
    for label, (base, mult), trans, reverse, clamp in (
            ("traffic", traffic.chain_inputs(inst, phi), 1, False, False),
            ("marginals", (pdt_b, phi.c), 0, True, True)):
        fused = ops.fused_chain_solve(fact, base, mult, trans=trans, reverse=reverse,
                                      clamp=clamp)
        x = torch.zeros_like(base[:, 0])
        loop = [None] * K1
        for k in (range(K1 - 1, -1, -1) if reverse else range(K1)):
            fk = ops.BatchedLU(lu=fact.lu[:, k], ok=fact.ok[:, k])
            x = ops.batched_solve_factored(fk, base[:, k] + mult[:, k] * x, trans=trans)
            x = torch.clamp_min(x, 0.0) if clamp else x
            loop[k] = x
        out[label] = rel_err(fused, torch.stack(loop, 1))
    phi0 = gp.init_phi(inst)
    t0 = traffic.flows(inst, phi0).t[:, 0]
    fp = ops.solve_fixed_point(phi0.e[:, 0], inst.r, sweeps=V)
    out["fixed_point"] = rel_err(fp, t0)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    emit({"phase": "oracle", "scenario": "sw-queue",
          "chain_vs_lu_solve_loop": {k: {"max_abs_err": a, "max_rel_err": r}
                                     for k, (a, r) in out.items() if k != "fixed_point"},
          "fixed_point_vs_traffic": {"sweeps": V, "max_abs_err": out["fixed_point"][0],
                                     "max_rel_err": out["fixed_point"][1],
                                     "bound_met": ORACLE_TOL,
                                     "reference_test_bound": 1e-3},
          "launches": launches})
    for k, (_, r) in out.items():
        require(r <= ORACLE_TOL, f"oracle {k}: rel err {r}")
    require(launches["lu_solve"] == 2 * K1 and launches["propagate_step"] == V,
            f"oracle: one lu_solve per stage solve, one propagate_step per sweep: {launches}")
    return {k: launches[k] for k in ("lu_solve", "propagate_step")}


# Member lines of the sweep phases that failed their check: every sweep
# runs to its end, and the phases fail together after the last one.
SWEEP_FAILURES: list = []
KNOWN_SEEN: set = set()        # the known faults the sweep phases met


LOCAL_STEPS: dict = {}


def _local_steps(key, inst, alpha, masks_fn, n):
    """``_torch_cases.local_steps`` of one member, once per member and step
    count (``key``: figure, solver, member): its batched and one-by-one
    lines ask for the same float64 steps."""
    from _torch_cases import local_steps

    if (key, n) not in LOCAL_STEPS:
        LOCAL_STEPS[key, n] = local_steps(inst, n, alpha=alpha, masks_fn=masks_fn)
    return LOCAL_STEPS[key, n]


def _members(fig, solver, way, res, z, max_iters, alpha, own=(), seconds=None,
             own_more=(), branch_runs=None):
    """One JSON line per member of a sweep, held to the golden file
    (``_torch_cases.sweep_parity``, with the reference's own other runs of
    the member and the port's ``own`` other sweeps of the family as
    witnesses, and the runs ``f(i)`` of member i for ``f`` in ``own_more``,
    made only where its line fails without them: a witness can only make a
    line pass, so the verdict is the one with every witness;
    ``chained_parity`` along a chain).  A known fault that needs a branch
    witness (``TIE_BRANCH``) takes member i's runs ``branch_runs(i)``
    ({name: run} that differ from the line's only by float32 rounding)."""
    from _torch_cases import (KNOWN_FAULTS, certify, chained_parity, golden_member,
                              golden_witnesses, known_fault_holds, sweep_parity)
    from repro_torch.core import baselines

    labels = [sc.label for sc in res.scenarios]
    if way == "chained":
        refs = [golden_member(z, fig, "GP-chained", lab) for lab in labels]
        reports = chained_parity(res.results, refs,
                                 [golden_member(z, fig, "GP", lab) for lab in labels],
                                 max_iters=max_iters)
    else:
        refs, reports, wkw = [], [], []
        for i, (lab, r) in enumerate(zip(labels, res.results)):
            # a one-by-one run is held to the reference's one-by-one run
            # where the golden file has it (Fig. 6, Fig. 5's six small)
            ser = way == "serial" and golden_member(z, fig, solver + "-serial", lab)
            refs.append(ser or golden_member(z, fig, solver, lab))
            wkw.append(golden_witnesses(z, fig, solver, lab, serial=bool(ser)))
            check = functools.partial(
                sweep_parity, r, refs[-1], max_iters=max_iters,
                certify=functools.partial(certify, res.scenarios[i].instance, r.phi,
                                          baselines.BASELINE_MASKS.get(solver)),
                local=(None if solver == "GP-accel" else functools.partial(
                    _local_steps, (fig, solver, lab), res.scenarios[i].instance, alpha,
                    baselines.BASELINE_MASKS.get(solver))),
                **wkw[-1])
            rep = check(own=[o.results[i] for o in own])
            if not rep["ok"] and own_more:
                rep = check(own=[o.results[i] for o in own] + [f(i) for f in own_more])
            reports.append(rep)
    out = {}
    for i, (sc, r, ref, rep) in enumerate(zip(res.scenarios, res.results, refs, reports)):
        known = KNOWN_FAULTS["cuda"].get((fig, solver, way, sc.label))
        if known:
            KNOWN_SEEN.add((fig, solver, way, sc.label))
        branch = {}
        if known and known.get("branch_witness") and branch_runs is not None:
            branch = {name: sweep_parity(run, ref, max_iters=max_iters, **wkw[i])
                      for name, run in branch_runs(i).items()}
        held = known and known_fault_holds(rep, known, list(branch.values()))
        emit({"phase": "sweep", "fig": fig, "solver": solver, "way": way,
              "known_fault": known and known["reason"],
              "member": sc.label, "V": sc.instance.V, "final_cost": r.final_cost,
              "iterations": r.iterations,
              "seconds": seconds[i] if seconds else None,
              "sweep_seconds": res.seconds,
              "reference_final_cost": float(ref["cost_history"][-1]),
              **{k: rep.get(k) for k in ("ok", "why", "reference_iterations", "split",
                                         "prefix_max_rel", "final_rel", "final_tol",
                                         "final_floor", "certified", "flips",
                                         "first_flip",
                                         "stall_witness", "first_departure",
                                         "self_departure", "self_witness",
                                         "local_witness", "start_rel")},
              **({"branch_witnesses": {
                  name: {k: w[k] for k in ("final_rel", "final_tol", "first_flip")}
                  for name, w in branch.items()}} if branch else {})})
        if known and rep["ok"]:
            SWEEP_FAILURES.append(f"{fig} {solver} {way} {sc.label}: a known fault passes "
                                  f"now; take it out of its table in _torch_cases.KNOWN_FAULTS")
        elif held:
            SWEEP_FAILURES.append(f"{fig} {solver} {way} {sc.label}: not as recorded: "
                                  f"{held}")
        elif not known and not rep["ok"]:
            SWEEP_FAILURES.append(f"{fig} {solver} {way} {sc.label}: {rep['why']}")
        out[sc.label] = r.final_cost
    return out


def phase_sweep(fig, z):
    """One figure's family, batched and one by one, every member held to
    the golden file; then the paper's claim at every member.  The families
    of ``HELD_SWEEPS`` (Fig. 7, the ensemble, mixed-topology) run batched
    only, with the run from a jittered start as the port's own witness:
    the CPU tests hold their one-by-one runs.  The jittered runs are made
    only for a family with a member that needs one."""
    import torch
    from _torch_cases import HELD_SWEEPS, jittered
    from repro_torch.core import baselines, scenarios
    from repro_torch.kernels import ops

    params = json.loads(str(z["meta"]))[fig]
    fam = scenarios.expand(params["sweep"])
    kw = dict(alpha=params["alpha"], max_iters=params["max_iters"], record=True)
    every = {"GP": {}, "GP-accel": {"accel": True},
             **{name: {"masks_fn": fn} for name, fn in baselines.BASELINE_MASKS.items()}}
    names = HELD_SWEEPS.get(fig, ("GP", "GP-accel", "SPOC", "LCOF") if fig == "fig6"
                            else ("GP", "SPOC", "LCOF"))
    solvers = {name: every[name] for name in names}
    finals, summary = {}, {}
    for name, extra in solvers.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        bat = scenarios.run_sweep(fam, **kw, **extra)
        launches = ops.launch_counts()
        require(all(launches[k] > 0 for k in ("lu_factor", "chain_solve", "tagged")),
                f"{fig} {name}: the dense route's kernels launched: {launches}")
        # the same sweep from a start moved by one ulp (where the port's own
        # trajectory stops being fixed by float32 arithmetic), run once, and
        # only if a member's line needs it
        jit_sweep = functools.cache(lambda extra=extra: scenarios.run_sweep(
            fam, **kw, **{**extra, "masks_fn": jittered(extra.get("masks_fn"))}))

        def jit(i):
            return jit_sweep().results[i]
        if fig in HELD_SWEEPS:
            finals[name] = _members(fig, name, "batched", bat, z, params["max_iters"],
                                    params["alpha"], own_more=(jit,))
            summary[name] = {"batched_s": bat.seconds, "groups": bat.n_batches,
                             "iterations_batched": sum(r.iterations for r in bat.results),
                             "launches_batched": launches}
            continue
        secs, ser_results = [], []
        for sc in fam:
            one = scenarios.run_sweep_serial([sc], **kw, **extra)
            secs.append(one.seconds)
            ser_results.extend(one.results)
        ser = scenarios.SweepResult(fam, ser_results, sum(secs), len(fam))
        finals[name] = _members(fig, name, "batched", bat, z, params["max_iters"],
                                params["alpha"], own=(ser,), own_more=(jit,))
        # an accelerated member has no float64 local steps; its one-by-one
        # line may also take its one-by-one run from the jittered start
        jser = () if name != "GP-accel" else (lambda i: scenarios.run_sweep_serial(
            [fam[i]], **kw, **{**extra, "masks_fn": jittered(extra.get("masks_fn"))}
        ).results[0],)
        ser_finals = _members(fig, name, "serial", ser, z, params["max_iters"],
                              params["alpha"], own=(bat,), seconds=secs,
                              own_more=(jit, *jser))
        bs_rel = {lab: abs(finals[name][lab] - c) / abs(c) for lab, c in ser_finals.items()}
        summary[name] = {"batched_s": bat.seconds, "serial_s": ser.seconds,
                         "groups": bat.n_batches,
                         "iterations_batched": sum(r.iterations for r in bat.results),
                         "iterations_serial": sum(r.iterations for r in ser.results),
                         "batched_vs_serial_max_rel": max(bs_rel.values()),
                         "launches_batched": launches}
        if name != "GP-accel" and not max(bs_rel.values()) <= 1e-4:
            SWEEP_FAILURES.append(f"{fig} {name}: batched vs serial {bs_rel}")
    if fig == "fig6":
        ch = scenarios.run_sweep_chained(fam, **kw)
        _members(fig, "GP", "chained", ch, z, params["max_iters"], params["alpha"])
        summary["GP-chained"] = {"seconds": ch.seconds,
                                 "iterations": sum(r.iterations for r in ch.results)}
    # the paper's claim (Figs. 5 and 6), where the reference's own golden
    # runs have it; on a member where the reference's GP stops above a
    # baseline (Fig. 5 connected-er and geant: its stall latch), within 1e-4
    claim = {}
    for sc in (fam if fig in ("fig6", "fig5") else ()):
        lab = sc.label
        for base in ("SPOC", "LCOF"):
            gap = (finals["GP"][lab] - finals[base][lab]) / finals[base][lab]
            rg = (float(z[f"{fig}/GP/{lab}/cost_history"][-1])
                  / float(z[f"{fig}/{base}/{lab}/cost_history"][-1]) - 1)
            lim = CLAIM_TOL if rg <= CLAIM_TOL else 1e-4
            claim[f"{lab} vs {base}"] = {"gp": finals["GP"][lab], base: finals[base][lab],
                                         "gap": gap, "reference_gap": rg, "limit": lim}
            if not gap <= lim:
                SWEEP_FAILURES.append(f"{fig} claim {lab} GP vs {base}: {gap} > {lim}")
    emit({"phase": "sweep", "fig": fig, "summary": summary, "claim": claim})


def _step_profile(binst, steps: int = 32) -> dict:
    """Where a batched step's time goes, over ``steps`` iterations of the
    stacked family ``binst`` with every latch off: ms per step (unprofiled
    wall), device ms and launches per step, by kernel too
    (``torch.profiler``), and the idle share against the unprofiled run."""
    import torch
    from repro_torch.core import gp
    from repro_torch.kernels import ops

    def run():
        return gp.solve_batched(binst, alpha=0.1, max_iters=steps, tol=-1.0,
                                patience=10**6)

    run()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / steps
    launches = ops.launch_counts()
    kern = device_kernels(run)
    per_step = {k: ms / steps for k, (ms, _) in kern.items()}
    busy = sum(per_step.values())
    ours = {name: sum(v for k, v in per_step.items() if sym in k)
            for name, sym in (("lu_factor", "lu_kernel"), ("chain_solve", "chain_kernel"),
                              ("tagged", "tagged_dense_kernel"))}
    top = sorted(((v, k) for k, v in per_step.items()), reverse=True)
    return {"members": binst.batch_shape[0], "V": binst.V, "A": binst.A, "steps": steps,
            "ms_per_step": ms_step, "device_ms_per_step": busy if busy > 0 else None,
            "kernels_ms_per_step": ours, "other_ms_per_step": busy - sum(ours.values()),
            "device_launches_per_step": sum(n for _, n in kern.values()) / steps,
            "kernel_launches_per_step": {k: v / steps for k, v in launches.items() if v},
            "idle_share": 1 - busy / ms_step if busy > 0 else None,
            "top": [[k[:80], v] for v, k in top[:8]]}


def phase_sweep_profile():
    """Where a batched step's time goes (``_step_profile``): 32 iterations
    of the Fig. 6 family (B=6, V=11) and of Fig. 5's sw-queue group (B=1,
    V=100)."""
    from repro_torch.core import batch, scenarios

    for label, fam in (("fig6-congestion", scenarios.expand("fig6-congestion")),
                       ("fig5-sw-queue", [sc for sc in scenarios.expand("fig5")
                                          if sc.label == "sw-queue"])):
        emit({"phase": "sweep_profile", "family": label,
              **_step_profile(batch.pad_instances([sc.instance for sc in fam]))})


def _online_fleet(fleet, z):
    """One fleet's ``online-trace`` sweep on the card: the trace and every
    post-event member against the file, the family batched and one by one
    under ``sweep_parity``, batched against one by one within 1e-4, and
    the batched step's profile."""
    import torch
    from _torch_cases import (ONLINE_KNOWN_FAULTS, jittered, member_mismatches,
                              online_sweep_kwargs, online_trace, same_event)
    from repro_torch.core import events, network, scenarios
    from repro_torch.kernels import ops

    skw, gkw = online_sweep_kwargs(z, fleet)
    t0 = time.perf_counter()
    members = events.pad_fleet([network.table_ii_instance(skw["scenario"], seed=skw["seed"],
                                                          rate_scale=s)
                                for s in skw["scales"]], skw["spare_apps"])
    trace = events.random_trace(members, n_events=skw["n_events"], seed=skw["seed"])
    trace_s = time.perf_counter() - t0
    stored = online_trace(z, fleet)
    same = len(trace) == len(stored) and all(map(same_event, trace, stored))
    fam = scenarios.expand("online-trace", **skw)
    mism = member_mismatches(z, fleet, [sc.instance for sc in fam])
    require(same and not mism, f"online-trace {fleet}: the trace equals the stored one "
                               f"({same}) and every member field ({mism[:5]})")
    kw = dict(record=True, **gkw)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    bat = scenarios.run_sweep(fam, **kw)
    launches = ops.launch_counts()
    secs, ser_results = [], []
    for sc in fam:
        one = scenarios.run_sweep_serial([sc], **kw)
        secs.append(one.seconds)
        ser_results.extend(one.results)
    ser = scenarios.SweepResult(fam, ser_results, sum(secs), len(fam))
    jit_sweep = functools.cache(lambda: scenarios.run_sweep(fam, **kw, masks_fn=jittered()))

    def jit(i):
        return jit_sweep().results[i]

    def branch_runs(i):
        # the member batched with its neighbour in the family, and its
        # batched run from a start moved by one ulp
        j = min(i, len(fam) - 2)
        return {"pair": scenarios.run_sweep(fam[j:j + 2], **kw).results[i - j],
                "jittered": jit(i)}
    finals = _members(fleet, "GP", "batched", bat, z, gkw["max_iters"], gkw["alpha"],
                      own=(ser,), own_more=(jit,), branch_runs=branch_runs)
    ser_finals = _members(fleet, "GP", "serial", ser, z, gkw["max_iters"], gkw["alpha"],
                          own=(bat,), seconds=secs, own_more=(jit,), branch_runs=branch_runs)
    # batched against one by one, but for the members pinned to a recorded
    # fault (each held to that fault, with its witnesses, in its own lines);
    # for those, the one-by-one path's own spread: its runs from starts
    # moved by one ulp (seeds 0-2), relative to its run
    pinned = {k[3] for k in ONLINE_KNOWN_FAULTS["cuda"] if k[0] == fleet}
    bs = {k: abs(finals[k] - c) / abs(c) for k, c in ser_finals.items()}
    bs_rel = max(v for k, v in bs.items() if k not in pinned)
    labels = [sc.label for sc in fam]
    spread = {k: [abs(scenarios.run_sweep_serial([fam[labels.index(k)]], masks_fn=jittered(seed=s),
                                                 **kw).results[0].final_cost
                      - ser_finals[k]) / abs(ser_finals[k]) for s in range(3)]
              for k in sorted(pinned & set(labels))}
    if not bs_rel <= 1e-4:
        SWEEP_FAILURES.append(f"online-trace {fleet}: batched vs serial {bs_rel}")
    from repro_torch.core import batch

    prof = _step_profile(batch.pad_instances([sc.instance for sc in fam]))
    row = {"phase": "online_trace", "fleet": fleet, "sweep_kwargs": skw, **gkw,
           "events": len(trace), "trace_equal": same, "members_equal": not mism,
           "trace_seconds": trace_s, "batched_s": bat.seconds, "serial_s": ser.seconds,
           "groups": bat.n_batches,
           "iterations_batched": sum(r.iterations for r in bat.results),
           "iterations_serial": sum(r.iterations for r in ser.results),
           "batched_vs_serial_max_rel": bs_rel,
           "batched_vs_serial_pinned": {k: bs.get(k) for k in sorted(pinned)},
           "serial_moved_starts_vs_serial_pinned": spread,
           "launches_batched": launches, "profile": prof, "card": CARD}
    emit(row)
    require(all(launches[k] > 0 for k in ("lu_factor", "chain_solve", "tagged")),
            f"online-trace {fleet}: the dense route's kernels launched: {launches}")
    return row


def _warm_resolves(z):
    """The frozen-application warm re-solves of the file on the card: the
    port's ``repair_phi`` of the reference's live strategy within 1e-5 of
    the reference's, the gate on the reference's repaired strategy equal
    (or a witnessed tie), the solve under ``sweep_parity`` with the
    reference's own other runs as witnesses (and the stricter stall-latch
    contract reported beside it), and on every committed iterate the frozen rows
    bit-equal to the start's."""
    import torch
    from _torch_cases import (WARM_KNOWN_FAULTS, gate_parity, golden_witnesses,
                              known_fault_holds, online_meta, online_sweep_kwargs,
                              online_trace, sweep_parity, warm_case, warm_parity)
    from repro_torch.core import conditions, engine, events, gp, network, traffic
    from repro_torch.core.traffic import Phi
    from repro_torch.kernels import ops

    meta = online_meta(z)
    warm = meta["warm"]
    skw, _ = online_sweep_kwargs(z, warm["fleet"])
    members = events.pad_fleet([network.table_ii_instance(skw["scenario"], seed=skw["seed"],
                                                          rate_scale=s)
                                for s in skw["scales"]], skw["spare_apps"])
    stored = online_trace(z, warm["fleet"])
    kw = {"alpha": warm["alpha"], "max_iters": warm["max_iters"]}
    alpha = torch.tensor(warm["alpha"], dtype=torch.float32, device="cuda")
    rows, seen = [], set()
    for t, ev in enumerate(stored[:warm["events"]]):
        label = f"t{t:02d}"
        members[ev.member], _ = events.apply_event(members[ev.member], ev)
        inst = members[ev.member]
        case = warm_case(z, t)

        def dev(name):
            return torch.from_numpy(case[name]).cuda()
        live, phi0 = Phi(dev("live_e"), dev("live_c")), Phi(dev("phi0_e"), dev("phi0_c"))
        repaired = traffic.repair_phi(inst, live, gp.init_phi(inst))
        repair_rel = max(rel_err(repaired.e, phi0.e)[1], rel_err(repaired.c, phi0.c)[1])
        gate = gate_parity(conditions.per_app_residual(inst, phi0), case["residual0"],
                           case["mask"], meta["gate_tol"])
        mask = torch.tensor(gate["mask"], dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = gp.solve(inst, phi0, app_mask=mask, record=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        # the same solve one step a chunk: every committed iterate seen
        frozen, frozen_ok = ~mask, True
        carry = engine.init_carry(inst, phi0)
        for _ in range(res.iterations):
            carry, *_ = engine.scan_chunk(inst, carry, alpha, 1e-4, 40, kw["max_iters"],
                                          app_mask=mask, length=1)
            frozen_ok &= bool(torch.equal(carry.phi.e[frozen], phi0.e[frozen])
                              and torch.equal(carry.phi.c[frozen], phi0.c[frozen]))
        same_end = bool(torch.equal(carry.phi.e, res.phi.e)
                        and torch.equal(carry.cost, res.cost_history[-1]))
        rep = sweep_parity(res, case, max_iters=kw["max_iters"],
                           **golden_witnesses(z, "warm", "GP", label))
        latch = warm_parity(res, case, tol=1e-4, max_iters=kw["max_iters"])
        known = WARM_KNOWN_FAULTS["cuda"].get(label)
        if known:
            seen.add(label)
        row = {"phase": "online_trace", "part": "warm", "t": t, "member": ev.member,
               "event": type(ev).__name__, "gate": gate, "repair_max_rel": repair_rel,
               "iterations": res.iterations, "reference_iterations": int(case["iterations"]),
               "final_cost": res.final_cost,
               "reference_final_cost": float(case["cost_history"][-1]),
               "frozen_rows_unmoved": frozen_ok, "stepwise_equals_solve": same_end,
               "wall_s": wall, "card": CARD, "launches": launches,
               "known_fault": known and known["reason"],
               "latch_contract": {k: latch[k] for k in ("ok", "why", "prefix_max_rel",
                                                        "final_rel")},
               **{k: rep.get(k) for k in ("ok", "why", "split", "prefix_max_rel", "final_rel",
                                          "final_tol", "flips", "first_flip",
                                          "stall_witness", "first_departure",
                                          "self_departure", "self_witness")}}
        emit(row)
        rows.append(row)
        what = f"warm {label}"
        require(repair_rel <= 1e-5, f"{what}: repair_phi within 1e-5: {repair_rel}")
        require(gate["ok"], f"{what}: gate masks: {gate}")
        require(frozen_ok and same_end, f"{what}: frozen rows unmoved ({frozen_ok}), stepwise "
                                        f"run equal to the solve ({same_end})")
        if mask.any():
            require(all(launches[k] > 0 for k in ("lu_factor", "chain_solve", "tagged")),
                    f"{what}: the dense route's kernels launched: {launches}")
        if known and rep["ok"]:
            SWEEP_FAILURES.append(f"{what}: a known fault passes now; take it out of "
                                  "_torch_cases.WARM_KNOWN_FAULTS")
        elif known and known_fault_holds(rep, known):
            SWEEP_FAILURES.append(f"{what}: not as recorded: {known_fault_holds(rep, known)}")
        elif not known and not rep["ok"]:
            SWEEP_FAILURES.append(f"{what}: {rep['why']}")
    unseen = sorted(set(WARM_KNOWN_FAULTS["cuda"]) - seen)
    require(not unseen, f"warm known faults not run: {unseen}")
    return rows


def phase_online_trace(z):
    """Both fleets' ``online-trace`` sweeps and the warm re-solves, with the
    launch counts read over the whole phase."""
    import torch
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    counts = {k: 0 for k in ops.launch_counts()}
    rows = {}
    for fleet in ("fig6", "sw"):
        rows[fleet] = _online_fleet(fleet, z)
        counts = {k: counts[k] + v for k, v in rows[fleet]["launches_batched"].items()}
    warm = _warm_resolves(z)
    for r in warm:
        counts = {k: counts[k] + v for k, v in r["launches"].items()}
    emit({"phase": "online_trace", "card": CARD, "summary": {
        f: {k: rows[f][k] for k in ("batched_s", "serial_s", "iterations_batched",
                                    "iterations_serial", "batched_vs_serial_max_rel")}
        | {"ms_per_batched_step": rows[f]["profile"]["ms_per_step"],
           "launches_per_step": rows[f]["profile"]["device_launches_per_step"],
           "idle_share": rows[f]["profile"]["idle_share"]} for f in rows},
        "warm": {"solves": len(warm), "iterations": sum(r["iterations"] for r in warm),
                 "wall_s": sum(r["wall_s"] for r in warm),
                 "latch_contract_ok": [r["t"] for r in warm if r["latch_contract"]["ok"]]},
        "launches_over_batched_sweeps_and_warm_solves": counts})
    require(all(counts[k] > 0 for k in ("lu_factor", "chain_solve", "tagged")),
            f"online_trace: the dense route's kernels launched in the phase: {counts}")


def phase_simulate(z):
    """The packet simulator on the card's instance: on the reference's GP
    strategy the file's ``SimResult`` (count and occupancy exactly, the
    mean delay within ``SIM_MEAN_TOL``, the predicted delay within 1e-5), and on the port's own GP output
    Little's law within 30% (``tests/test_simulate.py``)."""
    import dataclasses

    import torch
    from _torch_cases import SIM_MEAN_TOL, online_meta
    from repro_torch.core import gp, network
    from repro_torch.core.simulate import SimResult, simulate
    from repro_torch.core.traffic import Phi, total_cost
    from repro_torch.kernels import ops

    p = online_meta(z)["sim"]
    inst = network.table_ii_instance(p["scenario"], seed=p["seed"], rate_scale=p["rate_scale"])
    phi = Phi(e=torch.from_numpy(z["sim/phi_e"]).cuda(), c=torch.from_numpy(z["sim/phi_c"]).cuda())
    sim_kw = dict(horizon=p["horizon"], warmup=p["warmup"], seed=p["sim_seed"])
    t0 = time.perf_counter()
    got = simulate(inst, phi, **sim_kw)
    wall = time.perf_counter() - t0
    want = SimResult(**{f.name: z[f"sim/{f.name}"].item() for f in dataclasses.fields(SimResult)})
    mean_rel = abs(got.mean_delay - want.mean_delay) / abs(want.mean_delay)
    pred_rel = abs(got.predicted_delay - want.predicted_delay) / abs(want.predicted_delay)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = gp.solve(inst, alpha=p["alpha"], max_iters=p["max_iters"])
    launches = ops.launch_counts()
    own = simulate(inst, res.phi, **sim_kw)
    D = float(total_cost(inst, res.phi))
    delay_rel = abs(own.mean_delay - own.predicted_delay) / own.predicted_delay
    occ_rel = abs(own.mean_queue_occupancy - D) / D
    emit({"phase": "simulate", "card": CARD, "instance": f"abilene@{p['rate_scale']}",
          **sim_kw,
          "reference_strategy": dataclasses.asdict(got), "reference": dataclasses.asdict(want),
          "mean_delay_rel": mean_rel, "predicted_delay_rel": pred_rel,
          "simulate_wall_s": wall,
          "port_gp": {"iterations": res.iterations, "final_cost": res.final_cost,
                      "launches": launches, **dataclasses.asdict(own),
                      "delay_vs_predicted_rel": delay_rel, "occupancy_vs_cost_rel": occ_rel}})
    require((got.n_delivered, got.mean_queue_occupancy)
            == (want.n_delivered, want.mean_queue_occupancy)
            and mean_rel <= SIM_MEAN_TOL and pred_rel <= 1e-5,
            f"simulate on the reference's strategy: {got} vs {want}")
    require(own.n_delivered > 3000 and delay_rel <= 0.30 and occ_rel <= 0.30,
            f"Little's law on the port's GP output: {own}, D={D}")


SERVICE_SCALES = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)     # the fig6 fleet: FIG6_SCALES


def _service_fleet():
    from repro_torch.core import network

    return [network.table_ii_instance("abilene", seed=0, rate_scale=s) for s in SERVICE_SCALES]


def _service_solver(**kw):
    from repro_torch.serve import OnlineSolver

    return OnlineSolver(_service_fleet(), spare_apps=2, alpha=0.1, tol=1e-4, accel=True, **kw)


def _event_profile(solver, ev) -> dict:
    """Where one event's time goes: the event processed from the same
    state (a ``checkpoint``) unprofiled and under ``torch.profiler``: wall
    ms, device ms (every kernel's), launches, and the device's idle share."""
    import torch
    from _torch_cases import checkpoint, restore
    from repro_torch.kernels import ops

    ck = checkpoint(solver)

    def run():
        restore(solver, ck)
        return solver.process(ev)

    run()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    kern = device_kernels(run)
    busy = sum(ms for ms, _ in kern.values())
    top = sorted(((ms, k) for k, (ms, _) in kern.items()), reverse=True)
    restore(solver, ck)
    return {"event": type(ev).__name__, "member": ev.member, "iterations": rep.iterations,
            "wall_ms": wall, "device_ms": busy if busy > 0 else None,
            "idle_share": 1 - busy / wall if busy > 0 else None,
            "ms_per_iteration": wall / max(rep.iterations, 1),
            "device_launches": sum(n for _, n in kern.values()),
            "kernel_launches": {k: v for k, v in launches.items() if v},
            "top": [[k[:80], ms] for ms, k in top[:8]], "card": CARD}


def phase_online_service(z):
    """The online service (``serve/online.py``) against the reference's
    runs (``tests/data/torch_ref_service.npz``), on the card, one part after
    another: the fig6 50-event trace teacher-forced at every stored event
    (``service_forced_pass``), then free-running from the port's own cold
    start with a cold accelerated solve of each post-event instance beside
    it; the four-event sequence of ``tests/test_online.py``; the 100-event
    chaos trace (the port's ``chaos_trace`` equal to the stored one) with
    ``FaultInjector(seed=1, p_inject=0.15)`` and ``debug=True``.  Every
    departure from the reference needs a witness that float32 rounding
    decides it (``_torch_cases.departure_witness``); every event is held to
    the survival claims and the trace's free run to the one-sided cold
    parity.  One line per event; totals beside the reference's; one event
    profiled.  The dense route's kernels must launch."""
    import torch
    from _torch_cases import (SEQ_COLD_BOUNDS, event_from_dict, load_member_state, same_event,
                              service_forced_pass, service_free_run, service_run, service_state)
    from repro_torch.core import events, faults, network
    from repro_torch.kernels import ops
    from repro_torch.serve import OnlineSolver

    breaches, summary = [], {}
    chaos_js = service_run(z, "chaos100")
    steps = faults.chaos_trace(events.pad_fleet(_service_fleet(), spare_apps=2),
                               n_events=100, seed=0)
    stored = [[event_from_dict(e) for e in b] for b in chaos_js["steps"]]
    if not (len(steps) == len(stored)
            and all(len(a) == len(b) and all(map(same_event, a, b))
                    for a, b in zip(steps, stored))):
        breaches.append("chaos100: the port's chaos_trace is not the stored one")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    solver = _service_solver()
    forced = service_forced_pass(z, "trace50", solver, events.pad_fleet(_service_fleet(), 2))
    for line in forced["lines"]:
        emit({"phase": "online_service", "run": "trace50-forced", **line})
    breaches += forced["breaches"]
    lines = forced["lines"]
    summary["trace50-forced"] = {
        "events": len(lines), "match": sum(ln["verdict"] == "match" for ln in lines),
        "departs": sum(ln["verdict"] != "match" for ln in lines),
        "tied": sum(bool(ln["tied"]) for ln in lines if ln["verdict"] != "match"),
        "witness": {k: sum(ln.get("witness", {}).get("kind") == k for ln in lines)
                    for k in ("float64", "step", "branch")},
        "iterations": sum(ln["iterations"] for ln in lines),
        "reference_iterations": sum(ln["reference_iterations"] for ln in lines),
        "seconds": time.perf_counter() - t0,
        "event_seconds": sum(ln["seconds"] for ln in lines),
        "witness_seconds": sum(ln["witness_seconds"] for ln in lines)}
    seq_inst = network.table_ii_instance("abilene", seed=0, rate_scale=0.5)
    runs = {"trace50": dict(make_solver=_service_solver, cold_parity="run_trace"),
            "seq": dict(make_solver=lambda: OnlineSolver([seq_inst], alpha=0.1, tol=1e-4,
                                                         accel=True),
                        cold_parity=SEQ_COLD_BOUNDS),
            "chaos100": dict(make_solver=lambda: _service_solver(
                debug=True, fault_injector=faults.FaultInjector(seed=1, p_inject=0.15)),
                steps=steps)}
    for part, kw in runs.items():
        t0 = time.perf_counter()
        run = service_free_run(z, part, **kw)
        run.pop("solver")
        run["final_costs"] = [h.cost for h in run.pop("final")]
        run["seconds"]["total"] = time.perf_counter() - t0
        for line in run["lines"]:
            emit({"phase": "online_service", "run": part + "-free", **line})
        breaches += run["breaches"]
        tot = run["totals"]
        summary[part + "-free"] = {
            "totals": tot, "reference": run["reference"], "cold": run["cold"],
            "departed_members": run["diverged"], "seconds": run["seconds"],
            "ms_per_committed_iteration": run["seconds"]["events"] * 1e3
            / max(tot["event_iters"], 1), "final_costs": run["final_costs"]}
    launches = ops.launch_counts()
    # one event profiled: the trace's first (a 40-iteration warm round),
    # from the reference's stored state
    ev = event_from_dict(service_run(z, "trace50")["events"][0])
    load_member_state(solver, ev.member, events.pad_fleet(_service_fleet(), 2)[ev.member],
                      service_state(z, "trace50", 0))
    emit({"phase": "online_service", "part": "profile", **_event_profile(solver, ev)})
    emit({"phase": "online_service", "card": CARD, "summary": summary,
          "reference_anchors_jax": json.loads(str(z["meta"]))["anchors"],
          "launches": launches, "breaches": breaches})
    require(all(launches[k] > 0 for k in ("lu_factor", "chain_solve", "tagged")),
            f"online_service: the dense route's kernels launched: {launches}")
    require(not breaches, f"online_service: {breaches}")
    return summary


PARENT_PATHS = ("solve", "metro", "dense300", "fig6")


def phase_versus_parent(tree):
    """Parent against change on the main paths (``--parent TREE``, a
    checkout of the parent commit): ``scripts/compare_solve.py TREE .
    --profile`` for the sw-queue solve, 32 metro-sw steps, 32 dense V = 300
    steps and the batched Fig. 6 GP sweep, each tree in its own process, in
    the order parent, change, change, parent.  Per path: each tree's wall
    times and their medians, launches and device ms per step from the
    profiler, and the cost histories' digests, which must agree (the
    blocked sets are bit-equal, so every trajectory is the parent's)."""
    script = os.path.join(HERE, "scripts", "compare_solve.py")
    out = {}
    for what in PARENT_PATHS:
        proc = subprocess.run([sys.executable, script, os.path.abspath(tree), HERE, "--what",
                               what, "--rounds", "1", "--reps", "3" if what == "fig6" else "5",
                               "--profile"], capture_output=True, text=True, timeout=900)
        require(proc.returncode == 0, f"compare_solve {what}: {proc.stderr[-3000:]}")
        runs = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        require(len(runs) == 4, f"compare_solve {what}: four runs, got {len(runs)}")
        key = "median_seconds" if what == "fig6" else "median_ms_per_step"
        turns = [r[key] for r in runs]
        digests = {r["cost_sha256"] for r in runs}
        row = {"phase": "versus_parent", "what": what, "order": ["parent", "change", "change",
                                                                 "parent"],
               "abba": turns, "parent": (turns[0] + turns[3]) / 2,
               "change": (turns[1] + turns[2]) / 2, "unit": "s" if what == "fig6" else "ms/step",
               "spread_parent": abs(turns[0] - turns[3]), "spread_change": abs(turns[1] - turns[2]),
               "launches_per_step": [r.get("device_launches_per_step") for r in runs],
               "device_ms_per_step": [r.get("device_ms_per_step") for r in runs],
               "iterations": [r["iterations"] for r in runs], "same_trajectory": len(digests) == 1,
               "runs": runs}
        emit(row)
        out[what] = row
        require(len(digests) == 1, f"{what}: the parent's and the change's cost histories "
                                   f"differ: {[r['iterations'] for r in runs]}")
    return out


PHASE_SECONDS: dict = {}


def phased(name, fn, *args):
    """Run one phase, adding its wall seconds to ``PHASE_SECONDS[name]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev", metavar="DIR",
                    help="a directory holding earlier bsr_chain.cu (commit f4ca93a), "
                         "batched_lu.cu, chain_solve.cu and strip_sweep.cuh "
                         "(commit 8ee676d), flash_attention.cu and ssd_chunk.cu "
                         "(commit 14c1039), tagged.cu and tagged_nbr.cu (commit "
                         "5b53a6a): build those it holds and time them beside the "
                         "redesigned kernels (prev_ms)")
    ap.add_argument("--parent", metavar="TREE",
                    help="a checkout of the parent commit: time its main paths against "
                         "this tree's in turns (phase versus_parent)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if (not os.path.isdir(os.path.join(src, "repro_torch"))
            or not all(os.path.exists(f) for f in (GOLDEN, GOLDEN_METRO, GOLDEN_EDGE,
                                                   GOLDEN_SWEEP, GOLDEN_DENSE, GOLDEN_ONLINE,
                                                   GOLDEN_SERVICE, DIGESTS, SCALE_DIGESTS,
                                                   BSR_DIGESTS))):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path[:0] = [src, TESTS]
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    from _torch_cases import HELD_SWEEPS

    import numpy as np

    with open(GOLDEN) as fh:
        ref = json.load(fh)
    ref_metro = dict(np.load(GOLDEN_METRO))
    with open(GOLDEN_EDGE) as fh:
        ref_edge = json.load(fh)
    smi = phase_device()
    pool = concurrent.futures.ProcessPoolExecutor(
        3, mp_context=multiprocessing.get_context("spawn"))
    try:
        inputs = digest_case_inputs(pool)
        prev = phased("build", phase_build, args.prev)
        phased("inputs", concurrent.futures.wait, list(inputs.values()))
    finally:
        pool.shutdown(cancel_futures=True)
    kernels = phased("kernel", phase_kernels, prev)
    phased("digests", phase_digests, inputs)
    launches, ms_per_step = phased("solve", phase_solve, ref)
    phased("profile", phase_profile, ms_per_step)
    phased("parity", phase_parity, ref)
    kernels.update(phased("sparse_kernels", phase_sparse_kernels, prev))
    metro_launches, metro_ms_per_step = phased("metro", phase_metro, ref_metro)
    phased("metro_profile", phase_metro_profile, metro_ms_per_step)
    for name, rows in phased("dense_scale_kernels", phase_dense_scale_kernels,
                             inputs, prev).items():
        kernels.setdefault(name, []).extend(rows)
    with np.load(GOLDEN_DENSE) as z:
        phased("dense_scale", phase_dense_scale, {k: z[k] for k in z.files})
    kernels.update(phased("model_kernels", phase_model_kernels, prev))
    chains = phased("edge_gp", phase_edge_gp, ref_edge)
    model_launches = phased("edge_forwards", phase_edge_forwards, chains)
    for name, rows in phased("solve_kernels", phase_solve_kernels).items():
        kernels[name] = rows + kernels.get(name, [])
    oracle_launches = phased("oracle", phase_oracle)
    with np.load(GOLDEN_SWEEP) as z:
        ref_sweep = {k: z[k] for k in z.files}
    for fig in ("fig6", "fig5", *HELD_SWEEPS):
        phased(f"sweep_{fig}", phase_sweep, fig, ref_sweep)
    with np.load(GOLDEN_ONLINE) as z:
        ref_online = {k: z[k] for k in z.files}
    phased("online_trace", phase_online_trace, ref_online)
    phased("simulate", phase_simulate, ref_online)
    with np.load(GOLDEN_SERVICE) as z:
        phased("online_service", phase_online_service, {k: z[k] for k in z.files})
    emit({"phase": "seconds", **PHASE_SECONDS})
    from _torch_cases import KNOWN_FAULTS

    unseen = sorted(set(KNOWN_FAULTS["cuda"]) - KNOWN_SEEN)
    require(not SWEEP_FAILURES and not unseen,
            f"sweep members: {SWEEP_FAILURES}; known faults not run: {unseen}")
    phased("sweep_profile", phase_sweep_profile)
    if args.parent:
        phased("versus_parent", phase_versus_parent, args.parent)
    # each kernel's launches come from the main path it lies on; lu_solve
    # and propagate_step lie on no solver path: theirs are the oracle phase's
    launches.update({k: metro_launches[k] for k in ("bsr_chain", "tagged_nbr")})
    launches.update(model_launches)
    launches.update(oracle_launches)

    # the main row of each kernel (its main path's shape) among its cases
    meta = {
        "lu_factor": ("src/repro_torch/kernels/csrc/batched_lu.cu",
                      "src/repro/kernels/batched_solve.py:418", 1),
        "chain_solve": ("src/repro_torch/kernels/csrc/chain_solve.cu",
                        "src/repro/kernels/batched_solve.py:462", 2),
        "lu_solve": ("src/repro_torch/kernels/csrc/lu_solve.cu",
                     "src/repro/kernels/batched_solve.py:440", 0),
        "tagged": ("src/repro_torch/kernels/csrc/tagged.cu",
                   "src/repro/kernels/blocked_sets.py:182", 1),
        "bsr_chain": ("src/repro_torch/kernels/csrc/bsr_chain.cu",
                      "src/repro/kernels/sparse_solve.py:217", 2),
        "tagged_nbr": ("src/repro_torch/kernels/csrc/tagged_nbr.cu",
                       "src/repro/kernels/sparse_solve.py:256", 0),
        "propagate_step": ("src/repro_torch/kernels/csrc/chain_propagate.cu",
                           "src/repro/kernels/chain_propagate.py:37", 0),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:73", 0),
        "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
                      "src/repro/kernels/ssd_chunk.py:46", 0),
    }
    line = []
    for name, (source, replaces, pick) in meta.items():
        rows = kernels[name]
        main_row = rows[pick]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "launches_over": ("oracle phase" if name in oracle_launches
                                       else "main path"),
                     "max_abs_err": max(r["max_abs_err"] for r in rows),
                     "ms": main_row["ms"], "ms_source": main_row["ms_source"],
                     "event_ms": main_row["event_ms"], "plain_ms": main_row["plain_ms"],
                     "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                     "library_ms": main_row["library_ms"],
                     "bound_tc_ms": main_row.get("bound_tc_ms"),
                     "prev_ms": main_row.get("prev_ms"),
                     "prev_launches_per_call": main_row.get("prev_launches_per_call"),
                     "prev_commit": main_row.get("prev_commit"),
                     "shape": main_row["shape"], "cases": rows})
    emit({"phase": "profiler", "empty_traces_retaken": EMPTY_TRACES})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
