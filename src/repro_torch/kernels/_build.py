"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C entry points (no PyTorch headers),
so one ``nvcc`` call per source takes seconds.  The shared libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source is rebuilt and an unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per source, all at
once, and waits for every one of them.

No ``--use_fast_math``: the kernels rely on IEEE division and on NaN/inf
propagating exactly as in the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("batched_lu", "chain_solve", "lu_solve", "tagged", "bsr_chain",
           "tagged_nbr", "chain_propagate", "flash_attention", "ssd_chunk")
# Shared memory one thread block may use on Hopper (227 KB, set per kernel
# above 48 KB with cudaFuncSetAttribute).
SMEM_LIMIT = 232_448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
# Libraries built in this process and the seconds they took: each a miss of
# the on-disk cache (``obs.metrics.collect_compile_caches`` gauges it).
BUILDS = {"count": 0, "seconds": 0.0}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on PATH, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    # the shared headers (two_sweep.cuh) are part of every source's hash
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel; returns
    ``{name: {"seconds": s, "ptxas": text}}`` for the ones built now.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        BUILDS["count"] += 1
        BUILDS["seconds"] += report[name]["seconds"]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, typed once; it
    returns a CUDA error code."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise if a C entry point of ``csrc/<name>.cu`` returned a CUDA error."""
    if rc != 0:
        fn = load(name).repro_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc}: {fn(rc).decode()}")
