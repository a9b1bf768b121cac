"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ file under ``repro_torch/csrc/`` with a
plain C interface; the ``*.cuh`` headers beside them hold shared device
code.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/repro_torch_kernels/``
at the root of the checkout and loaded with ``ctypes``.  The library's
name carries a hash of the source, the headers and the flags, so an
edited source is never served from a stale build.  ``--use_fast_math`` is deliberately
absent: ``topk_quant`` is bit-exact with its reference only under IEEE
division and round-to-nearest conversions.

Nothing here falls back: without ``nvcc`` or a Hopper card every entry
point raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("grad_diff_norm", "topk_quant", "flash_attention", "linear_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_build_lock = threading.Lock()   # one build at a time in a process (shared tmp names)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (searched PATH and CUDA_HOME): the port's "
                       "CUDA kernels cannot be built on this host")


def require_hopper() -> None:
    """Raise unless a CUDA card of compute capability 9.0 is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on an "
                           "NVIDIA Hopper card (pass CPU tensors for the plain path)")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(f"the port's kernels are built for sm_90a; this card "
                           f"has compute capability {cap[0]}.{cap[1]}")


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    return src, so, so.with_suffix(".log")


def library_path(name: str) -> Path:
    """Where the built shared library of one kernel lies (built or not)."""
    return _paths(name)[1]


def build(names=KERNELS) -> dict:
    """Compile every kernel in ``names`` that is not built yet, all
    ``nvcc`` processes at once; return each kernel's compiler log (the
    ``-Xptxas -v`` register and shared-memory report).  Raises with the
    compiler's output if any build fails.  Each finished build is
    counted, with its seconds, by ``repro_torch.obs.compile_tracking``
    (the ``jit_compiles`` gauge of an observed run)."""
    from repro_torch.obs import compile_tracking
    require_hopper()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        src, so, log = _paths(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        jobs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        log.write_text(out)
        os.replace(tmp, so)   # atomic: a concurrent process never loads half a file
        compile_tracking.record(time.perf_counter() - t0)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _paths(name)[2].read_text() for name in names}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built on first use (by
    one thread: the others wait for it)."""
    with _build_lock:
        build((name,))
        return ctypes.CDLL(str(_paths(name)[1]))

