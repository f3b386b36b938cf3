"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources at once in parallel, and loaded with ``ctypes``.
Libraries land in ``build/repro_torch_kernels/<key>/`` at the repository
root (listed in ``.gitignore``), where ``<key>`` hashes the sources and the
compiler flags: an edited source rebuilds, an unchanged one loads.  The
build runs at the first launch of a kernel (or when ``chip_smoke.py``
calls :func:`build`), never at import.

:func:`refuse_grad` is the one guard of the kernels that have no backward:
their wrappers call it on CUDA tensors, before the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

__all__ = ["build", "load", "refuse_grad", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention.cu", "nm_prune_matmul.cu", "nm_spmm.cu",
           "osparse_matmul.cu", "paged_attention.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _key() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Dict[str, object]:
    """Compile every source not yet built under the current key, in
    parallel.  Returns ``{"dir", "seconds", "logs": {source: ptxas output}}``
    and raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    out_dir = _BUILD_ROOT / _key()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in SOURCES:
        target = out_dir / (Path(src).stem + ".so")
        if target.exists():
            continue
        tmp = out_dir / f".{target.name}.{os.getpid()}.tmp"
        procs[src] = (subprocess.Popen(
            [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
    logs, failed = {}, []
    for src, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[src] = out
        if proc.returncode != 0:
            failed.append(f"--- {src} (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, target)   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {"dir": str(out_dir), "seconds": time.perf_counter() - t0,
            "logs": logs}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        path = _BUILD_ROOT / _key() / (Path(source).stem + ".so")
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        _loaded[source] = lib
    return lib


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` when autograd would record a call of
    ``kernel``, a kernel with no backward: grad mode is on and an input
    requires grad.  A ctypes launch on ``data_ptr()`` returns a tensor with
    no ``grad_fn``, so the gradient would stop there without a word.  The
    serving paths run under ``no_grad`` on parameters that need none, so
    this never fires there."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: the CUDA kernel has no backward; it cannot run "
                           "where autograd records (an input requires grad)")
