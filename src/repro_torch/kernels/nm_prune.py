"""Fused Amber scoring + per-token N:M mask: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/nm_prune.py:nm_prune_pallas``: per
token, score ``|x|·scale`` in float32, keep the top N of every contiguous
group of M channels (first occurrence wins a tie), zero the rest, in x's
dtype.  The kernel is ``nm_prune_matmul``'s selection pass
(``csrc/nm_prune_matmul.cu``: ``nm_select_vec_kernel``, 16-byte vectors and
a rank count per group, for group widths 1-32 that are powers of two and
aligned pointers; else ``nm_select_kernel``, one thread per token × group)
behind its own entry point; it is bound by one read of x and one write of
the result, and its masks are bit-identical to the plain version's.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``nm_prune.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import nm, scoring
from repro_torch.kernels import _build, _meta

__all__ = ["nm_prune", "nm_prune_plain"]

SOURCE = "src/repro_torch/kernels/csrc/nm_prune_matmul.cu"
REPLACES = "src/repro/kernels/nm_prune.py:58"
_MAX_M = 32
_SYMBOLS = {torch.bfloat16: "nm_prune_bf16", torch.float32: "nm_prune_f32"}


def _fn(dtype: torch.dtype):
    lib = _build.load("nm_prune_matmul.cu")
    fn = getattr(lib, _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nm_prune_plain(x: torch.Tensor, scale: torch.Tensor | None, n: int,
                   m: int) -> torch.Tensor:
    """Plain version: ``core.scoring`` scores, ``core.nm`` mask."""
    return nm.apply_nm(x, scoring.score_activations(x, scale), n, m)


def nm_prune(x: torch.Tensor, scale: torch.Tensor | None, n: int, m: int) -> torch.Tensor:
    """``x (T, D)`` with all but the top N of every M channels zeroed;
    ``scale`` is the ``(D,)`` float32 Amber channel scale or None."""
    if x.device.type == "cpu":
        return nm_prune_plain(x, scale, n, m)
    if x.device.type == "meta":
        return _meta.nm_prune(x, scale, n, m)
    _build.refuse_grad("nm_prune", x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"nm_prune: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in _SYMBOLS or not x.is_contiguous():
        raise ValueError("nm_prune: x must be a contiguous (T, D) bfloat16 or float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    t, d = x.shape
    if not (0 < n <= m <= _MAX_M and d % m == 0):
        raise ValueError(f"nm_prune: N:M {n}:{m} with D={d} (need "
                         f"0 < N <= M <= {_MAX_M} and D % M == 0)")
    if x.numel() >= 2**31:
        raise ValueError("nm_prune: tensor exceeds int32 indexing")
    if scale is not None and (scale.dtype != torch.float32 or scale.shape != (d,)
                              or scale.device != x.device or not scale.is_contiguous()):
        raise ValueError(f"nm_prune: scale must be contiguous float32 (D,) on {x.device}")
    out = torch.empty_like(x)
    if t == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _fn(x.dtype)(x.data_ptr(), None if scale is None else scale.data_ptr(),
                          out.data_ptr(), t, d, n, m,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nm_prune kernel launch failed (CUDA error {rc})")
    nm_prune.launches += 1
    return out


nm_prune.launches = 0
