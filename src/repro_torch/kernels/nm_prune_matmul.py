"""Fused per-token N:M prune + GEMM: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/nm_prune_matmul.py:
nm_prune_matmul_pallas`` (selection ``repro/kernels/nm_prune.py:
_select_topn_mask``).  Per token: score ``|x|·scale`` in float32, keep the
top N of every contiguous group of M channels (first occurrence wins a
tie), zero the rest, then ``x_pruned @ w (+ bias)`` with a float32
accumulator; the output dtype is ``result_type(x, w)``.

On the H100 the serving path's call (T = 256 prefill tokens against a
LLaMA-3.1-8B projection) is bound by the weight read from device memory;
``csrc/nm_prune_matmul.cu`` says how its design answers that: a selection
pass writes the pruned activations once into scratch the wrapper
allocates (|x| bytes, a few percent of the weight read), and a wgmma GEMM
fed by a TMA ring multiplies them; where its output tiles would leave SMs
idle it splits k and writes float32 partials to a workspace the wrapper
allocates, reduced in a fixed order (:func:`gemm_plan` says which).  A bf16
``w`` the TMA cannot take (not 16-byte aligned, or D or N_out not a
multiple of 8) goes to a WMMA kernel instead: a shape route between two
hand kernels, not a fallback.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``nm_prune_matmul.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import nm, scoring
from repro_torch.kernels import _build

__all__ = ["gemm_plan", "nm_prune_matmul", "nm_prune_matmul_plain"]

SOURCE = "src/repro_torch/kernels/csrc/nm_prune_matmul.cu"
REPLACES = "src/repro/kernels/nm_prune_matmul.py:67"
_MAX_M = 32       # the selection keeps a group's bits in one 32-bit word
_SYMBOLS = {torch.bfloat16: "nm_prune_matmul_bf16",
            torch.float32: "nm_prune_matmul_f32"}


def _fn(dtype: torch.dtype):
    lib = _build.load("nm_prune_matmul.cu")
    fn = getattr(lib, _SYMBOLS[dtype])
    # the bf16 entry takes the split-k workspace after ``out``
    n_ptr = 7 if dtype == torch.bfloat16 else 6
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gemm_plan(w: torch.Tensor, t: int) -> int:
    """The bf16 GEMM's route for ``w`` at ``t`` tokens, as the kernel takes
    it: 0 = the WMMA kernel (``w`` not 16-byte aligned, or D or N_out not a
    multiple of 8), else the wgmma kernel in that many k slices (> 1: a
    float32 workspace of slices * T * N_out and the ordered reduce)."""
    fn = _build.load("nm_prune_matmul.cu").nm_prune_matmul_bf16_plan
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(w.device):
        return fn(w.data_ptr(), t, w.shape[0], w.shape[1])


def nm_prune_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor | None, n: int, m: int,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: mask with ``core.nm`` then a float32 matmul."""
    xp = nm.apply_nm(x, scoring.score_activations(x, scale), n, m)
    y = xp.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(torch.result_type(x, w))


def nm_prune_matmul(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor | None, n: int, m: int,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x (T, D) @ w (D, N_out)`` with per-token N:M pruning of ``x``.

    ``scale`` is the ``(D,)`` float32 Amber channel scale or None (plain
    ``|x|``); ``bias`` an optional ``(N_out,)`` epilogue add.
    """
    if x.device.type == "cpu":
        return nm_prune_matmul_plain(x, w, scale, n, m, bias)
    if x.device.type != "cuda":
        raise ValueError(f"nm_prune_matmul: unsupported device {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"nm_prune_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _SYMBOLS:
        raise TypeError(f"nm_prune_matmul: dtypes {x.dtype}/{w.dtype}; the kernel "
                        "takes bfloat16 or float32 for both")
    t, d = x.shape
    n_out = w.shape[1]
    if not (0 < n <= m <= _MAX_M and d % m == 0):
        raise ValueError(f"nm_prune_matmul: N:M {n}:{m} with D={d} (need "
                         f"0 < N <= M <= {_MAX_M} and D % M == 0)")
    if max(t, d, n_out) >= 2**31:
        raise ValueError("nm_prune_matmul: dimension exceeds int32")
    for name, a in (("x", x), ("w", w), ("scale", scale)):
        if a is not None and (a.device != x.device or not a.is_contiguous()):
            raise ValueError(f"nm_prune_matmul: {name} must be contiguous on {x.device}")
    if scale is not None and (scale.dtype != torch.float32 or scale.shape != (d,)):
        raise ValueError("nm_prune_matmul: scale must be float32 of shape (D,)")
    if bias is not None:
        if bias.shape != (n_out,) or bias.device != x.device:
            raise ValueError("nm_prune_matmul: bias must be (N_out,) on x's device")
        bias = bias.float().contiguous()      # added to the float32 sum
    out = torch.empty((t, n_out), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    xp = torch.empty_like(x)                 # scratch: the pruned activations
    ptrs = [x.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), xp.data_ptr(), out.data_ptr()]
    if x.dtype == torch.bfloat16:
        slices = gemm_plan(w, t)
        part = (torch.empty((slices, t, n_out), dtype=torch.float32, device=x.device)
                if slices > 1 else None)
        ptrs.append(None if part is None else part.data_ptr())
    with torch.cuda.device(x.device):
        rc = _fn(x.dtype)(*ptrs, t, d, n_out, n, m,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nm_prune_matmul kernel launch failed (CUDA error {rc})")
    nm_prune_matmul.launches += 1
    return out


nm_prune_matmul.launches = 0
