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

Training: where autograd records the call (grad mode on and ``x``
requiring grad; the routed experts' gate and down inputs under
``--sparse-train``) it goes through :class:`Prune`, a
``torch.autograd.Function``.  Its forward is the same single launch, with
the selection also writing its keep-mask (one byte a channel); the
backward is ``dX = where(keep, dY, 0)``, the gradient of the reference's
``jnp.where(mask, x, 0)`` (``repro/core/nm.py:75``).  The mask is the
kernel's own selection, not ``out != 0``: a kept channel whose value is
exactly 0 passes its gradient.  The channel scale is a buffer and the
selection has no derivative, so neither gets a gradient.  On the CPU the
Function's forward is the plain version with its mask exposed, so the
tests run the same backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import nm, scoring
from repro_torch.kernels import _build, _meta

__all__ = ["Prune", "nm_prune", "nm_prune_plain"]

SOURCE = "src/repro_torch/kernels/csrc/nm_prune_matmul.cu"
REPLACES = "src/repro/kernels/nm_prune.py:58"
_MAX_M = 32
_SYMBOLS = {torch.bfloat16: "nm_prune_bf16", torch.float32: "nm_prune_f32"}


def _fn(dtype: torch.dtype):
    lib = _build.load("nm_prune_matmul.cu")
    fn = getattr(lib, _SYMBOLS[dtype])
    # x, scale, out, keep (null: no mask), then T, D, n, m and the stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _plain(x: torch.Tensor, scale: torch.Tensor | None, n: int, m: int):
    """The plain version's ``(out, keep)``: ``core.nm``'s mask and the
    pruned input."""
    keep = nm.nm_topk_mask(scoring.score_activations(x, scale), n, m)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device)), keep


def nm_prune_plain(x: torch.Tensor, scale: torch.Tensor | None, n: int,
                   m: int) -> torch.Tensor:
    """Plain version: ``core.scoring`` scores, ``core.nm`` mask."""
    return _plain(x, scale, n, m)[0]


def _launch(x: torch.Tensor, scale: torch.Tensor | None, n: int, m: int, with_keep: bool):
    """One kernel launch on CUDA tensors → ``(out, keep)``: ``keep`` the
    selection as ``(T, D)`` uint8 where ``with_keep`` (else None; the kernel
    then writes no mask)."""
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
    keep = torch.empty((t, d), dtype=torch.uint8, device=x.device) if with_keep else None
    if t == 0:
        return out, keep
    with torch.cuda.device(x.device):
        rc = _fn(x.dtype)(x.data_ptr(), None if scale is None else scale.data_ptr(),
                          out.data_ptr(), None if keep is None else keep.data_ptr(), t, d, n,
                          m, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nm_prune kernel launch failed (CUDA error {rc})")
    nm_prune.launches += 1
    return out, keep


class Prune(torch.autograd.Function):
    """``nm_prune`` under autograd: the forward is the kernel (the plain
    version on the CPU) with its selection kept, the backward
    ``where(keep, dY, 0)`` (module docstring)."""

    @staticmethod
    def forward(ctx, x, scale, n, m):
        if x.device.type == "cpu":
            out, keep = _plain(x, scale, n, m)
        elif x.device.type == "meta":
            out = _meta.nm_prune(x, scale, n, m)
            keep = torch.empty(x.shape, dtype=torch.uint8, device="meta")
        else:
            out, keep = _launch(x, scale, n, m, with_keep=True)
        ctx.save_for_backward(keep)
        return out

    @staticmethod
    def backward(ctx, dy):
        (keep,) = ctx.saved_tensors
        # the kernel's uint8 mask holds 0/1: a bool view, no copy
        dx = torch.where(keep.view(torch.bool), dy,
                         torch.zeros((), dtype=dy.dtype, device=dy.device))
        return dx, None, None, None


def nm_prune(x: torch.Tensor, scale: torch.Tensor | None, n: int, m: int) -> torch.Tensor:
    """``x (T, D)`` with all but the top N of every M channels zeroed;
    ``scale`` is the ``(D,)`` float32 Amber channel scale or None.  Where
    autograd records the call, it goes through :class:`Prune`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Prune.apply(x, scale, n, m)
    if x.device.type == "cpu":
        return nm_prune_plain(x, scale, n, m)
    if x.device.type == "meta":
        return _meta.nm_prune(x, scale, n, m)
    return _launch(x, scale, n, m, with_keep=False)[0]


nm_prune.launches = 0
