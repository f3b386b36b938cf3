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

Training (``--sparse-train``): where autograd records the call (grad mode
on and ``x``, ``w`` or ``bias`` requiring grad) it goes through
:class:`PruneMatmul`, a ``torch.autograd.Function``.  Its forward is the
same single launch, with the selection kernel also writing its keep-mask
(one byte a channel) beside the pruned activations ``xp``, which the
wrapper already allocates as scratch; both are kept for the backward:
``dX = (dY @ wᵀ) ⊙ keep``, ``dW = xpᵀ @ dY``, ``db = Σ_rows dY``, two
``torch.matmul`` products and a sum (the reference leaves its backward to
XLA; no TPU kernel has one).  The mask is the kernel's own selection, not
``xp != 0``: a kept channel whose value is exactly 0 passes its gradient,
as ``jnp.where(mask, x, 0)`` does (``repro/core/nm.py:75``).  The channel
scale is a buffer and the selection has no derivative, so neither gets a
gradient.  On the CPU the Function's forward is the plain version with its
mask exposed, so the tests run the same backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import nm, scoring
from repro_torch.kernels import _build, _meta

__all__ = ["PruneMatmul", "gemm_plan", "nm_prune_matmul", "nm_prune_matmul_plain", "takes_wgmma"]

SOURCE = "src/repro_torch/kernels/csrc/nm_prune_matmul.cu"
REPLACES = "src/repro/kernels/nm_prune_matmul.py:67"
_MAX_M = 32       # the selection keeps a group's bits in one 32-bit word
_SYMBOLS = {torch.bfloat16: "nm_prune_matmul_bf16",
            torch.float32: "nm_prune_matmul_f32"}


def _fn(dtype: torch.dtype):
    lib = _build.load("nm_prune_matmul.cu")
    fn = getattr(lib, _SYMBOLS[dtype])
    # the bf16 entry takes the split-k workspace after ``out``; both then
    # take the keep-mask output
    # and the bf16 entry the GEMM's plan after n and m
    n_ptr, n_int = (8, 6) if dtype == torch.bfloat16 else (7, 5)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gemm_plan(w: torch.Tensor, t: int, n_out: int | None = None) -> int:
    """The bf16 GEMM's route for ``w`` at ``t`` tokens (for ``n_out``
    columns: a held column shard plans for the whole weight's), as the
    kernel takes it: 0 = the WMMA kernel (``w`` not 16-byte aligned, or D or N_out not a
    multiple of 8), else the wgmma kernel in that many k slices (> 1: a
    float32 workspace of slices * T * N_out and the ordered reduce).  Any
    plan is valid for a ``w`` that :func:`takes_wgmma`; 0 for every ``w``."""
    fn = _build.load("nm_prune_matmul.cu").nm_prune_matmul_bf16_plan
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(w.device):
        return fn(w.data_ptr(), t, w.shape[0], w.shape[1] if n_out is None else n_out)


def takes_wgmma(w: torch.Tensor) -> bool:
    """Whether the wgmma GEMM can take ``w`` (the TMA's 16-byte rule)."""
    return w.data_ptr() % 16 == 0 and w.shape[0] % 8 == 0 and w.shape[1] % 8 == 0


def _plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None, n: int, m: int,
           bias: torch.Tensor | None):
    """The plain version's ``(out, xp, keep)``: ``core.nm``'s mask, the
    pruned input, then a float32 matmul."""
    keep = nm.nm_topk_mask(scoring.score_activations(x, scale), n, m)
    xp = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    y = xp.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(torch.result_type(x, w)), xp, keep


def nm_prune_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor | None, n: int, m: int,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: mask with ``core.nm`` then a float32 matmul."""
    return _plain(x, w, scale, n, m, bias)[0]


def _launch(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None, n: int, m: int,
            bias: torch.Tensor | None, with_keep: bool, plan: int | None = None):
    """One kernel launch on CUDA tensors → ``(out, xp, keep)``: ``xp`` the
    pruned-activation scratch, ``keep`` the selection as ``(T, D)`` uint8
    where ``with_keep`` (else None; the kernel then writes no mask).
    ``plan``: the bf16 GEMM's :func:`gemm_plan` to take (default: the one
    for these shapes)."""
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
    xp = torch.empty_like(x)                 # scratch: the pruned activations
    keep = torch.empty((t, d), dtype=torch.uint8, device=x.device) if with_keep else None
    if t == 0:
        return out, xp, keep
    ptrs = [x.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), xp.data_ptr(), out.data_ptr()]
    if x.dtype == torch.bfloat16:
        slices = gemm_plan(w, t) if plan is None else plan
        if slices < 0 or (slices > 0 and not takes_wgmma(w)):
            raise ValueError(f"nm_prune_matmul: plan {slices} for w {tuple(w.shape)} "
                             "(the wgmma GEMM needs a 16-byte aligned w, D and N_out "
                             "multiples of 8)")
        part = (torch.empty((slices, t, n_out), dtype=torch.float32, device=x.device)
                if slices > 1 else None)
        ptrs.append(None if part is None else part.data_ptr())
    ptrs.append(None if keep is None else keep.data_ptr())
    ints = [t, d, n_out, n, m] + ([slices] if x.dtype == torch.bfloat16 else [])
    with torch.cuda.device(x.device):
        rc = _fn(x.dtype)(*ptrs, *ints, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nm_prune_matmul kernel launch failed (CUDA error {rc})")
    nm_prune_matmul.launches += 1
    return out, xp, keep


class PruneMatmul(torch.autograd.Function):
    """``nm_prune_matmul`` under autograd: the forward is the kernel (the
    plain version on the CPU) with its selection kept, the backward two
    products and a sum (module docstring)."""

    @staticmethod
    def forward(ctx, x, w, bias, scale, n, m):
        if x.device.type == "cpu":
            y, xp, keep = _plain(x, w, scale, n, m, bias)
        elif x.device.type == "meta":
            y = _meta.nm_prune_matmul(x, w, scale, n, m, bias)
            xp, keep = torch.empty_like(x), torch.empty(x.shape, dtype=torch.uint8,
                                                        device="meta")
        else:
            y, xp, keep = _launch(x, w, scale, n, m, bias, with_keep=True)
        ctx.save_for_backward(xp, keep, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        xp, keep, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # the kernel's uint8 mask holds 0/1: a bool view, no copy
            dx = torch.where(keep.view(torch.bool), dy @ w.t(),
                             torch.zeros((), dtype=dy.dtype, device=dy.device))
        if ctx.needs_input_grad[1]:
            dw = (xp.t() @ dy).to(w.dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = dy.sum(0).to(ctx.bias_dtype)
        return dx, dw, db, None, None, None


def nm_prune_matmul(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor | None, n: int, m: int,
                    bias: torch.Tensor | None = None, plan: int | None = None) -> torch.Tensor:
    """``x (T, D) @ w (D, N_out)`` with per-token N:M pruning of ``x``.

    ``scale`` is the ``(D,)`` float32 Amber channel scale or None (plain
    ``|x|``); ``bias`` an optional ``(N_out,)`` epilogue add.  ``plan``: the
    bf16 GEMM's :func:`gemm_plan` to take instead of this call's own (a
    column shard takes the unsharded call's, so that its float32 sums run in
    the same order); the CPU has none.  Where autograd records the call, it
    goes through :class:`PruneMatmul`.
    """
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad
                                       for a in (x, w, bias)):
        return PruneMatmul.apply(x, w, bias, scale, n, m)
    if x.device.type == "cpu":
        return nm_prune_matmul_plain(x, w, scale, n, m, bias)
    if x.device.type == "meta":
        return _meta.nm_prune_matmul(x, w, scale, n, m, bias)
    return _launch(x, w, scale, n, m, bias, with_keep=False, plan=plan)[0]


nm_prune_matmul.launches = 0
