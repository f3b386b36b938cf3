"""Fused Outstanding-sparse projection: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/osparse_matmul.py:
osparse_matmul_pallas``.  Per token row: ``xs = x / smooth``; when
``prune``, keep the top N of every group of M channels by ``|xs|·amber``
(first occurrence wins a tie) and zero the rest; quantize to int8 with the
static ``act_scale`` or, ``per_token``, with ``max(absmax, 1e-8)/127`` of the
pruned row (half to even, clipped to ±127); ``int8 @ wq`` with an exact
integer sum; ``× scale × w_scale (+ bias)`` in float32.  The output is
float32, as in the JAX package; callers cast it.

On the H100 the serving path's call is bound by the ``wq`` read from device
memory.  ``csrc/osparse_matmul.cu`` runs the chain on the route that
:func:`repro_torch.kernels.w8a8_matmul.gemm_plan` names: a decode
projection (T <= 16 tokens, static scale) is one launch that quantizes
inside the swap-AB GEMM; a prefill chunk is a vectorised quantize pass,
writing int8 ``xq`` and the per-row scales into scratch the wrapper
allocates, and the wgmma GEMM launched as its programmatic dependent.
``wq`` must be the ``(D, N)`` view of a K-major buffer
(``core.quant.k_major``).  The static ``act_scale`` is passed as a device
pointer: a launch never syncs the host.  The result is bit-identical to the
plain version.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``osparse_matmul.launches``
counts calls that launched, ``osparse_matmul.pruned_launches`` those with
``prune=True`` and ``osparse_matmul.route_launches`` them by route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import nm, quant, scoring
from repro_torch.kernels import _build
from repro_torch.kernels.w8a8_matmul import (ROUTES, _sms, check_int8_gemm, gemm_plan,
                                              route_code)

__all__ = ["osparse_matmul", "osparse_matmul_plain", "osparse_quantize",
           "osparse_quantize_plain"]

SOURCE = "src/repro_torch/kernels/csrc/osparse_matmul.cu"
REPLACES = "src/repro/kernels/osparse_matmul.py:142"
_MAX_M = 32       # the selection keeps a group's bits in one 32-bit word
_SYMBOLS = {torch.bfloat16: "osparse_matmul_bf16", torch.float32: "osparse_matmul_f32"}
_QUANT_SYMBOLS = {torch.bfloat16: "osparse_quantize_bf16",
                  torch.float32: "osparse_quantize_f32"}


def _fn(dtype: torch.dtype):
    lib = _build.load("osparse_matmul.cu")
    fn = getattr(lib, _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def osparse_quantize_plain(x: torch.Tensor, smooth: torch.Tensor,
                           amber: torch.Tensor | None, n: int, m: int,
                           act_scale: torch.Tensor | None = None, prune: bool = True,
                           per_token: bool = False):
    """The chain up to the int8 codes: ``(xq (T, D) int8, scale)`` with the
    per-token ``(T, 1)`` scales or the static ``act_scale``."""
    xs = x.float() / smooth
    if prune:
        xs = nm.apply_nm(xs, scoring.score_activations(xs, amber), n, m)
    if per_token:
        return quant.quantize_act_per_token(xs)
    return quant.quantize_act_per_tensor(xs, act_scale), act_scale


def osparse_matmul_plain(x: torch.Tensor, wq: torch.Tensor, smooth: torch.Tensor,
                         amber: torch.Tensor | None, w_scale: torch.Tensor, n: int,
                         m: int, act_scale: torch.Tensor | None = None,
                         bias: torch.Tensor | None = None, prune: bool = True,
                         per_token: bool = False) -> torch.Tensor:
    """Plain version: the ``core.quant`` chain, float32 out."""
    xq, scale = osparse_quantize_plain(x, smooth, amber, n, m, act_scale, prune, per_token)
    y = quant.quantized_matmul(xq, wq, scale, w_scale)
    return y if bias is None else y + bias.float()


def osparse_quantize(x: torch.Tensor, smooth: torch.Tensor, amber: torch.Tensor | None,
                     n: int, m: int, act_scale: torch.Tensor | None = None,
                     prune: bool = True, per_token: bool = False):
    """The quantize pass of the wgmma and swap routes alone, on a CUDA ``x (T,
    D)``: ``(xq, scale)`` as :func:`osparse_quantize_plain` gives them, so the
    int8 codes can be held against the plain version's.  Not a launch of
    ``osparse_matmul``."""
    _check(x, smooth, amber, n, m, act_scale, prune, per_token)
    t, d = x.shape
    xq = torch.empty((t, d), dtype=torch.int8, device=x.device)
    row_scale = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    if t == 0:
        return xq, row_scale if per_token else act_scale
    lib = _build.load("osparse_matmul.cu")
    fn = getattr(lib, _QUANT_SYMBOLS[x.dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), smooth.data_ptr(), None if amber is None else amber.data_ptr(),
                None if per_token else act_scale.data_ptr(), xq.data_ptr(),
                row_scale.data_ptr(), t, d, n, m, int(prune), int(per_token),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"osparse_quantize kernel launch failed (CUDA error {rc})")
    return xq, row_scale if per_token else act_scale


def _check(x, smooth, amber, n, m, act_scale, prune, per_token) -> None:
    """What the quantize pass takes: a contiguous (T, D) bf16/f32 CUDA x,
    (D,) float32 smooth/amber, a one-element float32 act_scale."""
    if act_scale is None and not per_token:
        raise ValueError("osparse_matmul: act_scale is required for per-tensor mode")
    if x.device.type != "cuda":
        raise ValueError(f"osparse_matmul: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in _SYMBOLS or not x.is_contiguous():
        raise ValueError("osparse_matmul: x must be a contiguous (T, D) bfloat16 or "
                         f"float32 tensor, got {tuple(x.shape)} {x.dtype}")
    d = x.shape[1]
    if prune and not (0 < n <= m <= _MAX_M and d % m == 0):
        raise ValueError(f"osparse_matmul: N:M {n}:{m} with D={d} (need "
                         f"0 < N <= M <= {_MAX_M} and D % M == 0)")
    for name, a in (("smooth", smooth), ("amber", amber)):
        if a is not None and (a.dtype != torch.float32 or a.shape != (d,)
                              or a.device != x.device or not a.is_contiguous()):
            raise ValueError(f"osparse_matmul: {name} must be contiguous float32 (D,) "
                             f"on {x.device}")
    if not per_token and (act_scale.numel() != 1 or act_scale.dtype != torch.float32
                          or act_scale.device != x.device or not act_scale.is_contiguous()):
        raise ValueError("osparse_matmul: act_scale must be one contiguous float32 on "
                         "x's device")


def osparse_matmul(x: torch.Tensor, wq: torch.Tensor, smooth: torch.Tensor,
                   amber: torch.Tensor | None, w_scale: torch.Tensor, n: int, m: int,
                   act_scale: torch.Tensor | None = None,
                   bias: torch.Tensor | None = None, prune: bool = True,
                   per_token: bool = False) -> torch.Tensor:
    """``x (T, D)`` through the Outstanding-sparse chain against ``wq (D, N)``
    int8 → ``(T, N)`` float32.

    ``smooth``/``amber`` are ``(D,)`` float32 (``amber`` may be None: plain
    ``|xs|`` scores), ``w_scale`` ``(N,)`` float32, ``act_scale`` a
    one-element float32 tensor (required unless ``per_token``), ``bias`` an
    optional ``(N,)`` epilogue add.  ``prune=False`` skips the selection
    (the decode-phase W8A8 GEMM).
    """
    if act_scale is None and not per_token:
        raise ValueError("osparse_matmul: act_scale is required for per-tensor mode")
    if x.device.type == "cpu":
        return osparse_matmul_plain(x, wq, smooth, amber, w_scale, n, m, act_scale,
                                    bias, prune, per_token)
    _check(x, smooth, amber, n, m, act_scale, prune, per_token)
    check_int8_gemm("osparse_matmul", x.shape, wq, w_scale, x.device)
    t, d = x.shape
    n_out = wq.shape[1]
    if bias is not None:
        if bias.shape != (n_out,) or bias.device != x.device:
            raise ValueError("osparse_matmul: bias must be (N_out,) on x's device")
        bias = bias.float().contiguous()      # added to the float32 result
    out = torch.empty((t, n_out), dtype=torch.float32, device=x.device)
    if t == 0:
        return out
    x_ptrs = x.data_ptr() | smooth.data_ptr() | (0 if amber is None else amber.data_ptr())
    plan = gemm_plan(t, d, n_out, x.dtype, per_token, prune, m, aligned=wq.data_ptr() % 16 == 0,
                     x_aligned=x_ptrs % 16 == 0, sms=_sms(x.device))
    fused = plan.route == "swap_fused"
    # scratch of the quantize pass (none on the fused route)
    xq = torch.empty((0 if fused else t, d), dtype=torch.int8, device=x.device)
    row_scale = torch.empty((t if per_token else 0,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn(x.dtype)(
            x.data_ptr(), wq.data_ptr(), smooth.data_ptr(),
            None if amber is None else amber.data_ptr(), w_scale.data_ptr(),
            None if per_token else act_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), xq.data_ptr(),
            row_scale.data_ptr(), out.data_ptr(), t, d, n_out, n, m, int(prune),
            int(per_token), route_code(plan), plan.splits, plan.cluster,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"osparse_matmul kernel launch failed on route {plan} "
                           f"(CUDA error {rc})")
    osparse_matmul.launches += 1
    osparse_matmul.pruned_launches += int(prune)
    osparse_matmul.route_launches[plan.route] += 1
    return out


osparse_matmul.launches = 0
osparse_matmul.pruned_launches = 0
osparse_matmul.route_launches = dict.fromkeys(ROUTES, 0)
