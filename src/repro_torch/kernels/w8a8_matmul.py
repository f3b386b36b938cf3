"""W8A8 int8 GEMM with per-channel dequant: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/w8a8_matmul.py:w8a8_matmul_pallas``:
``out = float(xq @ wq) * x_scale * w_scale[col]`` with an exact int32
accumulator, float32 out.  The kernel is the GEMM half of
``csrc/osparse_matmul.cu`` (WMMA ``signed char`` tensor-core tiles,
cp.async double buffering, ``wq`` read in its ``(D, N)`` layout); the scalar
``x_scale`` is read on the device, so a launch never syncs the host.  Its
bound on the H100 is the ``wq`` read from device memory at serving shapes.
Where the output tiles cannot fill the card, the k loop is split over
blocks whose int32 partial sums meet with atomics (:func:`gemm_splits`);
integer sums commute, so the result is bit-identical either way.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``w8a8_matmul.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build

__all__ = ["w8a8_matmul", "w8a8_matmul_plain", "gemm_splits", "check_int8_gemm"]

SOURCE = "src/repro_torch/kernels/csrc/osparse_matmul.cu"
REPLACES = "src/repro/kernels/w8a8_matmul.py:49"
_BM, _BN, _BK = 64, 128, 64       # the GEMM kernel's block tile


def gemm_splits(t: int, d: int, n_out: int, sms: int) -> int:
    """How many blocks share one output tile's k loop: enough for about two
    blocks per SM when the tiles alone cannot fill the card, at least four
    k tiles per block."""
    tiles = -(-t // _BM) * -(-n_out // _BN)
    if tiles >= sms:
        return 1
    return max(1, min(-(-2 * sms // tiles), -(-d // _BK) // 4))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_int8_gemm(name: str, xq_shape, wq: torch.Tensor, w_scale: torch.Tensor,
                    device: torch.device) -> None:
    """Shape, dtype, device and layout checks shared by the int8 GEMMs."""
    d = xq_shape[1]
    if wq.dim() != 2 or wq.shape[0] != d:
        raise ValueError(f"{name}: shapes {tuple(xq_shape)} @ {tuple(wq.shape)}")
    n_out = wq.shape[1]
    if wq.dtype != torch.int8:
        raise TypeError(f"{name}: wq must be int8, got {wq.dtype}")
    if w_scale.dtype != torch.float32 or w_scale.shape != (n_out,):
        raise ValueError(f"{name}: w_scale must be float32 of shape ({n_out},)")
    for nm_, a in (("wq", wq), ("w_scale", w_scale)):
        if a.device != device or not a.is_contiguous():
            raise ValueError(f"{name}: {nm_} must be contiguous on {device}")
    if max(xq_shape[0], d, n_out) >= 2**31 or xq_shape[0] * n_out >= 2**31:
        raise ValueError(f"{name}: dimension exceeds int32")


def _fn():
    lib = _build.load("osparse_matmul.cu")
    fn = lib.w8a8_matmul
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def w8a8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version: the exact integer product, dequantized
    (``quant.quantized_matmul``)."""
    return quant.quantized_matmul(xq, wq, x_scale, w_scale)


def w8a8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """``xq (T, D) int8 @ wq (D, N) int8`` → float32 ``* x_scale * w_scale``;
    ``x_scale`` is a one-element float32 tensor, ``w_scale`` ``(N,)``."""
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, wq, x_scale, w_scale)
    if xq.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {xq.device}")
    if xq.dim() != 2 or xq.dtype != torch.int8 or not xq.is_contiguous():
        raise ValueError("w8a8_matmul: xq must be a contiguous (T, D) int8 tensor")
    check_int8_gemm("w8a8_matmul", xq.shape, wq, w_scale, xq.device)
    if (x_scale.numel() != 1 or x_scale.dtype != torch.float32
            or x_scale.device != xq.device):
        raise ValueError("w8a8_matmul: x_scale must be one float32 on xq's device")
    t, d = xq.shape
    n_out = wq.shape[1]
    out = torch.empty((t, n_out), dtype=torch.float32, device=xq.device)
    if t == 0:
        return out
    splits = gemm_splits(t, d, n_out, _sms(xq.device))
    partial = (torch.empty((t, n_out), dtype=torch.int32, device=xq.device)
               if splits > 1 else None)
    x_scale = x_scale.contiguous()
    with torch.cuda.device(xq.device):
        rc = _fn()(xq.data_ptr(), wq.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
                   None if partial is None else partial.data_ptr(), out.data_ptr(),
                   t, d, n_out, splits, torch.cuda.current_stream(xq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w8a8_matmul kernel launch failed (CUDA error {rc})")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
