"""W8A8 int8 GEMM with per-channel dequant: the CUDA kernel's wrapper, its
plain PyTorch version, and the route plan that the int8 GEMMs share.

Replaces the TPU kernel ``repro/kernels/w8a8_matmul.py:w8a8_matmul_pallas``:
``out = float(xq @ wq) * x_scale * w_scale[col]`` with an exact int32
accumulator, float32 out.  ``wq`` is the ``(D, N)`` transposed view of a
K-major ``(N, D)`` int8 buffer (``core.quant.k_major``): 8-bit wgmma takes
K-major operands only, so on a GPU the wrappers raise on any other layout
instead of transposing the weights at every call.  Its bound on the H100 is
the ``wq`` read from device memory at serving shapes.

:func:`gemm_plan` picks the kernel of ``csrc/osparse_matmul.cu`` from the
shapes (a shape route between hand kernels, never a fallback):

* ``"wgmma"`` (T > 16): 256 x 128 output tiles on m64n128k32 wgmmas fed by
  a TMA ring; where the column slabs cannot fill half the card, k is split
  over a thread-block cluster that sums its int32 partials in shared memory
  (exact in any order: the result stays bit-identical);
* ``"swap_fused"`` (T <= 16, a float x and the static scale): swap AB, 64
  weight rows against the tokens, with the quantize chain in the same
  launch (``osparse_matmul`` only);
* ``"swap"`` (T <= 16 with int8 xq, or per-token scales): the swap-AB GEMM
  after a quantize pass;
* ``"simple"``: D not a multiple of 16 or ``wq`` not 16-byte aligned, shapes
  TMA cannot take: a dp4a kernel.

The scalar ``x_scale`` is read on the device, so a launch never syncs the
host.  The wrapper runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``w8a8_matmul.launches``
counts kernel launches and ``w8a8_matmul.route_launches`` them by route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build

__all__ = ["w8a8_matmul", "w8a8_matmul_plain", "gemm_plan", "GemmPlan", "ROUTES",
           "check_int8_gemm", "route_code"]

SOURCE = "src/repro_torch/kernels/csrc/osparse_matmul.cu"
REPLACES = "src/repro/kernels/w8a8_matmul.py:49"
ROUTES = ("wgmma", "swap_fused", "swap", "simple")
_CODES = {"simple": 0, "wgmma": 1, "swap": 2, "swap_fused": 3}   # csrc enum Route
_H100_SMS = 132
_DECODE_T = 16            # most tokens of the swap route (the wgmma's N <= 16)
_K = 128                  # bytes of k per ring stage (one 128-byte swizzle row)
_PREFILL = (256, 128)     # wgmma route: output rows, columns of a block
_SWAP_ROWS = 64           # swap route: weight rows of a block
_MAX_CLUSTER = 8          # portable cluster size
_SWAP_X_BYTES = 64 << 10  # most bytes of the swap route's token tile per block
_FUSED_WIDTHS = (2, 4, 8, 16)   # N:M group widths the fused quantizer takes


class GemmPlan(NamedTuple):
    """Route, the output block ``(rows, columns)``, the k split and the
    cluster size: the split's blocks, and on the swap routes times the
    consecutive row tiles whose blocks share out the token tile's fill."""
    route: str
    block: tuple
    splits: int
    cluster: int


def _split(blocks: int, k_steps: int, slots: int) -> int:
    """The largest power-of-two k split, at most the cluster limit, that
    keeps the blocks within ``slots``, with at least two k steps a block (1
    where no split fits)."""
    s = 1
    while 2 * s <= _MAX_CLUSTER and blocks * 2 * s <= slots and k_steps >= 4 * s:
        s *= 2
    return s


def gemm_plan(t: int, d: int, n_out: int, x_dtype: torch.dtype, per_token: bool = False,
              prune: bool = False, m: int = 16, aligned: bool = True,
              x_aligned: bool = True, sms: int = _H100_SMS) -> GemmPlan:
    """The int8 GEMM's route for ``(t, d) @ (d, n_out)``: ``x_dtype`` is
    ``torch.int8`` for :func:`w8a8_matmul` (xq given) or the float dtype of
    ``osparse_matmul``'s x; ``per_token``/``prune``/``m`` are its quantizer's;
    ``aligned`` says that ``wq`` (and a given xq) start on 16 bytes,
    ``x_aligned`` the same of a float x and its smooth and amber vectors.

    * ``simple``, block (32, 64): ``d % 16`` or not ``aligned``, or a swap
      tile that no cluster split fits in shared memory;
    * ``wgmma``, block (256, 128), for ``t > 16``: k split over the largest
      power-of-two cluster (at most 8, at least two 128-deep k steps a
      block) that keeps the blocks within half the ``sms`` SMs (gate's 112
      column slabs at T = 256 stay unsplit, q's 32 split 2, k's 8 split 8):
      each split adds a reduce of the 256 x 128 int32 tile through the
      cluster's shared memory, which cost more than the SMs it filled
      (``chip_smoke.py`` phase 2d);
    * ``swap_fused`` / ``swap``, block (64, 8 or 16 tokens), for ``t <= 16``:
      fused for an aligned float x under the static scale (and a group width
      of 2-16 when pruning), else after a quantize pass; k split as above
      within all ``sms`` SMs (gate unsplit, q split 2, k split 8), and at
      least far enough that the token tile (tokens x k slice bytes) fits 64
      KB.  The cluster takes as many row tiles as fit 8 blocks with the
      split (gate 8, q 4, k 1): their blocks need the same token tile, and
      each quantizes its share of it once for all of them.
    """
    if not aligned or d % 16:
        return GemmPlan("simple", (32, 64), 1, 1)
    k_steps = -(-d // _K)
    if t > _DECODE_T:
        bm, bn = _PREFILL
        splits = _split(-(-t // bm) * -(-n_out // bn), k_steps, sms // 2)
        return GemmPlan("wgmma", _PREFILL, splits, splits)
    nt = 8 if t <= 8 else 16
    splits = _split(-(-n_out // _SWAP_ROWS), k_steps, sms)
    while nt * -(-k_steps // splits) * _K > _SWAP_X_BYTES:
        splits *= 2
    if splits > _MAX_CLUSTER:
        return GemmPlan("simple", (32, 64), 1, 1)
    fused = (x_dtype != torch.int8 and x_aligned and not per_token
             and (not prune or m in _FUSED_WIDTHS))
    share = 1
    while 2 * share * splits <= _MAX_CLUSTER and 2 * share <= -(-n_out // _SWAP_ROWS):
        share *= 2
    return GemmPlan("swap_fused" if fused else "swap", (_SWAP_ROWS, nt), splits,
                    splits * share)


def route_code(plan: GemmPlan) -> int:
    """The route's code in ``csrc/osparse_matmul.cu``."""
    return _CODES[plan.route]


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_int8_gemm(name: str, xq_shape, wq: torch.Tensor, w_scale: torch.Tensor,
                    device: torch.device) -> None:
    """Shape, dtype, device and layout checks shared by the int8 GEMMs: ``wq``
    must be the ``(D, N)`` view of a K-major ``(N, D)`` buffer."""
    d = xq_shape[1]
    if wq.dim() != 2 or wq.shape[0] != d:
        raise ValueError(f"{name}: shapes {tuple(xq_shape)} @ {tuple(wq.shape)}")
    n_out = wq.shape[1]
    if wq.dtype != torch.int8:
        raise TypeError(f"{name}: wq must be int8, got {wq.dtype}")
    if w_scale.dtype != torch.float32 or w_scale.shape != (n_out,):
        raise ValueError(f"{name}: w_scale must be float32 of shape ({n_out},)")
    if wq.device != device or not wq.t().is_contiguous():
        raise ValueError(f"{name}: wq must be the (D, N) view of a K-major (N, D) buffer "
                         f"on {device} (core.quant.k_major), got strides {wq.stride()}")
    if w_scale.device != device or not w_scale.is_contiguous():
        raise ValueError(f"{name}: w_scale must be contiguous on {device}")
    if max(xq_shape[0], d, n_out) >= 2**31 or xq_shape[0] * n_out >= 2**31:
        raise ValueError(f"{name}: dimension exceeds int32")


def _fn():
    lib = _build.load("osparse_matmul.cu")
    fn = lib.w8a8_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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
    plan = gemm_plan(t, d, n_out, torch.int8,
                     aligned=(xq.data_ptr() | wq.data_ptr()) % 16 == 0, sms=_sms(xq.device))
    x_scale = x_scale.contiguous()
    with torch.cuda.device(xq.device):
        rc = _fn()(xq.data_ptr(), wq.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
                   out.data_ptr(), t, d, n_out, route_code(plan), plan.splits, plan.cluster,
                   torch.cuda.current_stream(xq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w8a8_matmul kernel launch failed on route {plan} "
                           f"(CUDA error {rc})")
    w8a8_matmul.launches += 1
    w8a8_matmul.route_launches[plan.route] += 1
    return out


w8a8_matmul.launches = 0
w8a8_matmul.route_launches = dict.fromkeys(ROUTES, 0)
