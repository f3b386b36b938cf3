"""Tile-consensus N:M compacted matmul: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/nm_spmm.py:nm_spmm_pallas`` (with
``_selection_onehot``).  Tokens are cut into consensus tiles of
``min(tile, T)`` rows (the last tile may be shorter, which equals the JAX
package's zero padding: a zero token adds nothing to the pool).  Per tile:
score ``|x|·scale`` in float32, L2-pool the scores over the tile's tokens,
keep the top N of every contiguous group of M channels (first occurrence
wins a tie), shared by the whole tile, and contract only the G·N kept
columns of x with the matching rows of ``w`` in float32; the output is in
x's dtype.  The tile is part of the function, never a free tiling choice:
it decides which tokens vote in each pool.

On the H100 the one-shot prefill's call (T = 2048 tokens against a
Qwen2-7B projection) is bound by the tensor cores;
``csrc/nm_spmm.cu`` says how its design answers that: a selection kernel
writes the kept channel ids per tile and the compacted activations once,
and a double-buffered tensor-core GEMM gathers the kept weight rows through
the tile's index list.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``nm_spmm.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import nm, scoring
from repro_torch.kernels import _build

__all__ = ["nm_spmm", "nm_spmm_plain", "consensus_select", "consensus_select_plain"]

SOURCE = "src/repro_torch/kernels/csrc/nm_spmm.cu"
REPLACES = "src/repro/kernels/nm_spmm.py:86"
_MAX_M = 32       # the selection keeps a group's bits in one 32-bit word
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _fn(name: str, dtype: torch.dtype, n_ptrs: int, n_ints: int):
    fn = getattr(_build.load("nm_spmm.cu"), f"{name}_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def consensus_select_plain(x: torch.Tensor, scale: torch.Tensor | None, n: int,
                           m: int, tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain selection: ``(idx (n_tiles, G·n) int32, xc (T, G·n))``, the kept
    channel ids of every tile of ``min(tile, T)`` tokens
    (``core.nm.tile_consensus_channels``) and the compacted activations."""
    t, d = x.shape
    bt = max(min(tile, t), 1)
    idx = torch.empty((-(-t // bt), d // m * n), dtype=torch.int32, device=x.device)
    xc = x.new_empty((t, d // m * n))
    for i, r0 in enumerate(range(0, t, bt)):
        xt = x[r0:r0 + bt]
        ch = nm.tile_consensus_channels(scoring.score_activations(xt, scale), n, m)
        idx[i] = ch.reshape(-1)
        xc[r0:r0 + bt] = nm.compact_columns(xt, ch)
    return idx, xc


def nm_spmm_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
                  n: int, m: int, tile: int = 256) -> torch.Tensor:
    """Plain version (``repro/kernels/ref.py:nm_spmm_ref``): per tile the
    consensus selection and a float32 product of the kept columns with the
    gathered weight rows.  The last tile is shorter where the reference
    zero-pads it: a zero token adds nothing to the pool."""
    bt = max(min(tile, x.shape[0]), 1)
    idx, xc = consensus_select_plain(x, scale, n, m, tile)
    y = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for i, ch in enumerate(idx):
        y[i * bt:(i + 1) * bt] = xc[i * bt:(i + 1) * bt].float() @ w.index_select(0, ch).float()
    return y.to(x.dtype)


def _check(what: str, x: torch.Tensor, scale, n: int, m: int, tile: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (T, D) bfloat16 or float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    d = x.shape[1]
    if not (0 < n <= m <= _MAX_M and d % m == 0):
        raise ValueError(f"{what}: N:M {n}:{m} with D={d} (need "
                         f"0 < N <= M <= {_MAX_M} and D % M == 0)")
    if tile < 1:
        raise ValueError(f"{what}: tile must be >= 1, got {tile}")
    if max(x.shape) >= 2**31:
        raise ValueError(f"{what}: dimension exceeds int32")
    if scale is not None and (scale.dtype != torch.float32 or scale.shape != (d,)
                              or scale.device != x.device or not scale.is_contiguous()):
        raise ValueError(f"{what}: scale must be contiguous float32 (D,) on {x.device}")


def _scratch(x: torch.Tensor, n: int, m: int, tile: int):
    t, d = x.shape
    bt = max(min(tile, t), 1)
    kc = d // m * n
    idx = torch.empty((-(-t // bt), kc), dtype=torch.int32, device=x.device)
    return bt, idx, torch.empty((t, kc), dtype=x.dtype, device=x.device)


def consensus_select(x: torch.Tensor, scale: torch.Tensor | None, n: int, m: int,
                     tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's selection pass alone (no GEMM, not counted as a launch):
    ``(idx, xc)`` as :func:`consensus_select_plain` gives them.  For checks."""
    if x.device.type == "cpu":
        return consensus_select_plain(x, scale, n, m, tile)
    _check("consensus_select", x, scale, n, m, tile)
    bt, idx, xc = _scratch(x, n, m, tile)
    if x.shape[0] == 0:
        return idx, xc
    with torch.cuda.device(x.device):
        rc = _fn("nm_spmm_select", x.dtype, 4, 5)(
            x.data_ptr(), None if scale is None else scale.data_ptr(), idx.data_ptr(),
            xc.data_ptr(), x.shape[0], x.shape[1], n, m, bt,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"consensus_select kernel launch failed (CUDA error {rc})")
    return idx, xc


def nm_spmm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None, n: int,
            m: int, tile: int = 256) -> torch.Tensor:
    """``x (T, D) @ w (D, N_out)`` over the tile-consensus N:M columns of x,
    in x's dtype.  ``scale`` is the ``(D,)`` float32 Amber channel scale or
    None (plain ``|x|``); ``tile`` the consensus tile in tokens."""
    if x.device.type == "cpu":
        return nm_spmm_plain(x, w, scale, n, m, tile)
    _check("nm_spmm", x, scale, n, m, tile)
    t, d = x.shape
    if (w.dim() != 2 or w.shape[0] != d or w.dtype != x.dtype or w.device != x.device
            or not w.is_contiguous()):
        raise ValueError(f"nm_spmm: w must be contiguous (D, N_out) {x.dtype} on "
                         f"{x.device}, got {tuple(w.shape)} {w.dtype}")
    n_out = w.shape[1]
    if n_out >= 2**31:
        raise ValueError("nm_spmm: dimension exceeds int32")
    out = torch.empty((t, n_out), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    bt, idx, xc = _scratch(x, n, m, tile)
    with torch.cuda.device(x.device):
        rc = _fn("nm_spmm", x.dtype, 6, 6)(
            x.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(),
            idx.data_ptr(), xc.data_ptr(), out.data_ptr(), t, d, n_out, n, m, bt,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nm_spmm kernel launch failed (CUDA error {rc})")
    nm_spmm.launches += 1
    return out


nm_spmm.launches = 0
