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
and a wgmma GEMM, fed by TMA for the compacted x and by a cp.async producer
that gathers the kept weight rows through the tile's index list, multiplies
them.  :func:`gemm_plan` picks the GEMM's route from the shapes: the wgmma
kernel (with its row block and k split), or, for a bf16 ``w`` the TMA and
16-byte copies cannot take, a WMMA kernel; float32 has a CUDA-core kernel.
Shape routes between hand kernels, not fallbacks.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``nm_spmm.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import nm, scoring
from repro_torch.kernels import _build, _meta

__all__ = ["gemm_plan", "fits_plan", "nm_spmm", "nm_spmm_plain", "consensus_select",
           "consensus_select_plain"]

SOURCE = "src/repro_torch/kernels/csrc/nm_spmm.cu"
REPLACES = "src/repro/kernels/nm_spmm.py:86"
_MAX_M = 32       # the selection keeps a group's bits in one 32-bit word
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_H100_SMS = 132


def _fn(name: str, dtype: torch.dtype, n_ptrs: int, n_ints: int):
    fn = getattr(_build.load("nm_spmm.cu"), f"{name}_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gemm_plan(dtype: torch.dtype, t: int, d: int, n_out: int, n: int, m: int, tile: int,
              w_aligned: bool, sms: int = _H100_SMS) -> tuple[str, int, int]:
    """The GEMM's route for ``x (t, d) @ w (d, n_out)`` under N:M ``n:m`` with
    consensus tiles of ``min(tile, t)`` tokens: ``(route, row block, k
    slices)``.

    * ``("f32", 64, 1)`` for float32 (the CUDA-core kernel);
    * ``("wmma", 64, 1)`` for a bf16 ``w`` that is not 16-byte aligned
      (``w_aligned``), or an ``n_out`` or kept width ``d/m*n`` that is not a
      multiple of 8: rows the TMA and 16-byte copies cannot take;
    * else ``("wgmma", bm, slices)``: row blocks of 256 (a whole consensus
      tile of up to 256 tokens) or 128 for tiles of at most 128 tokens; a
      grid of blocks that fills under half of the ``sms`` SMs splits k (at
      least 8 k steps of 64 a slice, at most 8 slices) into float32
      partials that an ordered reduce sums.
    """
    if dtype == torch.float32:
        return "f32", 64, 1
    kc = d // m * n
    if not w_aligned or n_out % 8 or kc % 8:
        return "wmma", 64, 1
    bt = max(min(tile, t), 1)
    bm = 128 if bt <= 128 else 256
    blocks = -(-t // bt) * -(-bt // bm) * -(-n_out // 128)
    k_steps = -(-kc // 64)
    if 2 * blocks > sms:
        return "wgmma", bm, 1
    splits = max(1, min(sms // blocks, k_steps // 8, 8))
    per = -(-k_steps // splits)
    return "wgmma", bm, -(-k_steps // per)          # no empty slice


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


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    _build.refuse_grad("consensus_select", x, scale)
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


def fits_plan(plan: tuple[str, int, int], w: torch.Tensor, n: int, m: int) -> bool:
    """Whether a call with weight ``w`` can take ``plan`` (a :func:`gemm_plan`
    result for the same x): the wgmma route needs a 16-byte aligned ``w``
    and N_out and the kept width multiples of 8; the others take any."""
    return plan[0] != "wgmma" or (w.data_ptr() % 16 == 0 and w.shape[1] % 8 == 0
                                  and (w.shape[0] // m * n) % 8 == 0)


def nm_spmm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None, n: int,
            m: int, tile: int = 256, plan: tuple[str, int, int] | None = None) -> torch.Tensor:
    """``x (T, D) @ w (D, N_out)`` over the tile-consensus N:M columns of x,
    in x's dtype.  ``scale`` is the ``(D,)`` float32 Amber channel scale or
    None (plain ``|x|``); ``tile`` the consensus tile in tokens.  ``plan``: the
    GEMM's :func:`gemm_plan` to take instead of this call's own (a column
    shard takes the unsharded call's: its k split sets the order of the
    float32 sums); the CPU has none."""
    if x.device.type == "cpu":
        return nm_spmm_plain(x, w, scale, n, m, tile)
    if x.device.type == "meta":
        return _meta.nm_spmm(x, w, scale, n, m)
    _build.refuse_grad("nm_spmm", x, w, scale)
    _check("nm_spmm", x, scale, n, m, tile)
    t, d = x.shape
    if (w.dim() != 2 or w.shape[0] != d or w.dtype != x.dtype or w.device != x.device
            or not w.is_contiguous()):
        raise ValueError(f"nm_spmm: w must be contiguous (D, N_out) {x.dtype} on "
                         f"{x.device}, got {tuple(w.shape)} {w.dtype}")
    n_out = w.shape[1]
    if n_out >= 2**31:
        raise ValueError("nm_spmm: dimension exceeds int32")
    if t == 0:
        return torch.empty((0, n_out), dtype=x.dtype, device=x.device)
    if plan is None:
        plan = gemm_plan(x.dtype, t, d, n_out, n, m, tile, w.data_ptr() % 16 == 0,
                         _sms(x.device))
    elif (plan[0] == "f32") != (x.dtype == torch.float32) or not fits_plan(plan, w, n, m):
        raise ValueError(f"nm_spmm: plan {plan} does not fit {x.dtype} w {tuple(w.shape)}")
    out = _launch(x, w, scale, n, m, tile, plan)
    nm_spmm.launches += 1
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None, n: int, m: int,
            tile: int, plan: tuple[str, int, int]) -> torch.Tensor:
    """The kernels of one checked call with T > 0, the bf16 GEMM on ``plan``
    (a :func:`gemm_plan` result; any wgmma row block and k split are valid)."""
    t, d = x.shape
    n_out = w.shape[1]
    out = torch.empty((t, n_out), dtype=x.dtype, device=x.device)
    bt, idx, xc = _scratch(x, n, m, tile)
    ptrs = [x.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(),
            idx.data_ptr(), xc.data_ptr(), out.data_ptr()]
    ints = [t, d, n_out, n, m, bt]
    if x.dtype == torch.bfloat16:
        route, bm, slices = plan
        part = (torch.empty((slices, t, n_out), dtype=torch.float32, device=x.device)
                if slices > 1 else None)
        ptrs.append(None if part is None else part.data_ptr())
        ints += [bm if route == "wgmma" else 0, slices]
    with torch.cuda.device(x.device):
        rc = _fn("nm_spmm", x.dtype, len(ptrs), len(ints))(
            *ptrs, *ints, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nm_spmm kernel launch failed (CUDA error {rc})")
    return out


nm_spmm.launches = 0
