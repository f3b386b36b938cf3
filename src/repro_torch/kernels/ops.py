"""Dispatch layer between the model and the kernels (port of
``repro/kernels/ops.py``).

Flattens the leading axes of an input into the kernel's token axis and
keeps the JAX package's signatures.  The CUDA kernels mask their own ragged
edges, so no ``_block_and_pad`` padding is needed.

Tensor parallelism (``distributed/tp.py``): under an active TP scope the
four projections re-enter themselves column-parallel, as the reference's
do: each rank runs the same wrapper on its N_out slice and the gathered
result is bit-identical to the unsharded call.  On the card each shard
takes the unsharded call's plan (its k split decides the order of the
float32 sums); a shard whose route would differ falls through to the
unsharded call, as an N_out that does not divide does.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tp as _tp
from repro_torch.kernels import nm_prune as _np
from repro_torch.kernels import nm_prune_matmul as _npm
from repro_torch.kernels import nm_spmm as _nms
from repro_torch.kernels import osparse_matmul as _osp
from repro_torch.kernels import w8a8_matmul as _w8

__all__ = ["nm_prune", "nm_prune_matmul", "nm_spmm", "osparse_matmul", "w8a8_matmul"]


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def nm_prune(x: torch.Tensor, scale: torch.Tensor | None, n: int, m: int) -> torch.Tensor:
    """Fused Amber prune over any ``(..., D)`` tensor."""
    return _np.nm_prune(_flat(x), scale, n, m).reshape(x.shape)


def nm_prune_matmul(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor | None, n: int, m: int,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Fused per-token prune + GEMM over any ``(..., D)`` input."""
    xf = _flat(x)
    y = None
    if _tp.current() is not None:
        # the bf16 GEMM has a plan; float32 and the CPU have none
        plan = (_npm.gemm_plan(w, xf.shape[0], _tp.full_cols(w))
                if xf.is_cuda and xf.dtype == torch.bfloat16 else None)
        y = _tp.column_parallel(
            lambda w_, b_: _npm.nm_prune_matmul(xf, w_, scale, n, m, bias=b_, plan=plan),
            (w, bias), fits=lambda w_, b_: not plan or _npm.takes_wgmma(w_))
    if y is None:
        y = _npm.nm_prune_matmul(xf, w, scale, n, m, bias=bias)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def nm_spmm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
            n: int, m: int, tile: int = 256) -> torch.Tensor:
    """Tile-consensus compacted matmul over any ``(..., D)`` input, in x's
    dtype.  All leading axes form one token axis, so a consensus tile may
    span batch rows; the tile is ``min(tile, tokens)`` and is part of the
    function (it decides which tokens vote in each pool)."""
    xf = _flat(x)
    y = None
    if _tp.current() is not None:
        # the consensus vote runs over the full activations on every rank, so
        # sharding N_out cannot change which channels win
        plan = None
        if xf.is_cuda:
            plan = _nms.gemm_plan(xf.dtype, xf.shape[0], xf.shape[1], _tp.full_cols(w), n, m,
                                  tile, w.data_ptr() % 16 == 0, _nms._sms(xf.device))
        y = _tp.column_parallel(
            lambda w_: _nms.nm_spmm(xf, w_, scale, n, m, tile, plan=plan), (w,),
            fits=lambda w_: plan is None or _nms.fits_plan(plan, w_, n, m))
    if y is None:
        y = _nms.nm_spmm(xf, w, scale, n, m, tile)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def osparse_matmul(x: torch.Tensor, wq: torch.Tensor, smooth: torch.Tensor,
                   amber: torch.Tensor | None, w_scale: torch.Tensor, n: int, m: int,
                   act_scale: torch.Tensor | None = None,
                   bias: torch.Tensor | None = None, prune: bool = True,
                   per_token: bool = False) -> torch.Tensor:
    """Fused Outstanding-sparse projection over any ``(..., D)`` input.

    Returns float32 (dequantized); callers cast back to the model dtype.
    ``bias`` is folded into the dequant epilogue; ``prune=False`` skips the
    N:M selection, turning the same kernel into the decode-phase smoothed
    W8A8 GEMM.
    """
    xf = _flat(x)
    y = None
    if _tp.current() is not None:
        # wq, w_scale and bias are N_out-aligned and shard; smooth, amber and
        # act_scale are K- or token-aligned and replicate
        def own(wq_):
            return _osp.call_plan(xf, wq_, smooth, amber, m, prune, per_token)

        plan = own(wq) if xf.is_cuda else None
        y = _tp.column_parallel(
            lambda wq_, ws_, b_: _osp.osparse_matmul(
                xf, wq_, smooth, amber, ws_, n, m, act_scale=act_scale, bias=b_, prune=prune,
                per_token=per_token, plan=plan),
            (wq, w_scale, bias), fits=lambda wq_, ws_, b_: plan is None
            or own(wq_).route == plan.route)
    if y is None:
        y = _osp.osparse_matmul(xf, wq, smooth, amber, w_scale, n, m, act_scale=act_scale,
                                bias=bias, prune=prune, per_token=per_token)
    return y.reshape(*x.shape[:-1], wq.shape[-1])


def w8a8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """int8 ``(..., D) @ wq (D, N)`` → float32 ``* x_scale * w_scale``."""
    xf = _flat(xq)
    y = None
    if _tp.current() is not None:
        plan = _w8.call_plan(xf, wq) if xf.is_cuda else None
        y = _tp.column_parallel(
            lambda wq_, ws_: _w8.w8a8_matmul(xf, wq_, x_scale, ws_, plan=plan), (wq, w_scale),
            fits=lambda wq_, ws_: plan is None or _w8.call_plan(xf, wq_).route == plan.route)
    if y is None:
        y = _w8.w8a8_matmul(xf, wq, x_scale, w_scale)
    return y.reshape(*xq.shape[:-1], wq.shape[-1])
