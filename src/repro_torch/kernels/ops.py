"""Dispatch layer between the model and the kernels (port of
``repro/kernels/ops.py``).

Flattens the leading axes of an input into the kernel's token axis and
keeps the JAX package's signatures.  The CUDA kernels mask their own ragged
edges, so no ``_block_and_pad`` padding is needed.
"""
from __future__ import annotations

import torch

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
    y = _npm.nm_prune_matmul(_flat(x), w, scale, n, m, bias=bias)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def nm_spmm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
            n: int, m: int, tile: int = 256) -> torch.Tensor:
    """Tile-consensus compacted matmul over any ``(..., D)`` input, in x's
    dtype.  All leading axes form one token axis, so a consensus tile may
    span batch rows; the tile is ``min(tile, tokens)`` and is part of the
    function (it decides which tokens vote in each pool)."""
    y = _nms.nm_spmm(_flat(x), w, scale, n, m, tile)
    return y.reshape(*x.shape[:-1], w.shape[-1])


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
    y = _osp.osparse_matmul(_flat(x), wq, smooth, amber, w_scale, n, m,
                            act_scale=act_scale, bias=bias, prune=prune,
                            per_token=per_token)
    return y.reshape(*x.shape[:-1], wq.shape[-1])


def w8a8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """int8 ``(..., D) @ wq (D, N)`` → float32 ``* x_scale * w_scale``."""
    y = _w8.w8a8_matmul(_flat(xq), wq, x_scale, w_scale)
    return y.reshape(*xq.shape[:-1], wq.shape[-1])
