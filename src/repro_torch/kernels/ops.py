"""Dispatch layer between the model and the kernels (port of
``repro/kernels/ops.py``).

Flattens the leading axes of a projection input into the kernel's token
axis.  The CUDA kernels mask their own ragged edges, so no ``_block_and_pad``
padding is needed; ``nm_spmm``, ``osparse_matmul``, ``w8a8_matmul`` and
``nm_prune`` are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import nm_prune_matmul as _npm

__all__ = ["nm_prune_matmul"]


def nm_prune_matmul(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor | None, n: int, m: int,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Fused per-token prune + GEMM over any ``(..., D)`` input."""
    lead = x.shape[:-1]
    y = _npm.nm_prune_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w,
                             scale, n, m, bias=bias)
    return y.reshape(*lead, w.shape[-1])
