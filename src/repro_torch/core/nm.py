"""N:M structured sparsity primitives (port of ``repro/core/nm.py``).

An N:M pattern keeps the N largest-scoring elements inside every contiguous
group of M elements along the input-channel (last) axis.  Scores are
compared in float32 whatever the activation dtype.
"""
from __future__ import annotations

import torch

__all__ = ["nm_group_view", "nm_topk_mask", "apply_nm"]


def nm_group_view(x: torch.Tensor, m: int) -> torch.Tensor:
    """Reshape ``(..., D)`` to ``(..., D // m, m)`` groups of M channels."""
    d = x.shape[-1]
    if d % m != 0:
        raise ValueError(f"last dim {d} not divisible by group size {m}")
    return x.reshape(*x.shape[:-1], d // m, m)


def nm_topk_mask(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Boolean keep-mask with exactly N True per contiguous group of M.

    N rounds of first-occurrence argmax: each round keeps the largest
    remaining score of every group, the lowest channel index winning a tie
    (``torch.argmax`` returns the first maximum, as ``lax.top_k`` and the
    JAX package's cumsum construction do), then retires it with -inf.
    """
    if not (0 < n <= m):
        raise ValueError(f"invalid N:M pattern {n}:{m}")
    if n == m:
        return torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    remaining = nm_group_view(scores.float(), m).clone()
    keep = torch.zeros(remaining.shape, dtype=torch.bool, device=scores.device)
    for _ in range(n):
        first = torch.argmax(remaining, dim=-1, keepdim=True)
        keep.scatter_(-1, first, True)
        remaining.scatter_(-1, first, float("-inf"))
    return keep.reshape(scores.shape)


def apply_nm(x: torch.Tensor, scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Zero out everything but the per-group top-N scored entries of ``x``."""
    mask = nm_topk_mask(scores, n, m)
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
