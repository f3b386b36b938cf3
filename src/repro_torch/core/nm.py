"""N:M structured sparsity primitives (port of ``repro/core/nm.py``).

An N:M pattern keeps the N largest-scoring elements inside every contiguous
group of M elements along the input-channel (last) axis.  Scores are
compared in float32 whatever the activation dtype.

Tile-consensus mode (:func:`tile_consensus_channels`,
:func:`compact_columns`) picks one shared channel set per token tile from
the tile's L2-pooled scores and gathers the kept columns.
"""
from __future__ import annotations

import torch

__all__ = ["nm_group_view", "nm_topk_mask", "apply_nm", "validate_nm",
           "tile_consensus_channels", "compact_columns"]


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


def validate_nm(mask: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """True iff every group of M has at most N kept entries (bool scalar)."""
    return (nm_group_view(mask.to(torch.int32), m).sum(-1) <= n).all()


def tile_consensus_channels(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """One shared N:M channel set for a whole token tile.

    Pools the scores over every leading axis with an L2 norm and returns the
    kept *absolute* channel ids, ``(G, n)``, ascending inside each group.
    The top N of a group are picked by :func:`nm_topk_mask`'s iterative
    first-occurrence argmax, so a tie goes to the lower channel, as
    ``lax.top_k`` does in the JAX package.

    The sum of squares is accumulated in float64 and rounded once to
    float32 before the float32 square root: a square of a float32 is exact
    in float64, and a sum of 256 such squares in another order differs only
    in the float64's last bits, which the round to float32 almost always
    removes.  So the CUDA kernel (``csrc/nm_spmm.cu``), which sums in
    another order, picks the same channels as this function on the same
    scores, except with negligible probability.
    """
    d = scores.shape[-1]
    s = scores.reshape(-1, d).float().double()
    pooled = (s * s).sum(dim=0).float().sqrt()                      # (D,)
    keep = nm_group_view(nm_topk_mask(pooled, n, m), m)            # (G, m)
    # the kept channels first, in ascending order (a stable sort: no count
    # is read back to the host, so a CUDA graph can capture it)
    first = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[:, :n]
    return first + torch.arange(0, d, m, device=scores.device)[:, None]


def compact_columns(x: torch.Tensor, channels: torch.Tensor) -> torch.Tensor:
    """Gather the kept channels: ``(..., D) -> (..., G*n)``."""
    return x.index_select(-1, channels.reshape(-1))
