"""Amber Pruner: the functional pruning path + offline scale precomputation
(port of ``repro/core/pruner.py``).

``sparse_matmul`` is what every pruned projection calls.  Per-token mode:
under ``policy.use_kernels`` it is one ``nm_prune_matmul`` kernel launch
(score, N:M select, mask and GEMM fused); otherwise the plain path masks
the input and multiplies.  Tile-consensus mode: under ``policy.use_kernels``
one ``nm_spmm`` launch; otherwise the plain compaction path
(``kernels.nm_spmm.nm_spmm_plain``).  Either way all leading axes form one
token axis cut into tiles of ``min(policy.tile_size, tokens)``, so a tile
may span batch rows, as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import nm, scoring
from repro_torch.core.policy import SparsityPolicy

__all__ = ["prune_input", "sparse_matmul", "precompute_scales", "SCALE_KEY"]

SCALE_KEY = "amber_scale"  # attribute name of the channel scale on a Linear


def prune_input(x: torch.Tensor, scale: torch.Tensor | None,
                policy: SparsityPolicy) -> torch.Tensor:
    """Per-token N:M sparsity of a projection input ``(..., d_in)``."""
    scores = scoring.score_activations(x, scale)
    return nm.apply_nm(x, scores, policy.n, policy.m)


def sparse_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
                  policy: SparsityPolicy,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """N:M-sparsified ``x @ w`` (+ ``bias``) under the policy's mode.

    In tile-consensus mode the bias is added after the product, in x's
    dtype, as the JAX package does (``repro/core/pruner.py:90-93``)."""
    if policy.tile_consensus:
        from repro_torch.kernels import nm_spmm, ops

        if policy.use_kernels:
            y = ops.nm_spmm(x, w, scale, policy.n, policy.m, tile=policy.tile_size)
        else:
            y = nm_spmm.nm_spmm_plain(x.reshape(-1, x.shape[-1]), w, scale, policy.n,
                                      policy.m, policy.tile_size)
            y = y.reshape(*x.shape[:-1], w.shape[-1])
        return y if bias is None else y + bias
    if policy.use_kernels:
        from repro_torch.kernels import ops

        return ops.nm_prune_matmul(x, w, scale, policy.n, policy.m, bias=bias)
    y = prune_input(x, scale, policy) @ w
    return y if bias is None else y + bias


@torch.no_grad()
def precompute_scales(params: nn.Module, policy: SparsityPolicy) -> nn.Module:
    """Offline pass: attach Amber channel scales to every prunable linear.

    Walks the module tree; every projection ``Linear`` whose attribute name
    is prunable under the policy (layer-independent, as the JAX walk over
    the stacked pytree is) gets an ``amber_scale`` tensor.  The LM head is
    not a projection and never reads a scale, so it gets none.  Only float
    ``Linear``s are visited (the JAX walk visits dicts with ``w``): a
    ``QuantLinear`` keeps the scale computed from its float weight before
    the rewrite.  Updates ``params`` in place and returns it.
    """
    from repro_torch.core.policy import ALL_PROJS
    from repro_torch.layers.linear import Linear

    if policy.score_mode == "naive" or not policy.enabled:
        return params
    for name, mod in params.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if (isinstance(mod, Linear) and leaf in ALL_PROJS
                and policy.should_prune(leaf)):
            mod.amber_scale = scoring.precompute_scale(mod.w, policy.score_mode)
    return params
