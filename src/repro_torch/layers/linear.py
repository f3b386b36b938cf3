"""Linear projections honoring the Amber Pruner policy (port of
``repro/layers/linear.py``).

``Linear`` keeps its weight in the JAX package's ``(d_in, d_out)`` layout,
which is what the kernels take, so nothing is transposed.  Layers are a
Python loop in the port, so ``sparse_linear`` always knows the static layer
index and consults the policy's skip list directly; there is no traced
``layer_flag``.

Dispatch, as in the JAX package: a quantized projection (``QuantLinear``,
which holds ``wq`` and no float weight) takes the Outstanding-sparse / W8A8
rung in both phases, pruned where the policy prunes — one
``osparse_matmul`` launch under ``use_kernels``, else the ``core.quant``
chain; a pruned float projection goes through ``core.pruner.
sparse_matmul`` (under ``use_kernels`` one ``nm_prune_matmul`` launch, or
in tile-consensus mode one ``nm_spmm`` launch — the static layer index
replaces the JAX scan's ``jnp.where(layer_flag, y, dense)``, which
computes the same function); every other projection is ``x @ w (+ b)``
through ``torch.matmul``, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core import pruner, quant
from repro_torch.core.policy import SparsityPolicy

__all__ = ["Linear", "QuantLinear", "init_linear", "dense_linear", "sparse_linear"]


class Linear(nn.Module):
    """``w (d_in, d_out)``, optional bias ``b (d_out,)`` and the optional
    ``amber_scale (d_in,)`` float32 channel scale (``precompute_scales``)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype, device=device),
                              requires_grad=False)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                               requires_grad=False) if bias else None)
        self.register_buffer("amber_scale", None)


class QuantLinear(nn.Module):
    """A projection after the offline SmoothQuant / Outstanding rewrite: int8
    ``wq (d_in, d_out)`` (the transposed view of one K-major ``(d_out, d_in)``
    buffer, ``quant.k_major``: the layout of the int8 kernels, with the JAX
    package's shape), float32 ``w_scale (d_out,)``, ``smooth (d_in,)``
    and the 0-d static ``act_scale``, the optional ``amber_scale (d_in,)``
    (computed from the float weight before the rewrite) and bias ``b`` in
    the model dtype; ``per_token`` selects dynamic per-token activation
    scales."""

    def __init__(self, ql: quant.QuantizedLinear, amber_scale: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("wq", ql.wq)
        self.register_buffer("w_scale", ql.w_scale)
        self.register_buffer("smooth", ql.smooth)
        self.register_buffer("act_scale", ql.act_scale)
        self.register_buffer("amber_scale", amber_scale)
        self.register_buffer("b", bias)
        self.per_token = bool(ql.per_token)


def init_linear(d_in: int, d_out: int, *, bias: bool = False,
                dtype: torch.dtype, device, generator: torch.Generator,
                scale: Optional[float] = None) -> Linear:
    """Normal init with std ``1/sqrt(d_in)`` (or ``scale``), zero bias."""
    lin = Linear(d_in, d_out, bias, dtype=dtype, device=device)
    std = scale if scale is not None else d_in**-0.5
    w = torch.randn(d_in, d_out, generator=generator, device=device) * std
    lin.w.copy_(w.to(dtype))
    return lin


def dense_linear(x: torch.Tensor, p: Linear) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def _quantized(x: torch.Tensor, p: QuantLinear, prune: bool,
               policy: SparsityPolicy) -> torch.Tensor:
    """Outstanding-sparse rung: smooth → (prune) → int8 matmul, cast to x's
    dtype.  The kernel adds the bias in its float32 epilogue; the plain
    chain adds it after the cast, as the JAX package's two forms do."""
    from repro_torch.kernels import ops, osparse_matmul

    act_scale = None if p.per_token else p.act_scale
    if policy.use_kernels:
        y = ops.osparse_matmul(x, p.wq, p.smooth, p.amber_scale, p.w_scale,
                               policy.n, policy.m, act_scale=act_scale, bias=p.b,
                               prune=prune, per_token=p.per_token)
        return y.to(x.dtype)
    y = osparse_matmul.osparse_matmul_plain(
        x, p.wq, p.smooth, p.amber_scale, p.w_scale, policy.n, policy.m,
        act_scale=act_scale, prune=prune, per_token=p.per_token).to(x.dtype)
    return y if p.b is None else y + p.b


def sparse_linear(x: torch.Tensor, p, module: str,
                  policy: SparsityPolicy, phase: str,
                  layer_idx: Optional[int] = None) -> torch.Tensor:
    """Projection ``module`` of layer ``layer_idx`` under the policy."""
    prune = policy.active(phase) and policy.should_prune(module, layer_idx)
    if isinstance(p, QuantLinear):
        return _quantized(x, p, prune, policy)
    if not prune:
        return dense_linear(x, p)
    return pruner.sparse_matmul(x, p.w, p.amber_scale, policy, bias=p.b)
