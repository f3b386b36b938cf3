"""Linear projections honoring the Amber Pruner policy (port of
``repro/layers/linear.py``).

``Linear`` keeps its weight in the JAX package's ``(d_in, d_out)`` layout,
which is what the kernels take, so nothing is transposed.  Layers are a
Python loop in the port, so ``sparse_linear`` always knows the static layer
index and consults the policy's skip list directly; there is no traced
``layer_flag``.  A pruned projection goes through ``core.pruner.
sparse_matmul`` (one ``nm_prune_matmul`` launch under ``use_kernels``);
every other projection is ``x @ w (+ b)`` through ``torch.matmul``, as the
JAX package leaves it to XLA.  Quantized (W8A8 / Outstanding-sparse)
weights are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core import pruner
from repro_torch.core.policy import SparsityPolicy

__all__ = ["Linear", "init_linear", "dense_linear", "sparse_linear"]


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


def sparse_linear(x: torch.Tensor, p: Linear, module: str,
                  policy: SparsityPolicy, phase: str,
                  layer_idx: Optional[int] = None) -> torch.Tensor:
    """Projection ``module`` of layer ``layer_idx`` under the policy."""
    if not (policy.active(phase) and policy.should_prune(module, layer_idx)):
        return dense_linear(x, p)
    return pruner.sparse_matmul(x, p.w, p.amber_scale, policy, bias=p.b)
