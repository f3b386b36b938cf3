"""Gated MLP (SwiGLU / GeGLU) with Amber-prunable projections (port of
``repro/models/mlp.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.policy import SparsityPolicy
from repro_torch.layers.linear import init_linear, sparse_linear

__all__ = ["MLP", "init_mlp", "mlp"]


class MLP(nn.Module):
    def __init__(self, gate_proj, up_proj, down_proj):
        super().__init__()
        self.gate_proj, self.up_proj, self.down_proj = gate_proj, up_proj, down_proj


def init_mlp(d_model: int, d_ff: int, *, dtype, device,
             generator: torch.Generator) -> MLP:
    kw = dict(dtype=dtype, device=device, generator=generator)
    return MLP(init_linear(d_model, d_ff, **kw), init_linear(d_model, d_ff, **kw),
               init_linear(d_ff, d_model, **kw))


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def mlp(x: torch.Tensor, p: MLP, policy: SparsityPolicy, phase: str,
        act_fn: str = "silu", layer_idx: Optional[int] = None) -> torch.Tensor:
    """SwiGLU: down( act(gate(x)) * up(x) )."""
    g = sparse_linear(x, p.gate_proj, "gate_proj", policy, phase, layer_idx)
    u = sparse_linear(x, p.up_proj, "up_proj", policy, phase, layer_idx)
    return sparse_linear(_act(g, act_fn) * u, p.down_proj, "down_proj", policy,
                         phase, layer_idx)
