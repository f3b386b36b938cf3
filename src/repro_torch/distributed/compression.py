"""Gradient compression with error feedback (port of
``repro/distributed/compression.py``).

A per-tensor symmetric int8 round trip with a persistent error-feedback
buffer: the quantization residual of step t is added back to the gradient
of step t+1, so the accumulated update is unbiased (Karimireddy et al.
2019, "EF-SGD").  Like the reference, this is the algorithmic transform
(quantize, dequantize, feed the error back) as a stage of the gradient
pipeline, on dicts of tensors keyed by parameter name; the collective it
would shrink is not part of the port yet (ROADMAP A4b).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["ef_int8_init", "ef_int8_compress"]

_EPS = 1e-12

Tensors = Dict[str, torch.Tensor]


def _quant_dequant(g: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 round trip (the lossy channel), float32."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=_EPS) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q * scale


def ef_int8_init(params: Tensors) -> Tensors:
    """Zero float32 error-feedback buffers beside each parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def ef_int8_compress(grads: Tensors, ef: Tensors) -> Tuple[Tensors, Tensors]:
    """``(grads, ef) → (compressed grads, new ef)``:
    ``compressed = Q(g + ef)``, ``new_ef = (g + ef) − compressed``."""
    comp, new_ef = {}, {}
    for k, g in grads.items():
        target = g.float() + ef[k]
        comp[k] = _quant_dequant(target)
        new_ef[k] = target - comp[k]
    return comp, new_ef
