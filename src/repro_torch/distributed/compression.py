"""Gradient compression with error feedback (port of
``repro/distributed/compression.py``).

A per-tensor symmetric int8 round trip with a persistent error-feedback
buffer: the quantization residual of step t is added back to the gradient
of step t+1, so the accumulated update is unbiased (Karimireddy et al.
2019, "EF-SGD").  Like the reference, this is the algorithmic transform
(quantize, dequantize, feed the error back) as a stage of the gradient
pipeline, on dicts of tensors keyed by parameter name; the collective it
would shrink is not part of the port yet (ROADMAP A4b).

The reference's tensors are the leaves of its stacked tree, a layer's rows
of each (``weights.reference_leaves`` names them); the port keeps one tensor
a layer, so a caller that wants the reference's scales passes that map.
Under a bound ``distributed.sharding.mesh_scope`` (a ZeRO train step, where
each rank holds the ZeRO-2 slice of every gradient) the buffers are this
rank's slices (``sharding.param_grad_spec``), and each leaf's scale is the
absmax of the whole leaf: one all-reduce (max) over the mesh of every
slice's absmax, so a rank's compressed slice is the same slice of the
one-rank compressed gradient.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding

__all__ = ["ef_int8_init", "ef_int8_compress"]

_EPS = 1e-12

Tensors = Dict[str, torch.Tensor]


def _quant_dequant(g: torch.Tensor, absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric per-tensor int8 round trip (the lossy channel), float32;
    ``absmax``: the whole tensor's, where ``g`` is a slice of it."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max() if absmax is None else absmax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q * scale


def _mesh():
    mesh = sharding._context_mesh()
    return mesh if mesh is not None and mesh.bound else None


def ef_int8_init(params: Tensors) -> Tensors:
    """Zero float32 error-feedback buffers beside each parameter (under a
    bound mesh: this rank's ZeRO-2 slice of it)."""
    mesh = _mesh()

    def zeros(k, p):
        shape = p.shape
        if mesh is not None:
            meta = torch.empty(sharding.full_shape(p), device="meta")
            shape = sharding.local(meta, sharding.param_grad_spec(k, p, mesh), mesh).shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {k: zeros(k, p) for k, p in params.items()}


def ef_int8_compress(grads: Tensors, ef: Tensors, leaves: Optional[Dict[str, str]] = None
                     ) -> Tuple[Tensors, Tensors]:
    """``(grads, ef) → (compressed grads, new ef)``:
    ``compressed = Q(g + ef)``, ``new_ef = (g + ef) − compressed``.  Under a
    bound mesh ``grads`` and ``ef`` are this rank's slices (a slice's tag,
    ``sharding.grad_spec``, carries over to its compressed slice).
    ``leaves``: ``{name: key}``, the names that share a key sharing one
    scale: the reference's tensor is its stacked leaf, every layer's rows
    (``weights.reference_leaves``); by default each tensor its own."""
    targets = {k: g.float() + ef[k] for k, g in grads.items()}
    mesh = _mesh()
    absmax = dict.fromkeys(targets)
    if (mesh is not None or leaves is not None) and targets:
        # the whole leaf's absmax: ranks that hold the same slice give the
        # same value, so the max over every rank is the max over the leaf
        amax = torch.stack([t.abs().max() for t in targets.values()])
        if mesh is not None:
            sharding.all_reduce(amax, mesh.axis_names, mesh, op="max")
        absmax = dict(zip(targets, amax.unbind(0)))
        if leaves is not None:
            top: Dict[str, torch.Tensor] = {}
            for k, a in absmax.items():
                key = leaves.get(k, k)
                top[key] = a if key not in top else torch.maximum(top[key], a)
            absmax = {k: top[leaves.get(k, k)] for k in absmax}
    comp, new_ef = {}, {}
    for k, target in targets.items():
        comp[k] = _quant_dequant(target, absmax[k])
        new_ef[k] = target - comp[k]
        tg = getattr(grads[k], "_shard", None)
        if tg is not None:
            sharding.tag(comp[k], *tg)
    return comp, new_ef
