"""Carry the JAX package's parameters into the port's modules.

``from_jax_params(cfg, params_np)`` takes the JAX parameter pytree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) and returns the port's :class:`~repro_torch.models.transformer.
Transformer` with the same weights: the scan-stacked ``periods`` layer axis
is unstacked into the block list, and
``amber_scale`` entries are carried as float32.  bfloat16 arrays come out
of numpy as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so
every float array goes through float32 first; bf16 → f32 → bf16 is exact.
A quantized projection's dict (``wq`` and no ``w``) becomes a
:class:`~repro_torch.layers.linear.QuantLinear`: ``wq`` is carried as int8,
stored K-major (one ``(d_out, d_in)`` buffer behind the ``(d_in, d_out)``
view, transposed on the host so no second copy reaches the device);
``w_scale``, ``smooth``, ``act_scale`` and ``amber_scale`` as float32.

``quantize_linears(model, absmax, qcfg)`` applies the offline
SmoothQuant / Outstanding rewrite (``core.quant.make_quantized_linear``) to
the projections ``qcfg`` quantizes and frees their float weights.

This module imports nothing of JAX: it sees only numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.policy import ALL_PROJS, MLP_PROJS
from repro_torch.core.pruner import SCALE_KEY
from repro_torch.layers.linear import Linear, QuantLinear
from repro_torch.models import common, transformer

__all__ = ["from_jax_params", "quantize_linears"]


def _t(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(device=device,
                                                                 dtype=dtype)


def _quant_linear(p: Dict[str, Any], dtype, device) -> QuantLinear:
    f32 = lambda k: _t(p[k], torch.float32, device)
    ql = quant.QuantizedLinear(
        wq=torch.from_numpy(np.ascontiguousarray(np.asarray(p["wq"], dtype=np.int8).T)
                            ).to(device).t(),
        w_scale=f32("w_scale"), smooth=f32("smooth"), act_scale=f32("act_scale"),
        per_token=bool(p.get("per_token", False)))
    return QuantLinear(ql, amber_scale=f32(SCALE_KEY) if SCALE_KEY in p else None,
                       bias=_t(p["b"], dtype, device) if "b" in p else None)


def _load_linear(owner, name: str, p: Dict[str, Any], dtype, device) -> None:
    if "wq" in p:
        setattr(owner, name, _quant_linear(p, dtype, device))
        return
    lin = getattr(owner, name)
    lin.w.copy_(_t(p["w"], dtype, device))
    if lin.b is not None:
        lin.b.copy_(_t(p["b"], dtype, device))
    if SCALE_KEY in p:
        lin.amber_scale = _t(p[SCALE_KEY], torch.float32, device)


def _layer_params(params_np: Dict, i: int) -> Dict:
    """Layer ``i`` of the scan-stacked ``periods`` pytree (the dense family's
    block pattern is one attention block, so period i is layer i)."""
    def take(d):
        return {k: take(v) if isinstance(v, dict) else np.asarray(v)[i]
                for k, v in d.items()}

    return take(params_np["periods"]["b0"])


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, params_np: Dict, device=None
                    ) -> transformer.Transformer:
    """The port's model holding the JAX parameters ``params_np``, on
    ``device`` (default: the GPU, raising if there is none)."""
    device = common.resolve_device(device)
    dtype = common.dtype_of(cfg)
    model = transformer.init_params(cfg, 0, device=device)
    model.embed.w.copy_(_t(params_np["embed"]["w"], dtype, device))
    model.final_norm.w.copy_(_t(params_np["final_norm"]["w"], dtype, device))
    if model.lm_head is not None:
        _load_linear(model, "lm_head", params_np["lm_head"], dtype, device)
    for i, blk in enumerate(model.blocks):
        lp = _layer_params(params_np, i)
        blk.ln1.w.copy_(_t(lp["ln1"]["w"], dtype, device))
        blk.ln2.w.copy_(_t(lp["ln2"]["w"], dtype, device))
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _load_linear(blk, name, lp[name], dtype, device)
        for name in ("gate_proj", "up_proj", "down_proj"):
            _load_linear(blk.mlp, name, lp["mlp"][name], dtype, device)
    return model


@torch.no_grad()
def quantize_linears(model: transformer.Transformer,
                     absmax: Dict[Tuple[int, str], torch.Tensor],
                     qcfg: quant.QuantConfig) -> transformer.Transformer:
    """Replace every projection ``qcfg.should_quantize(module, layer)`` with
    its :class:`QuantLinear` (``absmax[(layer, module)]`` is the ``(d_in,)``
    calibrated activation absmax), keeping its Amber scale and bias, and
    free the float weight; the int8 weights are stored K-major
    (``quant.k_major``), one buffer each.  Amber scales are computed from the float
    weights, so run ``precompute_scales`` first.  In place; returns
    ``model``."""
    for i, blk in enumerate(model.blocks):
        for name in ALL_PROJS:
            owner = blk.mlp if name in MLP_PROJS else blk
            lin = getattr(owner, name)
            if not isinstance(lin, Linear) or not qcfg.should_quantize(name, i):
                continue
            am = torch.as_tensor(absmax[(i, name)], device=lin.w.device)
            ql = quant.make_quantized_linear(lin.w, am, qcfg)
            setattr(owner, name, QuantLinear(
                ql, lin.amber_scale, None if lin.b is None else lin.b.detach()))
    return model
