"""Carry the JAX package's parameters into the port's modules.

``from_jax_params(cfg, params_np)`` takes the JAX parameter pytree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) and returns the port's :class:`~repro_torch.models.transformer.
Transformer` with the same weights: the scan-stacked ``periods`` layer axis
is unstacked into the block list, and
``amber_scale`` entries are carried as float32.  bfloat16 arrays come out
of numpy as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so
every array goes through float32 first; bf16 → f32 → bf16 is exact.
This module imports nothing of JAX: it sees only numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruner import SCALE_KEY
from repro_torch.layers.linear import Linear
from repro_torch.models import common, transformer

__all__ = ["from_jax_params"]


def _t(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(device=device,
                                                                 dtype=dtype)


def _load_linear(lin: Linear, p: Dict[str, Any], dtype, device) -> None:
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
def from_jax_params(cfg: ModelConfig, params_np: Dict, device="cpu"
                    ) -> transformer.Transformer:
    """The port's model holding the JAX parameters ``params_np``."""
    dtype = common.dtype_of(cfg)
    model = transformer.init_params(cfg, 0, device=device)
    model.embed.w.copy_(_t(params_np["embed"]["w"], dtype, device))
    model.final_norm.w.copy_(_t(params_np["final_norm"]["w"], dtype, device))
    if model.lm_head is not None:
        _load_linear(model.lm_head, params_np["lm_head"], dtype, device)
    for i, blk in enumerate(model.blocks):
        lp = _layer_params(params_np, i)
        blk.ln1.w.copy_(_t(lp["ln1"]["w"], dtype, device))
        blk.ln2.w.copy_(_t(lp["ln2"]["w"], dtype, device))
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _load_linear(getattr(blk, name), lp[name], dtype, device)
        for name in ("gate_proj", "up_proj", "down_proj"):
            _load_linear(getattr(blk.mlp, name), lp["mlp"][name], dtype, device)
    return model
