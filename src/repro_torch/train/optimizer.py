"""AdamW, the cosine schedule and global-norm clipping (port of
``repro/train/optimizer.py``).

The state is plain tensors keyed by the port's parameter names
(``model.named_parameters()``): ``{"mu": {name: float32}, "nu": {name:
float32}, "step": 0-d int32}``, so it checkpoints like the parameters.
``mu`` and ``nu`` are float32 whatever the parameter dtype, and the update
runs in float32 on a float32 copy of each parameter, cast back once, as the
reference does (``torch.optim.AdamW`` keeps its moments in the parameter's
dtype, so it computes another function).

:func:`adamw_update` keeps the reference's interface (it returns the new
parameters and state) but writes them into the tensors it is given, one
leaf at a time, so a full-size model holds one copy of its state and the
float32 temporaries of one leaf: ``mu`` and ``nu`` are updated in place and
each parameter is overwritten with its new value.  The per-leaf arithmetic
keeps the reference's order of operations (``b1 * mu + (1 - b1) * g``,
``(1 - b2) * g * g``, bias corrections as divisions).

ZeRO-1 (under a bound ``distributed.sharding.mesh_scope``): each rank
holds ``mu`` and ``nu`` only as the slice :func:`~repro_torch.distributed.
sharding.opt_state_specs` names (the parameter's spec, widened by the
largest still-free dim the DP degree divides); the gradients come as the
ZeRO-2 accumulator's slices (``sharding.shard_zero1``); clipping reads the
norm summed over the DP ranks; each rank updates its slice of every
parameter and gathers the slices back over DP (a train cell's FSDP shards
are already that slice and stay so).  Off a mesh nothing of this runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.distributed import sharding

__all__ = ["OptConfig", "adamw_init", "adamw_update", "cosine_lr", "decays",
           "global_norm", "moment_spec", "spec_of", "tail_layers", "zero_norm"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.float32)


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to ``min_lr_frac``
    of it, as a float32 0-d tensor on ``step``'s device."""
    step = _f32(step, step.device if isinstance(step, torch.Tensor) else "cpu")
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(_f32(math.pi, step.device) * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Tensors) -> torch.Tensor:
    """The float32 L2 norm of every tensor of ``tree`` together."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


_STACKED = ("blocks", "enc_blocks", "dec_blocks")


def decays(name: str, p: torch.Tensor, tail: Tuple[int, ...] = ()) -> bool:
    """Whether AdamW decays the parameter ``name``.

    The reference decays a leaf with ``p.ndim >= 2``
    (``repro/train/optimizer.py:86``) on its stacked tree, where every
    per-layer leaf carries a leading layer axis (the scan-stacked periods,
    an encoder-decoder's vmap-stacked ``enc_blocks`` / ``dec_blocks``): a
    layer's norm weights and biases are ``(n_layers, d)`` there and are
    decayed, as are the embedding and the LM head; the top-level 1-D leaves
    (``final_norm``) are not, nor are those of the layers in its unrolled
    tail (the ``n_layers % len(block_pattern)`` layers past the last
    period: ``tail``, their indices).  The port keeps one tensor a layer, so
    the rule reads the reference's rank: every leaf of a stacked layer, and
    any other of rank 2 or more."""
    stack, _, rest = name.partition(".")
    if stack in _STACKED and not (stack == "blocks" and int(rest.split(".", 1)[0]) in tail):
        return True
    return p.dim() >= 2


def tail_layers(cfg) -> Tuple[int, ...]:
    """The layers of ``cfg`` that the reference keeps out of its stacked
    periods (its ``tail``): :func:`decays`' ``tail``."""
    if cfg.is_encdec:
        return ()
    stacked = cfg.n_layers // len(cfg.block_pattern) * len(cfg.block_pattern)
    return tuple(range(stacked, cfg.n_layers))


def _zero_mesh():
    """The bound mesh ZeRO runs on, or None (off a mesh)."""
    mesh = sharding._context_mesh()
    return mesh if mesh is not None and mesh.bound else None


def spec_of(p: torch.Tensor) -> tuple:
    """The spec a parameter is held under (a cell's shard), else whole."""
    tg = getattr(p, "_shard", None)
    return tg[0] if tg is not None else (None,) * p.dim()


def moment_spec(p: torch.Tensor, mesh) -> tuple:
    """``opt_state_specs``' spec of ``p``'s moments on ``mesh``."""
    return sharding._widen(spec_of(p), sharding.full_shape(p), mesh)


def _extra(outer: tuple, inner: tuple, mesh) -> tuple:
    """The entries of ``outer`` that ``inner`` does not already cut."""
    return tuple(None if a == b else a for a, b in zip(sharding.effective(outer, mesh),
                                                        sharding.effective(inner, mesh)))


def adamw_init(params: Tensors) -> Dict:
    """Zero float32 moments beside each parameter (under a bound mesh:
    this rank's ZeRO-1 slice of them) and a 0-d int32 step."""
    any_p = next(iter(params.values()))
    mesh = _zero_mesh()

    def zeros(p):
        shape = p.shape
        if mesh is not None:
            meta = torch.empty(sharding.full_shape(p), device="meta")
            shape = sharding.local(meta, moment_spec(p, mesh), mesh).shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=any_p.device)}


def zero_norm(grads: Tensors, mesh) -> torch.Tensor:
    """The float32 global norm of ZeRO-2 accumulator slices: each rank's
    sum of squares, summed over the DP ranks (a leaf no DP slice cuts is
    counted by DP rank 0 alone).  A slice that other axes cut as well (an
    expert stack's ``model`` shard, ``sharding.grad_spec``) is summed over
    those axes first."""
    dp = sharding.data_axes(mesh)
    first = all(mesh.coords()[a] == 0 for a in dp)
    total, over = None, {}
    for g in grads.values():
        tg = getattr(g, "_shard", None)
        spec = tg[0] if tg is not None else sharding.shard_zero1(g.shape, mesh)
        by_dp = sharding.sharded(tuple(e if set(sharding._axes(e)) & set(dp) else None
                                       for e in spec), mesh)
        if not first and not by_dp:
            continue
        sq = torch.sum(torch.square(g.float()))
        axes = () if tg is None else tuple(
            a for a in mesh.axis_names if a not in dp and mesh.shape[a] > 1
            and any(a in sharding._axes(e) for e in spec))
        if axes:
            over[axes] = sq if axes not in over else over[axes] + sq
        else:
            total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    for axes, sq in over.items():
        total = total + sharding.all_reduce(sq, axes, mesh)
    return torch.sqrt(sharding.all_reduce(total, dp, mesh))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Tensors, opt_state: Dict, params: Tensors,
                 tail: Tuple[int, ...] = ()) -> Tuple[Tensors, Dict]:
    """One AdamW step with global-norm clipping → ``(params, opt_state)``.

    The clip scale ``min(1, clip_norm / (gnorm + 1e-9))`` multiplies the
    float32 gradients before the moments.  In place (module docstring):
    the returned dicts hold the tensors passed in, updated; ``step`` is a
    new tensor.  Under a bound mesh ``grads`` are the accumulator's ZeRO-2
    slices (``sharding.grad_spec``: ``shard_zero1`` of each whole gradient's
    shape, or an expert stack's own shard) and the update runs on ZeRO-1
    slices (module docstring).  ``tail``: the model's layers outside the
    reference's stacked periods (:func:`tail_layers`, :func:`decays`)."""
    mesh = _zero_mesh()
    if mesh is not None:
        return _zero_update(cfg, grads, opt_state, params, mesh, tail)
    step = opt_state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    # torch.div, not ``clip / tensor``, which torch computes as a reciprocal
    # times the number: two roundings where the reference has one
    scale = torch.clamp(torch.div(_f32(cfg.clip_norm, gnorm.device), gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1t = 1 - torch.pow(_f32(cfg.b1, step.device), stepf)
    b2t = 1 - torch.pow(_f32(cfg.b2, step.device), stepf)
    mus, nus = opt_state["mu"], opt_state["nu"]
    for name, p in params.items():
        g = grads[name].float() * scale
        mu, nu = mus[name], nus[name]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = (mu / b1t).div_(torch.sqrt(nu / b2t).add_(cfg.eps))
        p32 = p.float()
        if decays(name, p, tail):
            delta.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * delta)
    return params, {"mu": mus, "nu": nus, "step": step}


def _zero_update(cfg: OptConfig, grads: Tensors, opt_state: Dict, params: Tensors, mesh,
                 tail: Tuple[int, ...] = ()) -> Tuple[Tensors, Dict]:
    step = opt_state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = zero_norm(grads, mesh)
    scale = torch.clamp(torch.div(_f32(cfg.clip_norm, gnorm.device), gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1t = 1 - torch.pow(_f32(cfg.b1, step.device), stepf)
    b2t = 1 - torch.pow(_f32(cfg.b2, step.device), stepf)
    mus, nus = opt_state["mu"], opt_state["nu"]
    for name, p in params.items():
        ospec, pspec = moment_spec(p, mesh), spec_of(p)
        g = grads[name]
        zspec = sharding.grad_spec(g, sharding.full_shape(p), mesh)
        if sharding.effective(zspec, mesh) != sharding.effective(ospec, mesh):
            # the accumulator's slice is not the moments': re-cut it
            g = sharding.local(sharding.gather(g, zspec, mesh), ospec, mesh)
        g = g.float() * scale
        mu, nu = mus[name], nus[name]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = (mu / b1t).div_(torch.sqrt(nu / b2t).add_(cfg.eps))
        extra = _extra(ospec, pspec, mesh)  # what ZeRO-1 cuts beyond the parameter's shard
        p32 = sharding.local(p.detach(), extra, mesh).float()
        if decays(name, p, tail):
            delta.add_(cfg.weight_decay * p32)
        new = (p32 - lr * delta).to(p.dtype)
        p.detach().copy_(sharding.gather(new, extra, mesh))
    return params, {"mu": mus, "nu": nus, "step": step}
