"""The training step: loss, gradients, microbatch accumulation and the
compression hook (port of ``repro/train/train_step.py``)::

    step_fn = make_train_step(model, opt_cfg, policy)
    params, opt_state, metrics = step_fn(params, opt_state, batch)

``params`` is the model's module (``model.init(seed)`` after
:func:`make_trainable`), ``opt_state`` :func:`~repro_torch.train.optimizer.
adamw_init` of :func:`trainable_params`, ``batch`` ``{"tokens": (B, S + 1)}``.
The step runs eagerly (the reference jits it).  With ``grad_accum > 1`` the
batch's leading axis is cut into that many microbatches, in order, and
their gradients are summed into float32 buffers, each divided by
``grad_accum`` first, as the reference's scan does; ``.grad`` in the
parameter's dtype is never used.  Under a policy active in ``"train"``
(``--sparse-train``) the pruned projections take ``nm_prune_matmul``'s
``torch.autograd.Function`` on the kernel path.

Under a bound ``distributed.sharding.mesh_scope`` (a train cell, or a
``Trainer`` run inside one) the batch is this rank's DP shard, and each
microbatch's gradients become the ZeRO-2 accumulator's slices at once:
reduce-scattered over the DP ranks onto ``sharding.shard_zero1``'s slice
and divided by the DP degree and ``grad_accum`` (a cell's shards by the
backward of their gather, ``sharding.gather_param``, which adds to the
accumulator itself; whole parameters here).  The loss is the mean over the DP ranks;
``optimizer.adamw_update`` takes the slices (ZeRO-1).  A ``compressor``
takes the slices too, before the norm and the update, as the reference
applies it before its optimizer: ``ef_int8_compress`` scales each slice by
its whole leaf's absmax there (``distributed/compression.py``).  Off a mesh
nothing of this runs.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.distributed import sharding
from repro_torch.train.optimizer import (OptConfig, _zero_mesh, adamw_update, global_norm,
                                         tail_layers, zero_norm)

__all__ = ["loss_fn", "make_train_step", "make_trainable", "trainable_params"]


def make_trainable(params: nn.Module) -> nn.Module:
    """Let every floating-point parameter of ``params`` require grad, in
    place; buffers (``amber_scale``, a ``QuantLinear``'s int8 weights and
    scales) stay buffers.  Returns ``params``."""
    for p in params.parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
    return params


def trainable_params(params: nn.Module) -> Dict[str, torch.Tensor]:
    """``{name: parameter}`` of every parameter that requires grad, in
    ``named_parameters`` order: the keys of the optimizer's state."""
    return {k: p for k, p in params.named_parameters() if p.requires_grad}


def loss_fn(model, params: nn.Module, batch: Dict[str, torch.Tensor],
            policy: SparsityPolicy = DENSE) -> torch.Tensor:
    """Next-token cross-entropy in float32: ``tokens (B, S + 1)`` → inputs
    ``tokens[:, :-1]``, labels ``tokens[:, 1:]``, the forward in the
    ``"train"`` phase."""
    tokens = batch["tokens"]
    logits = model.forward(params, {**batch, "tokens": tokens[:, :-1]}, policy=policy,
                           phase="train")
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return nll.mean()


def make_train_step(model, opt_cfg: OptConfig, policy: SparsityPolicy = DENSE,
                    grad_accum: int = 1,
                    compressor: Optional[Callable[[Dict], Dict]] = None) -> Callable:
    """Returns ``step_fn(params, opt_state, batch) → (params, opt_state,
    metrics)``; ``metrics`` holds 0-d tensors ``loss``, ``grad_norm`` (of
    the gradients handed to the optimizer) and ``step``.

    Args:
      grad_accum:  microbatches per step (must divide the batch).
      compressor:  optional transform of the gradient dict before the
                   optimizer (e.g. a closure over
                   ``distributed.compression.ef_int8_compress``); under a
                   bound mesh it gets the ZeRO-2 slices.
    """

    tail = tail_layers(model.cfg)

    def compute_grads(params, named, batch):
        loss = loss_fn(model, params, batch, policy)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), dict(zip(named, grads))

    def zero_step(params, named, opt_state, batch, mesh):
        b = batch["tokens"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum {grad_accum}")
        mb = b // grad_accum
        dp = sharding.data_axes(mesh)
        n = math.prod(mesh.shape[a] for a in dp) * grad_accum
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        grads: Dict[str, torch.Tensor] = {}
        held = {k: p for k, p in named.items() if getattr(p, "_shard", None) is not None}
        try:
            for k, p in held.items():
                # the gather's backward reduce-scatters into grads[k]
                p._zero2 = (grads, k, n)
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i = loss_fn(model, params, micro, policy)
                g_i = torch.autograd.grad(loss_i, list(named.values()), allow_unused=True)
                for k, g in zip(named, g_i):
                    if k in held:
                        continue
                    z = sharding.reduce_slice(g.float(), dp, sharding.shard_zero1(g.shape, mesh),
                                              mesh) / n
                    grads[k] = z if k not in grads else grads[k].add_(z)
                del g_i
                loss = loss + loss_i.detach() / grad_accum
        finally:
            for p in held.values():
                del p._zero2
        grads = {k: grads[k] for k in named}
        loss = sharding.all_reduce(loss, dp, mesh) / math.prod(mesh.shape[a] for a in dp)
        if compressor is not None:
            grads = compressor(grads)
        gnorm = zero_norm(grads, mesh)
        _, new_opt = adamw_update(opt_cfg, grads, opt_state, named, tail)
        return params, new_opt, {"loss": loss, "grad_norm": gnorm, "step": new_opt["step"]}

    def step_fn(params, opt_state, batch):
        named = trainable_params(params)
        mesh = _zero_mesh()
        if mesh is not None:
            return zero_step(params, named, opt_state, batch, mesh)
        if grad_accum == 1:
            loss, grads = compute_grads(params, named, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} is not a multiple of grad_accum {grad_accum}")
            mb = b // grad_accum
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in named.items()}
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, g_i = compute_grads(params, named, micro)
                for k, g in g_i.items():
                    grads[k].add_(g.float() / grad_accum)
                del g_i
                loss = loss + loss_i / grad_accum
        if compressor is not None:
            grads = compressor(grads)
        _, new_opt = adamw_update(opt_cfg, grads, opt_state, named, tail)
        metrics = {"loss": loss, "grad_norm": global_norm(grads), "step": new_opt["step"]}
        return params, new_opt, metrics

    return step_fn
