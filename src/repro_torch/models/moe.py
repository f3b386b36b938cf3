"""Routed mixture-of-experts with a sort-based grouped product (port of the
local path of ``repro/models/moe.py``, ``_moe_local``).

Dispatch is dropless: the (token, expert) pairs are sorted by expert id
(stably), the rows gathered, and each expert's run of rows multiplied by its
weights in one grouped product (:func:`grouped_matmul`, the counterpart of
``jax.lax.ragged_dot``): FLOPs ∝ top_k, not n_experts.  ``impl="dense"``
is the weighted all-expert einsum form (``moe.py:117-130``).

Routing stays on the device and has a static shape: the router logits are
float32 (the router weight is kept in float32), the top-k is the first k of
a stable descending sort (ties go to the lower expert index, as
``jax.lax.top_k`` gives them), the rows of each group are counted with an
``index_add_`` of ones into an ``(E,)`` int32 buffer and summed into end
offsets on the device.  Nothing reads the routing on the host, so a step
that runs an MoE layer can be captured in a CUDA graph and replayed on other
routing; a chunk's padded rows are routed like the rest (the static
``T·k`` row count), as the JAX package routes them.

Amber Pruner inside experts (``moe.py:8-11, 54-57``): expert inputs are
pruned with plain |X| scores (``policy.moe_plain_score``: no Amber scale)
and per token even under tile consensus; the layer index is None, so the
q/gate skip list does not reach the routed experts.  Under the paper's
policy that prunes the expert ``gate_proj`` input and the ``down_proj``
input ``h`` in every layer, not the ``up_proj`` input.  Under
``policy.use_kernels`` each prune is one ``nm_prune`` launch.  The gate
input is pruned once per token, before the rows are gathered (T rows, not
T·k): the prune is per token, so the gathered rows are the ones JAX gets by
pruning the gathered ``xs``.  The shared expert is the port's ``mlp`` with
the static layer index, so the skip list applies to it as the JAX scan's
flags apply it.

Not ported here: ``_moe_shard_map`` (``moe.py:153-250``, the token-local
routed experts under a multi-device mesh), which comes with scale-out.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core import pruner
from repro_torch.core.policy import SparsityPolicy
from repro_torch.layers.linear import init_linear
from repro_torch.models.mlp import _act, init_mlp, mlp

__all__ = ["Experts", "MoE", "init_moe", "moe", "route", "grouped_matmul",
           "grouped_matmul_plain"]


class Experts(nn.Module):
    """The routed experts' weights, contiguous in the JAX package's layout:
    ``gate_proj``/``up_proj`` ``(E, D, F)`` and ``down_proj`` ``(E, F, D)``
    (``torch._grouped_mm`` takes them so; on the H100 it is no slower than
    on K-major copies).  They are parameters, not ``Linear``s: no Amber
    scale is ever attached to them."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int, *, dtype, device,
                 generator: torch.Generator):
        super().__init__()

        def weights(d_in, d_out):
            w = torch.randn(n_experts, d_in, d_out, generator=generator, device=device)
            return nn.Parameter((w * d_in**-0.5).to(dtype), requires_grad=False)

        self.gate_proj = weights(d_model, d_ff)
        self.up_proj = weights(d_model, d_ff)
        self.down_proj = weights(d_ff, d_model)


class MoE(nn.Module):
    def __init__(self, router, experts: Experts, shared=None):
        super().__init__()
        self.router, self.experts, self.shared = router, experts, shared


def init_moe(d_model: int, moe_d_ff: int, n_experts: int, shared_expert: bool, *,
             dtype, device, generator: torch.Generator) -> MoE:
    """Router ``(D, E)`` in float32 (``moe.py:41``), the experts in ``dtype``,
    and the optional shared expert (a gated MLP of width ``moe_d_ff``)."""
    router = init_linear(d_model, n_experts, dtype=torch.float32, device=device,
                         generator=generator)
    experts = Experts(n_experts, d_model, moe_d_ff, dtype=dtype, device=device,
                      generator=generator)
    shared = (init_mlp(d_model, moe_d_ff, dtype=dtype, device=device, generator=generator)
              if shared_expert else None)
    return MoE(router, experts, shared)


# ----------------------------------------------------------- grouped product

def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """Plain version: one ``torch.matmul`` per group.  It reads the offsets
    on the host, so it cannot be captured in a CUDA graph."""
    out = x.new_empty(x.shape[0], w.shape[-1])
    start = 0
    for g, end in enumerate(offsets.tolist()):
        out[start:end] = x[start:end] @ w[g]
        start = end
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``x (R, K)`` with its rows sorted by group, ``w (G, K, N)``, and
    ``offsets (G,)`` int32 end offsets of the groups (``offsets[-1] == R``;
    a group may be empty) → ``(R, N)``: each group's rows times its weight.

    On CUDA tensors one ``torch._grouped_mm`` call (CUTLASS's grouped GEMM
    for bfloat16 on sm_90), which reads the offsets from device memory, so a
    CUDA graph can capture it; on the CPU the plain version."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {x.device}")
    return torch._grouped_mm(x, w, offs=offsets)


# ------------------------------------------------------------------ the layer

def route(xt: torch.Tensor, router_w: torch.Tensor,
          top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 router logits of ``xt (T, D)``, their top ``top_k`` (a stable
    descending sort: ties to the lower expert index, as ``jax.lax.top_k``),
    and a softmax over the kept values → (gates (T, k) float32, expert ids
    (T, k) int64)."""
    logits = xt.float() @ router_w
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :top_k], dim=-1), ids[:, :top_k]


def _maybe_prune(x: torch.Tensor, module: str, policy: SparsityPolicy,
                 phase: str) -> torch.Tensor:
    # layer None (moe.py:55): the q/gate skip list does not reach the routed
    # experts, so in a skipped layer the expert gate input is still pruned
    # while q_proj stays dense.  Plain |X| scores: no scale.
    if not (policy.active(phase) and policy.should_prune(module, None)):
        return x
    if policy.use_kernels:
        from repro_torch.kernels import ops

        return ops.nm_prune(x, None, policy.n, policy.m)
    return pruner.prune_input(x, None, policy)


def moe(x: torch.Tensor, p: MoE, policy: SparsityPolicy, phase: str, top_k: int,
        act_fn: str = "silu", impl: str = "ragged",
        layer_idx: Optional[int] = None) -> torch.Tensor:
    """The MoE feed-forward of ``x (..., D)``; ``layer_idx`` is the block's
    (it reaches the shared expert only)."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    ex = p.experts
    wg, wu, wd = ex.gate_proj, ex.up_proj, ex.down_proj
    n_experts = wg.shape[0]
    gates, expert_ids = route(xt, p.router.w, top_k)
    xg = _maybe_prune(xt, "gate_proj", policy, phase)
    xu = _maybe_prune(xt, "up_proj", policy, phase)

    if impl == "dense":
        combine = torch.zeros(t, n_experts, dtype=torch.float32, device=x.device)
        combine.scatter_add_(1, expert_ids, gates)
        h = _act(torch.einsum("td,edf->tef", xg, wg), act_fn)
        h = h * torch.einsum("td,edf->tef", xu, wu)
        h = _maybe_prune(h.reshape(t * n_experts, -1), "down_proj", policy, phase
                         ).reshape(t, n_experts, -1)
        y_e = torch.einsum("tef,efd->ted", h, wd)
        y = torch.einsum("ted,te->td", y_e, combine.to(y_e.dtype))
    else:
        grouped = grouped_matmul if policy.use_kernels else grouped_matmul_plain
        flat_e = expert_ids.reshape(-1)                           # (T*k,)
        order = torch.sort(flat_e, stable=True).indices
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=x.device))
        tok = order // top_k                                      # flat_t[order]
        counts = torch.zeros(n_experts, dtype=torch.int32, device=x.device)
        counts.index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
        offsets = torch.cumsum(counts, 0, dtype=torch.int32)
        xs = xg.index_select(0, tok)
        xus = xs if xu is xg else xu.index_select(0, tok)
        h = _act(grouped(xs, wg, offsets), act_fn) * grouped(xus, wu, offsets)
        h = _maybe_prune(h, "down_proj", policy, phase)
        ys = grouped(h, wd, offsets)                              # (T*k, D)
        y_flat = ys.index_select(0, inv).reshape(t, top_k, d)
        y = torch.einsum("tkd,tk->td", y_flat, gates.to(y_flat.dtype))

    y = y.to(x.dtype)
    if p.shared is not None:
        y = y + mlp(xt, p.shared, policy, phase, act_fn, layer_idx)
    return y.reshape(shape)
