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

Under a mesh (``distributed.sharding.mesh_scope`` of more than one rank,
with a ``model`` axis, the ragged impl, a 3-D ``x`` and a global batch the
DP degree divides: ``moe.py:71-89``) :func:`moe` takes
:func:`_moe_shard_map`, the reference's token-local experts: every rank
routes its own tokens into fixed-capacity slots and holds ``d_ff / model``
of every expert (the cell's shards), and one all-reduce over ``model`` sums
the row-parallel down products.  The serving TP scope
(``distributed/tp.py``) is not a mesh: the reference's serving never opens
one, so an MoE under ``EngineConfig(tp > 1)`` keeps the local path.  A
sharded model whose experts did not take the shard-map path gathers them
whole for the local one.

Training (``train/``, the reference's ``jax.grad`` of the same functions):

* local path: the experts are parameters that ``train.make_trainable``
  turns on, the float32 router keeps a float32 gradient, which reaches it
  through the kept sorted values (Llama-4-Scout's top-1 softmax is the
  constant 1, so its router gradient is exactly 0, as the reference's);
  :func:`grouped_matmul` differentiates through ``torch._grouped_mm``'s own
  backward on the card (``dX`` one grouped product on the transposed
  weights, ``dW`` one of ``Xᵀ · dY`` with the offsets along K; the card's
  torch runs it with empty groups and groups of any length) and through the
  plain loop's per-group products on the CPU; the grouped product is
  chosen by ``policy.use_kernels``, so a dense run on the card passes
  ``DENSE.with_(use_kernels=True)`` (no prune is active; only the product's
  route changes); each prune under
  ``policy.use_kernels`` is ``nm_prune``'s ``torch.autograd.Function``
  (``dX = where(keep, dY, 0)``);
* shard-map path: the ranks of ``model`` each compute a partial sum over
  their ``d_ff`` columns from inputs replicated over ``model`` (the tokens
  and the router's gates), so the region takes Megatron's pair of
  operators: ``sharding.reduce_from`` on its output (all-reduce forward,
  the cotangent passed on unchanged) and ``sharding.copy_to`` on its inputs
  (identity forward, the partial cotangents all-reduced over ``model``,
  once each).  A train cell holds each expert stack FSDP-style (``D`` or
  the down stack's ``D`` on the DP axes as well); ``sharding.gather_data``
  gathers it over the DP axes alone, and its backward pays the rank's
  slice into the ZeRO-2 accumulator.  A slot past capacity is zeroed, so
  its pairs get no gradient, as in the reference.  Under remat each block
  runs again in the backward, under the forward's mesh and TP scopes
  (``transformer._remat_context``: on the card autograd recomputes in a
  thread of its own), with the same collectives in the same order on every
  rank and the same routing.  Torch's non-reentrant checkpoint stops that
  recompute at the block's last saved tensor (the gated combine), so the
  prunes run again (the launch counters count them twice a forward) but
  not the output's all-reduce, and ``shard_map_stats`` counts each forward
  once.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core import pruner
from repro_torch.core.policy import SparsityPolicy
from repro_torch.distributed import sharding
from repro_torch.layers.linear import init_linear
from repro_torch.models.mlp import _act, init_mlp, mlp

__all__ = ["Experts", "MoE", "init_moe", "moe", "route", "grouped_matmul",
           "grouped_matmul_plain", "capacity", "shard_map_stats"]


class Experts(nn.Module):
    """The routed experts' weights, contiguous in the JAX package's layout:
    ``gate_proj``/``up_proj`` ``(E, D, F)`` and ``down_proj`` ``(E, F, D)``
    (``torch._grouped_mm`` takes them so; on the H100 it is no slower than
    on K-major copies).  They are parameters, not ``Linear``s: no Amber
    scale is ever attached to them.  Made with ``requires_grad=False``, as
    every parameter of the port; ``train.make_trainable`` turns them on."""

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
    """Plain version: one ``torch.matmul`` per group, the groups' rows
    concatenated (under autograd each group's backward reads its own rows of
    the cotangent; writes into slices of one buffer would copy the whole
    cotangent once a group).  It reads the offsets on the host, so it cannot
    be captured in a CUDA graph."""
    parts, start = [], 0
    for g, end in enumerate(offsets.tolist()):
        parts.append(x[start:end] @ w[g])
        start = end
    return torch.cat(parts) if parts else x.new_empty(0, w.shape[-1])


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``x (R, K)`` with its rows sorted by group, ``w (G, K, N)``, and
    ``offsets (G,)`` int32 end offsets of the groups (``offsets[-1] == R``;
    a group may be empty) → ``(R, N)``: each group's rows times its weight.

    On CUDA tensors one ``torch._grouped_mm`` call (CUTLASS's grouped GEMM
    for bfloat16 on sm_90), which reads the offsets from device memory, so a
    CUDA graph can capture it (on ``meta`` tensors the same call gives the
    shape); on the CPU the plain version."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, offsets)
    if x.device.type not in ("cuda", "meta"):
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
    mesh = sharding._context_mesh()
    if (impl == "ragged" and mesh is not None and mesh.size > 1
            and "model" in mesh.axis_names and x.dim() == 3):
        dp = math.prod(mesh.shape[a] for a in sharding.data_axes(mesh))
        b = x.shape[0] * sharding._batch_shards()
        # the reference shards the batch only where the DP degree divides it;
        # a tiny batch (B = 1 long-context decode) takes the local path
        if b % dp == 0 and b >= dp:
            return _moe_shard_map(mesh, x, p, policy, phase, top_k, act_fn, layer_idx)
    return _moe_local(x, p, policy, phase, top_k, act_fn, impl, layer_idx)


def _moe_local(x: torch.Tensor, p: MoE, policy: SparsityPolicy, phase: str, top_k: int,
               act_fn: str, impl: str, layer_idx: Optional[int]) -> torch.Tensor:
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    ex = p.experts
    wg, wu, wd = (sharding.gather_param(w) for w in (ex.gate_proj, ex.up_proj, ex.down_proj))
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


# -------------------------------------------------------- under a mesh

def capacity(tokens: int, top_k: int, n_experts: int) -> int:
    """Slots an expert takes of ``tokens`` routed ``top_k`` ways:
    ``ceil(tokens·k / E)·1.25`` (truncated), rounded up to a multiple of 8,
    at least 8 (``moe.py:186-187``)."""
    cap = int(-(-(tokens * top_k) // n_experts) * 1.25)
    return max(8, -(-cap // 8) * 8)


# every _moe_shard_map call adds to these (this rank's): calls, (token,
# expert) pairs routed, pairs dropped past capacity, the last capacity
shard_map_stats = {"calls": 0, "pairs": 0, "dropped": 0, "capacity": 0}


def _expert_shards(mesh, ex: Experts) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The expert stacks as ``_moe_shard_map`` reads them: each gathered
    over the DP axes (``sharding.gather_data``; a train cell's FSDP cut),
    then checked to be the ``d_ff / model`` shard of the whole stack (gate
    and up on their last dim, down on its in-dim)."""
    out = []
    for name in ("gate_proj", "up_proj", "down_proj"):
        w = getattr(ex, name)
        full = sharding.full_shape(w)
        dim = 1 if name == "down_proj" else 2
        want = full[:dim] + (full[dim] // mesh.shape["model"],) + full[dim + 1:]
        got = sharding.gather_data(w)
        if full[dim] % mesh.shape["model"] or tuple(got.shape) != want:
            cut = "" if tuple(got.shape) == tuple(w.shape) else \
                f" (gathered over the DP axes from {tuple(w.shape)})"
            raise ValueError(
                f"expert stack {name} {tuple(got.shape)}{cut} is not the d_ff / "
                f"{mesh.shape['model']} shard {want} of {full}: a DP axis still cuts it, or "
                "model does not cut d_ff")
        out.append(got)
    return tuple(out)


def _moe_shard_map(mesh, x: torch.Tensor, p: MoE, policy: SparsityPolicy, phase: str,
                   top_k: int, act_fn: str, layer_idx: Optional[int]) -> torch.Tensor:
    """Token-local routed experts on this rank's ``x (b, t, D)`` (its
    batch shard) with fixed-capacity slots (``moe.py:153-250``).

    Float32 router, top-k and softmax; a stable sort of the (token,
    expert) pairs by expert; each expert's first :func:`capacity` pairs in
    ``(E, C, D)`` slots, the rest dropped; the slots' gate and up products
    on this rank's ``d_ff / model`` columns of every expert, the down
    product over those rows (a partial sum over ``d_ff``), invalid slots
    zeroed, the pairs scattered back and weighted by their gates, then one
    all-reduce of the ``(b·t, D)`` output over ``model`` (the ``psum``).
    The reference keeps the partial sums in the model dtype, so at model 2
    a bf16 sum rounds three times where the unsharded one rounds once, and
    the next layer's routing and capacity turn an ulp into dropped or kept
    pairs.  The port sums the bf16 products in float64 (their sums over
    ``d_ff`` are then independent of the order to far below a bf16 ulp) and
    casts once, after the all-reduce: model 2 equals model 1 at the layer's
    output.  Under autograd the region's inputs and output take
    ``sharding.copy_to`` and ``reduce_from`` (module docstring); the
    backward's partial cotangents are summed in float64 too.

    Pruning: the gate and up inputs are the slot tensor (per token, so the
    masks are the unsharded ones); the down input is each rank's ``F /
    model`` columns, groups of ``M`` within them, which equal the whole
    row's groups where ``M`` divides ``F / model`` (Qwen3-30B-A3B: 384 or
    192 columns, groups of 16).  The three slot contractions are batched
    products (``torch.bmm``), as the reference's einsums are XLA's."""
    b, t, d = x.shape
    xt = x.reshape(b * t, d)
    wg, wu, wd = _expert_shards(mesh, p.experts)
    n_exp = p.router.w.shape[-1]
    gates, expert_ids = route(xt, p.router.w, top_k)
    # the region of partial sums over model: its inputs' cotangents are
    # summed over model in the backward, its output's passed on unchanged
    xt, gates = sharding.copy_to(("model",), mesh, xt, gates)
    pairs = b * t * top_k
    flat_e = expert_ids.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(pairs, device=x.device))
    xs = xt.index_select(0, order // top_k)                      # (pairs, D)
    counts = torch.zeros(n_exp, dtype=torch.long, device=x.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    cap = capacity(b * t, top_k, n_exp)
    slot = torch.arange(cap, device=x.device)
    idx = offsets[:, None] + slot[None, :]                       # (E, C)
    valid = slot[None, :] < counts[:, None]
    idx_c = idx.clamp(0, pairs - 1).reshape(-1)
    xe = xs.index_select(0, idx_c).reshape(n_exp, cap, d)        # (E, C, D)

    xg = _maybe_prune(xe, "gate_proj", policy, phase)
    xu = _maybe_prune(xe, "up_proj", policy, phase)
    h = _act(torch.bmm(xg, wg), act_fn) * torch.bmm(xu, wu)     # (E, C, F/model)
    h = _maybe_prune(h, "down_proj", policy, phase)
    # the down product is a partial sum over this rank's F / model rows: it
    # is summed in float64 through the combine and the all-reduce and cast
    # once, so the result does not depend on how d_ff is split over ranks
    ye = torch.bmm(h.double(), wd.double()) * valid[..., None]  # (E, C, D)
    ys = torch.zeros(pairs, d, dtype=ye.dtype, device=x.device).index_add_(
        0, idx_c, ye.reshape(-1, d))
    y = ys.index_select(0, inv).reshape(b * t, top_k, d)
    y = torch.einsum("tkd,tk->td", y, gates.to(y.dtype))
    y = sharding.reduce_from(y, ("model",), mesh)
    shard_map_stats["calls"] += 1
    shard_map_stats["pairs"] += pairs
    if not counts.is_meta:      # a dry rank's routing has no values to count
        shard_map_stats["dropped"] += int(torch.clamp(counts - cap, min=0).sum())
    shard_map_stats["capacity"] = cap
    y = y.reshape(b, t, d).to(x.dtype)
    if p.shared is not None:
        y = y + mlp(x, p.shared, policy, phase, act_fn, layer_idx)
    return y
