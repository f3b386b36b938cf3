"""Tensor-parallel kernel sharding over ``torch.distributed`` (port of
``repro/distributed/tp.py``).

JAX runs one controller for every device; the port runs one process per
rank, and every rank runs the same host code (router, schedulers,
executors), which is deterministic, so every rank builds the same plans.
The serving executor opens a :func:`scope` on its process group around
every step; inside it the kernel wrappers (:mod:`repro_torch.kernels.ops`)
and the paged KV write and read (:mod:`repro_torch.models.attention`)
consult :func:`current` and shard themselves:

* the projection kernels (``nm_prune_matmul``, ``nm_spmm``,
  ``osparse_matmul``, ``w8a8_matmul``) shard **N_out**, column-parallel:
  every rank holds the full activations and a column slice of the weights
  (cut once per weight and kept, :func:`shard_columns`), computes its output
  columns as the unsharded kernel would, and :func:`gather` concatenates
  them in rank order.  No cross-rank reduction touches an accumulator.  The
  port's kernels pick their k split or key-walk split from the shape, and a
  narrower shard would pick another one and sum its float32 partials in
  another order, so the caller hands every shard the plan of the unsharded
  call; where a shard cannot take that plan's route (``fits``), the call
  falls through to the unsharded kernel, as for an axis that does not
  divide.  The result is **bit-identical** to the unsharded call.
* ``paged_attention`` and the KV scatter shard over **KV heads**.  Unlike
  the reference, which gathers the whole pools after every scatter, each
  rank's pools hold only its ``Hkv / tp`` heads (the executor sizes them,
  :func:`shards_kv`): the scatter writes those heads, attention reads them,
  and only attention's output is gathered.  Pools that hold every head (the
  heads do not divide: Granite-34B's one KV head) run the kernels unsharded.

Row-parallel layers stay unsharded, as in the reference: their reduction
would reorder float adds.

A cell (``launch/cells.py``) holds its column-parallel weights as shards
already (``distributed/sharding.tag`` sets ``held_cols``, the whole
tensor's columns): :func:`shard_columns` takes such a shard as it is, and
the wrappers plan for :func:`full_cols` columns, so the shard computes its
columns as the unsharded call would.

Backend and steps: the group is gloo on the CPU, and gloo where ranks share
one card (NCCL refuses two ranks of one communicator on one device).  Gloo
collectives cannot be captured in a CUDA graph, so an executor under a gloo
group runs every step eagerly (decided when it is built:
:func:`captures`).  :func:`gather` is the one collective helper; it counts
its calls and bytes in ``gather.calls`` / ``gather.bytes``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding

__all__ = ["TPScope", "scope", "current", "degree", "column_parallel",
           "head_sharded_attention", "head_sharded_scatter", "replica_groups",
           "gather", "shard_columns", "full_cols", "shards_kv", "captures", "size_of"]


@dataclasses.dataclass(frozen=True)
class TPScope:
    group: object          # a torch.distributed ProcessGroup
    rank: int
    size: int


_local = threading.local()


def current() -> Optional[TPScope]:
    """The active scope on this thread, or None."""
    return getattr(_local, "scope", None)


def degree() -> int:
    ctx = current()
    return ctx.size if ctx is not None else 1


@contextlib.contextmanager
def scope(group):
    """Activate a TP scope on ``group`` for the dynamic extent.  ``None`` (or
    a group of one rank) is a no-op scope, so callers wrap unconditionally."""
    if size_of(group) <= 1:
        yield None
        return
    prev = current()
    rank = group.index if sharding._is_dry(group) else dist.get_rank(group)
    _local.scope = TPScope(group, rank, size_of(group))
    try:
        yield _local.scope
    finally:
        _local.scope = prev


@contextlib.contextmanager
def _suspended():
    """Clear the scope while a shard runs: the per-shard kernel call must not
    re-enter the sharded branch."""
    prev = current()
    _local.scope = None
    try:
        yield
    finally:
        _local.scope = prev


def size_of(group) -> int:
    """The ranks of ``group`` (1 for None)."""
    if group is None:
        return 1
    return group.size if sharding._is_dry(group) else dist.get_world_size(group)


def captures(group) -> bool:
    """Whether an executor on ``group`` may capture its steps in CUDA graphs:
    not under gloo, whose collectives a graph cannot hold."""
    return size_of(group) <= 1 or dist.get_backend(group) != "gloo"


def gather(y: torch.Tensor, axis: int, ctx: TPScope) -> torch.Tensor:
    """All-gather ``y`` from every rank of ``ctx`` and concatenate the parts
    along ``axis`` in rank order.  Gloo takes CUDA tensors (it stages them
    through host memory itself), so the parts come back on ``y``'s device.
    On a dry rank's group (``sharding.DryGroup``) nothing runs: the parts
    are ``meta`` tensors of ``y``'s shape, and the gather is recorded."""
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(ctx.size)]
    if not sharding._is_dry(ctx.group):
        dist.all_gather(parts, y, group=ctx.group)
    gather.calls += 1
    gather.bytes += y.numel() * y.element_size() * ctx.size
    sharding.note("all_gather", y.numel() * y.element_size() * ctx.size, ctx.size,
                  getattr(ctx.group, "axes", ()))
    return torch.cat(parts, dim=axis % y.dim())


gather.calls = 0
gather.bytes = 0

# (id of the full tensor, rank, size) → (weak reference, version, shard)
_shards: dict = {}


def full_cols(c: torch.Tensor) -> int:
    """The columns of the whole tensor ``c`` is a held shard of (its own
    last dim otherwise)."""
    return getattr(c, "held_cols", c.shape[-1])


def shard_columns(c: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the last axis of ``c`` (``c`` itself if it
    is a held shard of ``size`` ranks).  A slice that is
    contiguous (a vector) or the contiguous transpose of a K-major int8
    weight (``core.quant.k_major``: its column block is a block of rows) is
    a view; a column slice of a row-major weight is strided, so it is copied
    once and kept while ``c`` lives and is not written in place."""
    if full_cols(c) == c.shape[-1] * size and size > 1:
        return c.detach()
    n = c.shape[-1] // size
    s = c.detach()[..., rank * n:(rank + 1) * n]
    if s.is_contiguous() or (s.dim() == 2 and s.t().is_contiguous()):
        return s
    key = (id(c), rank, size)
    hit = _shards.get(key)
    if hit is not None and hit[0]() is c and hit[1] == c._version:
        return hit[2]
    shard = s.contiguous()
    _shards[key] = (weakref.ref(c, lambda _, k=key: _shards.pop(k, None)), c._version, shard)
    return shard


def column_parallel(fn: Callable, cols: Sequence[Optional[torch.Tensor]], out_axis: int = -1,
                    fits: Optional[Callable] = None):
    """Run ``fn(*cols)`` column-parallel over the active scope.

    ``cols`` are the column-aligned operands (weights ``(K, N)``, biases and
    scales ``(N,)``); each is sharded along its last axis (:func:`
    shard_columns`).  Everything else (activations, K-aligned scales, the
    unsharded call's plan) is closed over by ``fn`` and replicated.  The
    shards' outputs are gathered along ``out_axis``, so the caller sees the
    full array, bit-identical to the unsharded call.  ``fits(*local)`` says
    whether the shard can take the unsharded call's plan.

    Returns None when no scope is active, a column axis does not divide, or
    the shard does not fit: callers fall through to the unsharded call.  A
    held shard has no unsharded call to fall through to: where it does not
    fit, this raises."""
    ctx = current()
    if ctx is None:
        return None
    real = [c for c in cols if c is not None]
    if not real or any(full_cols(c) % ctx.size for c in real):
        return None
    local = [None if c is None else shard_columns(c, ctx.rank, ctx.size) for c in cols]
    if fits is not None and not fits(*local):
        if any(full_cols(c) != c.shape[-1] for c in real):
            raise ValueError("a held column shard cannot take the unsharded call's plan")
        return None
    with _suspended():
        y = fn(*local)
    return gather(y, out_axis, ctx)


def shards_kv(hq: int, hkv: int, size: int) -> bool:
    """Whether pools of ``hkv`` heads (under ``hq`` query heads) shard over
    ``size`` ranks: the heads divide and the GQA ratio holds on a shard."""
    return size > 1 and hkv % size == 0 and hq % size == 0 \
        and (hq // size) % (hkv // size) == 0


def _heads(t: torch.Tensor, ctx: TPScope) -> torch.Tensor:
    h = t.shape[2] // ctx.size
    return t[:, :, ctx.rank * h:(ctx.rank + 1) * h].contiguous()


def head_sharded_attention(fn: Callable, q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, kv_heads: int):
    """``fn(q, k_pool, v_pool)``, a paged-attention call, on this rank's
    pools: ``q (B, T, Hq, hd)`` splits on its head axis, the pools hold this
    rank's ``kv_heads / size`` heads (``fn`` closes over the table, offsets
    and lengths, which replicate), and the outputs gather back along the
    head axis.  Per-head computation is exact, so the result is
    bit-identical.  Returns None when no scope is active or the pools hold
    every one of the ``kv_heads`` heads."""
    ctx = current()
    if ctx is None or k_pool.shape[2] == kv_heads:
        return None
    if k_pool.shape[2] * ctx.size != kv_heads or not shards_kv(q.shape[2], kv_heads, ctx.size):
        raise ValueError(f"pools of {k_pool.shape[2]} heads are neither all {kv_heads} KV "
                         f"heads nor a shard of them over {ctx.size} ranks")
    with _suspended():
        y = fn(_heads(q, ctx), k_pool, v_pool)
    return gather(y, 2, ctx)


def head_sharded_scatter(fn: Callable, k_new: torch.Tensor, v_new: torch.Tensor,
                         k_pool: torch.Tensor, v_pool: torch.Tensor):
    """``fn(k_new, v_new, k_pool, v_pool)``, a paged KV write, into this
    rank's pools: the new rows ``(B, T, Hkv, hd)`` split on their head axis
    and this rank's heads are written, in place (``fn`` closes over the
    table, positions and lengths); nothing is gathered (the pools stay
    head-sharded).  Returns the pools, or None when no scope is active or
    the pools hold every head."""
    ctx = current()
    if ctx is None or k_pool.shape[2] == k_new.shape[2]:
        return None
    if k_pool.shape[2] * ctx.size != k_new.shape[2]:
        raise ValueError(f"pools of {k_pool.shape[2]} heads are neither all "
                         f"{k_new.shape[2]} KV heads nor a shard of them over {ctx.size} "
                         "ranks")
    with _suspended():
        fn(_heads(k_new, ctx), _heads(v_new, ctx), k_pool, v_pool)
    return k_pool, v_pool


def replica_groups(mesh, dp: int) -> List:
    """The TP group of each of ``dp`` replicas on a serving mesh
    (:func:`repro_torch.launch.mesh.make_serving_mesh`): replicas run one
    after another inside each process (dp is host-level), so rank ``t``
    holds shard ``t`` of every replica and one group serves them all."""
    if mesh is None:
        return [None] * dp
    if mesh.dp < dp:
        raise ValueError(f"mesh data axis {mesh.dp} < dp={dp}")
    return [mesh.group] * dp
