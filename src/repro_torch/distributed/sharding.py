"""Partition rules and their runtime: DP (pod × data) × TP (model) for the
whole zoo (port of ``repro/distributed/sharding.py``).

The rules are the reference's, with the same **divisibility-aware
fallbacks** (a dim is sharded only when the mesh axis divides it: Whisper's
vocab of 51865 replicates its embedding rows; Granite-34B's single KV head
puts its cache on sequence instead of heads):

  * column-parallel (out-dim on model): q/k/v/gate/up, rwkv r/k/v/g,
    rg-lru in/gate, lm_head; biases of these follow the out-dim;
  * row-parallel (in-dim on model): o_proj, down_proj;
  * expert stacks split ``d_ff`` (gate/up on their last dim, down on its
    in-dim), never the expert axis;
  * everything else replicates.

A **spec** is a tuple with one entry per dimension: an axis name, a tuple
of names (the DP axes of a multi-pod mesh), or None.  The rules match a
tensor by its *trailing* path components (``_spec_for``), as the
reference's do; the port keeps one tensor per layer, so a port parameter
gets the reference leaf's spec with its leading stack axis removed.  The
port names the expert stacks ``moe.experts.gate_proj`` (no ``w``): the
path gains the reference's ``w`` before the rules read it.

A **mesh** (:class:`Mesh`) is a description: axis names and sizes, the
counterpart of ``jax.sharding.AbstractMesh``, so the specs of the full
configs are computed here on ``meta`` tensors.  Bound to an initialised
``torch.distributed`` group (``launch.mesh.make_cell_mesh``), it also knows
this process's rank, hence its coordinates (row-major over the axes), and
one subgroup per set of axes.  A **dry rank** (:meth:`Mesh.at`) is a
description given one rank's coordinates and subgroups of
:class:`DryGroup`: it runs the code of a bound rank on ``meta`` tensors,
and each collective returns a ``meta`` result of the real one's shape and
is recorded, never run (the dry-run, ``launch/dryrun.py``).
:func:`mesh_scope` is ``with mesh:``; :func:`_context_mesh` reads it.

The runtime, for the cells (``launch/cells.py``):

* a rank holds only its shard of each tensor (:func:`local`); the shard is
  tagged with its spec and mesh (:func:`tag`), so whatever meets it can
  find the rest;
* :func:`gathered` swaps a module's shards for the whole tensors for the
  extent of a block (one layer at a time), through :func:`gather_param`,
  whose backward reduces the gradient over the DP axes and keeps this
  rank's slice of it;
* collectives run over gloo, split across a subgroup's lanes (parallel
  groups of the same ranks, ``launch.mesh.LANES``); a gather is a sum of
  zero-padded wholes and a reduce-scatter an all-reduce and a slice, which
  gloo runs faster than its own (PERF.md, section 6);
* :func:`head_local` runs attention on this rank's KV heads of a
  head-sharded cache and gathers the output; :func:`head_state_local`
  runs a recurrence on this rank's heads of a head-sharded state (RWKV6's
  ``S``) and gathers its output.

``maybe_shard`` (``transformer.py:247-250, 452-524, 592-602`` of the
reference) is a GSPMD layout hint that changes no value; the port has no
partitioner to hint, so it has no counterpart.  ``shard_zero1`` gives the
slice spec of the reference's constraint (the caller slices).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "Mesh", "NamedSharding", "data_axes", "param_specs", "batch_spec", "cache_specs",
    "opt_state_specs", "shard_zero1", "named", "mesh_scope", "local", "gather",
    "gather_param", "gather_data", "gather_to_root", "all_reduce", "reduce_slice", "copy_to",
    "reduce_from", "tag", "full_shape", "grad_spec", "param_grad_spec",
    "model_dim", "gathered", "head_local", "head_state_local", "fresh_head_state",
    "whole_sequence", "is_sharded",
    "sharded",
    "effective", "collectives", "DryGroup", "recording",
]

Spec = Tuple[Any, ...]

# module names whose weight is column-parallel (shard trailing dim)
_COL = {
    "q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head",
    "r_proj", "k_proj_tm", "v_proj_tm", "g_proj", "gate_a", "gate_x",
}
# row-parallel (shard the d_in dim, i.e. dim -2)
_ROW = {"o_proj", "down_proj"}


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """A subgroup of a dry rank: the axes it spans, its members (global
    ranks, in order) and this rank's place among them.  Nothing runs on it."""
    axes: Tuple[str, ...]
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def _is_dry(group) -> bool:
    return isinstance(group, DryGroup)


def _group_rank(group) -> int:
    return group.index if _is_dry(group) else dist.get_rank(group)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and sizes; bound (``groups`` set) it is this process's
    place in an initialised group: ``rank`` and, per tuple of axes (in mesh
    order), the lanes of the subgroup over them that holds this rank: groups
    of the same ranks that a large collective is split across (None for a
    subgroup of one rank).  ``dry``: a dry rank (:meth:`at`), whose lanes
    are one :class:`DryGroup` each."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: Optional[int] = None
    groups: Optional[Dict[Tuple[str, ...], Any]] = None
    dry: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def bound(self) -> bool:
        return self.groups is not None

    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis (row-major over the axes)."""
        out, r = {}, self.rank
        for name, n in reversed(tuple(zip(self.axis_names, self.sizes))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def lanes(self, axes: Tuple[str, ...]):
        """The lanes of the subgroup over ``axes`` that holds this rank
        (None: one rank)."""
        if not self.bound:
            raise ValueError(f"mesh {self.shape} is a description: bind it to a group "
                             "(repro_torch.launch.mesh.make_cell_mesh) before it runs")
        return self.groups[tuple(a for a in self.axis_names if a in axes)]

    def group(self, axes: Tuple[str, ...]):
        """The subgroup over ``axes`` that holds this rank (None: one rank)."""
        lanes = self.lanes(axes)
        return None if lanes is None else lanes[0]

    def members(self, axes: Tuple[str, ...], rank: int) -> Tuple[int, ...]:
        """The global ranks of the subgroup over ``axes`` that holds
        ``rank``: those that share its coordinates on every other axis."""
        mine = dataclasses.replace(self, rank=rank).coords()
        spans = [range(n) if a in axes else (mine[a],)
                 for a, n in zip(self.axis_names, self.sizes)]
        out = []
        for c in itertools.product(*spans):          # row-major, as ranks are
            r = 0
            for i, n in zip(c, self.sizes):
                r = r * n + i
            out.append(r)
        return tuple(out)

    def at(self, rank: int) -> "Mesh":
        """This description as dry rank ``rank``: its coordinates, and per
        tuple of axes a :class:`DryGroup` (None for one rank).  A bound
        mesh cannot be made dry."""
        if self.bound:
            raise ValueError(f"mesh {self.shape} is bound to ranks; only a description "
                             "takes a dry rank")
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on mesh {self.shape}")
        names, groups = self.axis_names, {}
        for bits in range(1, 2 ** len(names)):
            sub = tuple(a for i, a in enumerate(names) if bits >> i & 1)
            if math.prod(self.shape[a] for a in sub) == 1:
                groups[sub] = None
                continue
            ranks = self.members(sub, rank)
            groups[sub] = (DryGroup(sub, ranks, ranks.index(rank)),)
        return dataclasses.replace(self, rank=rank, groups=groups, dry=True)

    def __repr__(self) -> str:
        tail = "" if self.rank is None else f", {'dry ' if self.dry else ''}rank {self.rank}"
        return f"Mesh({self.shape}{tail})"


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""
    mesh: Mesh
    spec: Spec


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The DP axes: ("pod", "data") on a multi-pod mesh, else ("data",)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _dp(mesh: Mesh):
    dp = data_axes(mesh)
    return dp, math.prod(mesh.shape[a] for a in dp), (dp if len(dp) > 1 else
                                                      (dp[0] if dp else None))


def _div(n: int, mesh: Mesh, axis: str) -> bool:
    return n % mesh.shape[axis] == 0


def _spec_for(path: Tuple[str, ...], shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    names = list(path)
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""
    nd = len(shape)
    none = (None,) * nd

    def shard_dim(i: int) -> Spec:
        if not _div(shape[i], mesh, "model"):
            return none
        out = list(none)
        out[i] = "model"
        return tuple(out)

    if parent == "embed" and leaf == "w":
        # (V, d): prefer vocab sharding, fall back to d_model
        return shard_dim(0) if _div(shape[0], mesh, "model") else shard_dim(1)
    if gparent == "experts" or (len(names) >= 4 and names[-4] == "experts"):
        if parent in _COL:
            return shard_dim(nd - 1)
        if parent in _ROW:
            return shard_dim(nd - 2)
        return none
    if leaf == "w" and parent in _COL and nd >= 2:
        return shard_dim(nd - 1)
    if leaf == "w" and parent in _ROW and nd >= 2:
        return shard_dim(nd - 2)
    if leaf == "b" and parent in _COL:
        return shard_dim(nd - 1)
    if leaf == "amber_scale" and parent in _ROW:
        return shard_dim(nd - 1)
    return none


def _path(name: str) -> Tuple[str, ...]:
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "experts":
        parts.append("w")
    return tuple(parts)


def _named_tensors(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _first_free(spec: Spec, shape, n: int) -> Optional[int]:
    """The largest dim still unsharded that ``n`` divides (ties: the first)."""
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] % n == 0 and shape[i] >= n:
            return i
    return None


def param_specs(params, mesh: Mesh, n_experts: int = 0, fsdp: bool = False
                ) -> Dict[str, Spec]:
    """``{name: spec}`` of every parameter of ``params`` (a module, or a
    ``{name: tensor}`` dict; ``meta`` tensors will do).  ``fsdp=True``
    also shards each tensor's largest still-free dim over the DP axes
    (ZeRO-3: a train cell's weights live fully sharded and are gathered a
    layer at a time on use).  ``n_experts`` is the reference's argument,
    which its rules do not read either."""
    dp, dp_size, dp_entry = _dp(mesh)
    out = {}
    for name, t in _named_tensors(params).items():
        spec = _spec_for(_path(name), tuple(t.shape), mesh)
        if fsdp and dp_entry is not None:
            i = _first_free(spec, t.shape, dp_size)
            if i is not None:
                spec = spec[:i] + (dp_entry,) + spec[i + 1:]
        out[name] = spec
    return out


def batch_spec(mesh: Mesh) -> Spec:
    """Token batches: batch dim over all DP axes."""
    return (_dp(mesh)[2],)


def _map_tree(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def cache_specs(cache: Any, cfg, mesh: Mesh) -> Any:
    """The cache's tree with a spec at every tensor: batch on DP; K/V heads
    on model when divisible, else the sequence (context parallelism); an
    RWKV6 state's heads on model when divisible.  Layouts (the dense cache
    of ``models/transformer.py``, per layer): k/v ``(B, S, Hkv, hd)``,
    ``S`` ``(B, H, hd, hd)``, states ``(B, d)``, conv ``(B, cw-1, d)``."""
    _, dp_size, dp_entry = _dp(mesh)
    model = mesh.shape["model"]

    def visit(path, leaf):
        name = path[-1]
        nd = leaf.dim()
        if name == "pos":
            return ()
        spec = [None] * nd

        def set_batch(i):
            if leaf.shape[i] % dp_size == 0 and leaf.shape[i] >= dp_size:
                spec[i] = dp_entry

        if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
            set_batch(nd - 4)
            s_dim, h_dim = nd - 3, nd - 2
            if cfg.n_kv_heads and leaf.shape[h_dim] % model == 0 \
                    and leaf.shape[h_dim] >= model:
                spec[h_dim] = "model"
            elif leaf.shape[s_dim] % model == 0 and leaf.shape[s_dim] >= model:
                spec[s_dim] = "model"
        elif name == "S":
            set_batch(nd - 4)
            if leaf.shape[nd - 3] % model == 0:
                spec[nd - 3] = "model"
        elif name in ("tm_shift", "cm_shift", "h"):
            set_batch(nd - 2)
        elif name == "conv":
            set_batch(nd - 3)
        return tuple(spec)

    return _map_tree(visit, cache)


def _widen(spec: Spec, shape, mesh: Mesh) -> Spec:
    dp, dp_size, dp_entry = _dp(mesh)
    flat = [a for s in spec for a in (s if isinstance(s, tuple) else (s,))]
    if any(a in flat for a in dp):
        return spec
    i = _first_free(spec, shape, dp_size)
    return spec if i is None else spec[:i] + (dp_entry,) + spec[i + 1:]


def opt_state_specs(pspecs: Dict[str, Spec], params=None, mesh: Optional[Mesh] = None
                    ) -> Dict[str, Any]:
    """AdamW's state specs: ZeRO-1 given shapes and a mesh.  ``mu``/``nu``
    start from each parameter's spec, then shard the largest still-free
    dim over the DP axes where it divides (unless the parameter is already
    DP-sharded: FSDP).  A dim whose entry names only axes of size 1 is free
    (``effective``): the optimizer slices it as it does a dim no axis
    names (``train/optimizer.moment_spec`` reads the held spec, and a
    parameter no axis cuts is held whole, untagged)."""
    if params is None or mesh is None:
        return {"mu": dict(pspecs), "nu": dict(pspecs), "step": ()}
    shapes = {k: tuple(t.shape) for k, t in _named_tensors(params).items()}
    moments = {k: _widen(s if sharded(s, mesh) else effective(s, mesh), shapes[k], mesh)
               for k, s in pspecs.items()}
    return {"mu": moments, "nu": dict(moments), "step": ()}


def shard_zero1(shape, mesh: Optional[Mesh] = None) -> Optional[Spec]:
    """The spec of the reference's ZeRO constraint on a tensor of ``shape``
    (the float32 gradient accumulator, the update's float32 copy): its
    largest dim that the DP degree divides, over the DP axes; every other
    dim, ``model`` included, whole.  None off-mesh or with no DP axis;
    all None where no dim divides."""
    mesh = mesh or _context_mesh()
    if mesh is None:
        return None
    dp, dp_size, dp_entry = _dp(mesh)
    if not dp:
        return None
    spec = (None,) * len(shape)
    i = _first_free(spec, shape, dp_size) if len(shape) else None
    return spec if i is None else spec[:i] + (dp_entry,) + spec[i + 1:]


def named(mesh: Mesh, spec_tree: Any) -> Any:
    """Each spec of ``spec_tree`` on ``mesh`` (:class:`NamedSharding`)."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named(mesh, v) for v in spec_tree]
    return NamedSharding(mesh, spec_tree)


# ------------------------------------------------------------------ the scope

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class _Scope:
    mesh: Mesh
    batch_shards: int


@contextlib.contextmanager
def mesh_scope(mesh: Mesh, batch_shards: int = 1):
    """``with mesh:`` of the reference for the dynamic extent, on this
    thread.  ``batch_shards``: how many pieces the caller cut the batch
    into over the DP axes before the model saw it (1: every DP rank holds
    the whole batch), so a layer can tell the global batch."""
    prev = getattr(_local, "scope", None)
    _local.scope = _Scope(mesh, batch_shards)
    try:
        yield mesh
    finally:
        _local.scope = prev


def _context_mesh() -> Optional[Mesh]:
    """The mesh of an enclosing :func:`mesh_scope`, or None."""
    s = getattr(_local, "scope", None)
    return None if s is None else s.mesh


def _batch_shards() -> int:
    s = getattr(_local, "scope", None)
    return 1 if s is None else s.batch_shards


# -------------------------------------------------------------- collectives

# calls and bytes of each collective this module issued (every rank counts
# its own), read by the cells' reports
collectives = {"all_gather": [0, 0], "all_reduce": [0, 0]}

# where :func:`recording` is open: (kind, result bytes, group size, axes) of
# every collective run or recorded, this module's and ``distributed.tp.gather``'s;
# module-wide, since a remat recompute runs in the autograd thread
_log: Optional[list] = None


@contextlib.contextmanager
def recording():
    """Record every collective of the extent: yields the list of
    ``(kind, result bytes, group size, axes)`` it fills."""
    global _log
    prev, _log = _log, []
    try:
        yield _log
    finally:
        _log = prev


def note(kind: str, nbytes: int, size: int, axes: Tuple[str, ...]) -> None:
    """Add one collective to the open :func:`recording`, if any."""
    if _log is not None:
        _log.append((kind, int(nbytes), int(size), tuple(axes)))


def _lanes_axes(lanes) -> Tuple[str, ...]:
    return lanes[0].axes if _is_dry(lanes[0]) else ()


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def _pieces(entry, mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in _axes(entry))


def _index(entry, mesh: Mesh) -> int:
    """This rank's shard index along an entry's axes (row-major)."""
    c, i = mesh.coords(), 0
    for a in _axes(entry):
        i = i * mesh.shape[a] + c[a]
    return i


def local(t: torch.Tensor, spec: Optional[Spec], mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``spec`` (a view)."""
    for i, e in enumerate(spec or ()):
        n = _pieces(e, mesh)
        if n > 1:
            size = t.shape[i] // n
            t = t.narrow(i, _index(e, mesh) * size, size)
    return t


@torch.no_grad()
def _sum_in_lanes(t: torch.Tensor, lanes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` (contiguous) summed (or reduced by ``op``) over a subgroup's
    ranks in place, split into one piece per lane (at least 1 MiB each), the
    pieces reduced at once."""
    if _is_dry(lanes[0]):
        return t
    flat = t.view(-1)
    pieces = max(1, min(len(lanes), flat.numel() * flat.element_size() // 2**20))
    works = [dist.all_reduce(c, op=op, group=g, async_op=True)
             for c, g in zip(flat.chunk(pieces), lanes)]
    for w in works:
        w.wait()
    return t


def _all_gather(t: torch.Tensor, lanes, n: int, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order.  Gloo
    all-gathers at a third of its all-reduce's rate (PERF.md), so
    each rank writes its part into a zeroed whole and the wholes are summed:
    adding zeros is exact."""
    whole = t.new_zeros((n,) + tuple(t.shape))
    whole[_group_rank(lanes[0])] = t.detach()
    _sum_in_lanes(whole, lanes)
    collectives["all_gather"][0] += 1
    collectives["all_gather"][1] += whole.numel() * whole.element_size()
    note("all_gather", whole.numel() * whole.element_size(), n, _lanes_axes(lanes))
    return torch.cat(whole.unbind(0), dim=dim)


def gather(t: torch.Tensor, spec: Optional[Spec], mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's :func:`local` slice of it."""
    for i, e in enumerate(spec or ()):
        n = _pieces(e, mesh)
        if n > 1:
            t = _all_gather(t, mesh.lanes(_axes(e)), n, i)
    return t


def _p2p(t: torch.Tensor, lanes, peer: int, send: bool) -> None:
    """Send ``t`` (contiguous) to global rank ``peer``, or receive it from
    there, in one piece per lane (at least 1 MiB each), the pieces at once."""
    if _is_dry(lanes[0]):
        return
    flat = t.view(-1)
    pieces = max(1, min(len(lanes), flat.numel() * flat.element_size() // 2**20))
    op = dist.isend if send else dist.irecv
    for w in [op(c, peer, group=g) for c, g in zip(flat.chunk(pieces), lanes)]:
        w.wait()


@torch.no_grad()
def gather_to_root(t: torch.Tensor, spec: Optional[Spec], mesh: Mesh) -> Optional[torch.Tensor]:
    """The whole tensor in host memory on the mesh's rank 0 (None on the
    others), for a checkpoint: every other rank sends its slice to rank 0
    once, point to point, where a gather would send it to every rank.
    Gloo sends host memory only, so the slices go through it.  The mesh
    spans the whole group (``launch.mesh.make_cell_mesh``), so its ranks are
    the group's.  A dry rank keeps ``meta`` tensors where they are."""
    t = t.detach().contiguous()
    if not mesh.dry:
        t = t.cpu()
    if not sharded(spec, mesh):
        return t if mesh.rank == 0 else None
    lanes = mesh.lanes(mesh.axis_names)
    if mesh.rank != 0:
        _p2p(t, lanes, 0, send=True)
        return None
    whole = t.new_empty(tuple(n * _pieces(e, mesh) for n, e in zip(t.shape, spec)))
    buf = torch.empty_like(t)
    for r in range(mesh.size):
        if r:
            _p2p(buf, lanes, r, send=False)
        local(whole, spec, dataclasses.replace(mesh, rank=r)).copy_(buf if r else t)
    collectives["all_gather"][0] += 1
    collectives["all_gather"][1] += whole.numel() * whole.element_size()
    note("gather_to_root", whole.numel() * whole.element_size(), mesh.size, mesh.axis_names)
    return whole


def reduce_slice(t: torch.Tensor, axes: Tuple[str, ...], spec: Optional[Spec], mesh: Mesh
                 ) -> torch.Tensor:
    """``t`` summed over the ranks of ``axes``, then this rank's slice under
    ``spec`` (whose entries name only ``axes``): the reduce-scatter of a
    gradient.  Gloo's all-reduce, split across lanes, outruns its
    reduce-scatter, so this is an all-reduce and the slice."""
    return local(all_reduce(t.contiguous(), axes, mesh), spec, mesh)


def all_reduce(t: torch.Tensor, axes: Tuple[str, ...], mesh: Mesh, op: str = "sum"
               ) -> torch.Tensor:
    """Sum ``t`` (contiguous) over the ranks of ``axes`` in place (the
    ``psum``; ``op="max"``: the ``pmax``)."""
    n = math.prod(mesh.shape[a] for a in axes)
    if n > 1:
        lanes = mesh.lanes(axes)
        _sum_in_lanes(t, lanes, dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
        collectives["all_reduce"][0] += 1
        collectives["all_reduce"][1] += t.numel() * t.element_size()
        note("all_reduce", t.numel() * t.element_size(), n, _lanes_axes(lanes))
    return t


# ------------------------------------------------------------- held shards

def effective(spec: Optional[Spec], mesh: Mesh) -> Spec:
    """``spec`` with every entry that cuts nothing on ``mesh`` (an axis of
    size 1) made None: two specs that slice alike compare equal."""
    return tuple(e if _pieces(e, mesh) > 1 else None for e in spec or ())


def sharded(spec: Optional[Spec], mesh: Mesh) -> bool:
    """Whether ``spec`` cuts anything on ``mesh`` (an axis of size 1 does not)."""
    return any(_pieces(e, mesh) > 1 for e in spec or ())


def tag(t: torch.Tensor, spec: Spec, mesh: Mesh, shape) -> torch.Tensor:
    """Mark ``t`` as this rank's slice of a tensor of ``shape`` under
    ``spec``; a slice of the last dim over ``model`` alone is also a
    column shard that ``distributed.tp.column_parallel`` takes as it is
    (``held_cols``: the whole tensor's columns).  Returns ``t``."""
    t._shard = (tuple(spec), mesh, tuple(shape))
    col = tuple(None for _ in spec[:-1]) + ("model",)
    if len(spec) and tuple(spec) == col:
        t.held_cols = shape[-1]
    return t


def model_dim(t: torch.Tensor) -> Optional[int]:
    """The dim of a tagged shard that ``model`` cuts (None: none does)."""
    tg = getattr(t, "_shard", None)
    if tg is None:
        return None
    spec, mesh, _ = tg
    return next((i for i, e in enumerate(spec)
                 if "model" in _axes(e) and _pieces(e, mesh) > 1), None)


def full_shape(t: torch.Tensor) -> Tuple[int, ...]:
    tg = getattr(t, "_shard", None)
    return tuple(t.shape) if tg is None else tg[2]


def is_sharded(module: torch.nn.Module) -> bool:
    """Whether ``module`` holds shards (a cell's materialized weights)."""
    return getattr(module, "_holds_shards", False)


class _Gather(torch.autograd.Function):
    """The whole tensor from this rank's shard, or (``data_only``) the
    tensor gathered over the DP axes alone, this rank's ``model`` shard of
    it kept.  Backward: the gradient summed over the DP axes (each DP rank
    saw its own batch) and cut to this rank's slice: the shard's own, or,
    where the train step hung an accumulator on the shard (``_zero2``:
    ``(acc, key, divisor)``), divided by ``divisor`` and added to
    ``acc[key]`` (ZeRO-2; the shard then gets no gradient).  A whole
    gradient pays ``shard_zero1``'s slice in; a ``data_only`` one, whose
    ``model`` slices differ from rank to rank, pays the shard's own slice,
    tagged with the shard's spec (:func:`grad_spec` reads it)."""

    @staticmethod
    def forward(ctx, shard, spec, mesh, data_only=False):
        ctx.spec, ctx.mesh, ctx.data_only = spec, mesh, data_only
        ctx.sink = getattr(shard, "_zero2", None)
        ctx.tag = shard._shard
        return gather(shard, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        dp, mesh = data_axes(ctx.mesh), ctx.mesh
        if ctx.sink is None:
            return reduce_slice(g, dp, ctx.spec, mesh).contiguous(), None, None, None
        acc, key, n = ctx.sink
        if ctx.data_only:
            z = reduce_slice(g.float(), dp, ctx.spec, mesh).contiguous() / n
            tag(z, *ctx.tag)
        else:
            z = reduce_slice(g, dp, shard_zero1(g.shape, mesh), mesh).float() / n
        acc[key] = z if key not in acc else acc[key].add_(z)
        return None, None, None, None


def gather_param(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a tagged shard (autograd-aware); ``t`` itself if
    it is not tagged."""
    tg = getattr(t, "_shard", None)
    if tg is None:
        return t
    spec, mesh, _ = tg
    if t.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(t, spec, mesh)
    return gather(t.detach(), spec, mesh)


def gather_data(t: torch.Tensor) -> torch.Tensor:
    """A tagged shard gathered over the DP axes alone (autograd-aware): the
    ``model`` cut stays, as ``models/moe._moe_shard_map`` reads an expert
    stack that a train cell holds FSDP-style (``param_specs(fsdp=True)``:
    ``D`` on the DP axes, ``d_ff`` on ``model``).  Its backward sums the
    gradient over the DP axes onto this rank's shard or pays it into the
    ZeRO-2 accumulator (:class:`_Gather`), also where no DP axis cuts the
    shard.  ``t`` itself if it is not tagged."""
    tg = getattr(t, "_shard", None)
    if tg is None:
        return t
    spec, mesh, _ = tg
    dp = set(data_axes(mesh))
    dspec = tuple(e if _axes(e) and set(_axes(e)) <= dp else None for e in spec)
    if t.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(t, dspec, mesh, True)
    return gather(t.detach(), dspec, mesh)


def grad_spec(g: torch.Tensor, shape, mesh: Mesh) -> Spec:
    """The spec of the ZeRO-2 accumulator's slice ``g`` of a gradient of
    ``shape``: the one a ``data_only`` gather tagged it with, else
    ``shard_zero1``'s."""
    tg = getattr(g, "_shard", None)
    return tg[0] if tg is not None else shard_zero1(shape, mesh)


def param_grad_spec(name: str, p: torch.Tensor, mesh: Mesh) -> Spec:
    """The spec of the ZeRO-2 slice the train step pays the gradient of
    parameter ``name`` into, before any gradient exists: a held expert
    stack's own shard (``models/moe`` gathers it with :func:`gather_data`),
    else ``shard_zero1``'s of the whole shape."""
    tg = getattr(p, "_shard", None)
    if tg is not None and ".moe.experts." in name:
        return tg[0]
    return shard_zero1(full_shape(p), mesh)


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward; backward all-reduces each cotangent
    over ``axes`` (in float64, cast back once)."""

    @staticmethod
    def forward(ctx, axes, mesh, *ts):
        ctx.axes, ctx.mesh = axes, mesh
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(
            None if g is None else
            all_reduce(g.double().contiguous(), ctx.axes, ctx.mesh).to(g.dtype) for g in gs)


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: all-reduce forward; backward passes the cotangent on
    unchanged (every rank already holds the whole of it)."""

    @staticmethod
    def forward(ctx, t, axes, mesh):
        return all_reduce(t.contiguous().clone(), axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(axes: Tuple[str, ...], mesh: Mesh, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The inputs ``ts`` of a region whose ranks over ``axes`` each compute
    a partial sum from them (the row-parallel half of a layer): the same
    tensors, whose cotangents, partial on each rank, are summed over
    ``axes`` in the backward (one all-reduce each).  Off autograd, ``ts``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _CopyTo.apply(axes, mesh, *ts)
    return ts


def reduce_from(t: torch.Tensor, axes: Tuple[str, ...], mesh: Mesh) -> torch.Tensor:
    """The output of such a region: ``t`` summed over ``axes``; its
    backward passes the cotangent through unchanged (an all-reduce there
    would multiply every gradient by the axes' size).  Off autograd, the
    in-place :func:`all_reduce`."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _ReduceFrom.apply(t, axes, mesh)
    return all_reduce(t.contiguous(), axes, mesh)


def _owner(module: torch.nn.Module, name: str):
    *path, leaf = name.split(".")
    for p in path:
        module = getattr(module, p)
    return module, leaf


@contextlib.contextmanager
def gathered(module: torch.nn.Module, keep: Tuple[str, ...] = ()):
    """Swap every tagged shard of ``module`` for the whole tensor for the
    extent (a layer at a time: the whole tensors are freed when it ends,
    unless autograd saved them), except the tensors under the names in
    ``keep`` (prefixes), which are used as shards."""
    swaps = []
    for name, t in module.named_parameters():
        if getattr(t, "_shard", None) is None or any(
                name == k or name.startswith(k + ".") for k in keep):
            continue
        owner, leaf = _owner(module, name)
        swaps.append((owner, leaf, t))
    try:
        for owner, leaf, t in swaps:
            owner._parameters[leaf] = gather_param(t)
        yield
    finally:
        for owner, leaf, t in swaps:
            owner._parameters[leaf] = t


def head_local(fn: Callable, q: torch.Tensor, k: Optional[torch.Tensor],
               v: Optional[torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` on this rank's KV heads of the head-sharded cache
    ``buf`` (tagged, heads on ``model``): q/k/v ``(B, T, H, hd)`` keep this
    rank's heads (k and v may be None: ``fn`` reads only the cache's), ``fn``
    writes and reads the cache's, and the outputs gather back along the head
    axis.  Per-head attention is exact."""
    spec, mesh, shape = buf._shard
    e = spec[2]
    n, i = _pieces(e, mesh), _index(e, mesh)
    hq, hk = q.shape[2] // n, shape[2] // n

    def mine(t):
        return None if t is None else t[:, :, i * hk:(i + 1) * hk]

    o = fn(q[:, :, i * hq:(i + 1) * hq], mine(k), mine(v))
    return _all_gather(o.contiguous(), mesh.lanes(_axes(e)), n, 2)


class _HeadSlice(torch.autograd.Function):
    """This rank's ``n``-th piece ``i`` of ``t`` along ``dim`` (its heads);
    backward: the pieces' cotangents gathered whole along ``dim`` (each
    rank's covers its own heads), so every rank holds the whole cotangent,
    as it holds the whole input."""

    @staticmethod
    def forward(ctx, t, dim, lanes, n, i):
        ctx.dim, ctx.lanes, ctx.n = dim, lanes, n
        size = t.shape[dim] // n
        return t.narrow(dim, i * size, size).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.lanes, ctx.n, ctx.dim), None, None, None, None


class _HeadGather(torch.autograd.Function):
    """Every rank's heads' output ``(B, T, h, ...)`` gathered along the head
    axis; backward: the cotangent's slice of this rank's heads."""

    @staticmethod
    def forward(ctx, y, lanes, n, i):
        ctx.i, ctx.h = i, y.shape[2]
        return _all_gather(y.contiguous(), lanes, n, 2)

    @staticmethod
    def backward(ctx, g):
        return g[:, :, ctx.i * ctx.h:(ctx.i + 1) * ctx.h].contiguous(), None, None, None


def head_state_local(fn: Callable, state: torch.Tensor, *xs: torch.Tensor,
                     per_head: Tuple[torch.Tensor, ...] = ()):
    """``fn(state, *xs, *per_head)`` on this rank's heads of the recurrent
    state ``state`` ``(B, H, N, N)``, held on its heads (tagged, heads on
    ``model``; RWKV6's ``S``): each of ``xs`` ``(B, T, H·N)`` keeps this
    rank's heads' features, each of ``per_head`` ``(H, ...)`` its rows, and
    ``fn`` gets the shard itself (untagged).  ``fn`` returns (the rank's new
    state, its output ``(B, T, h·N)`` for its ``h`` heads); the output
    gathers back along the head axis → (the new state shard, the whole
    output ``(B, T, H·N)``).  The per-head recurrence is exact.  Under
    autograd (a train cell) the output's gather passes back the cotangent
    of this rank's heads, and each input's slice gathers its cotangent
    whole again (every rank computed the inputs whole).  On a dry rank the
    gathers are recorded, not run."""
    spec, mesh, shape = state._shard
    e = spec[1]
    n, i = _pieces(e, mesh), _index(e, mesh)
    lanes = mesh.lanes(_axes(e))
    h = shape[1] // n
    w = xs[0].shape[-1] // shape[1] * h
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in xs + per_head)

    def mine(t, dim):
        if grad:
            return _HeadSlice.apply(t, dim, lanes, n, i)
        size = t.shape[dim] // n
        return t.narrow(dim, i * size, size)

    new, y = fn(state[:], *(mine(x, x.dim() - 1) for x in xs), *(mine(p, 0) for p in per_head))
    b, t = y.shape[:2]
    y = y.reshape(b, t, h, -1)
    y = _HeadGather.apply(y, lanes, n, i) if grad and y.requires_grad else \
        _all_gather(y.contiguous(), lanes, n, 2)
    return new, y.reshape(b, t, -1)


def fresh_head_state(batch: int, n_heads: int, head_dim: int, device) -> Optional[torch.Tensor]:
    """A zero RWKV6 ``S`` ``(batch, H, N, N)`` for a pass without a cache (a
    train cell's forward) held on its heads as a cell holds its cache's
    (``cache_specs``): this rank's ``H / model`` heads, tagged, so that the
    recurrence runs on them (:func:`head_state_local`).  None off a mesh or
    where ``model`` does not divide the heads (the recurrence runs whole)."""
    mesh = _context_mesh()
    if mesh is None or not mesh.bound or "model" not in mesh.shape:
        return None
    m = mesh.shape["model"]
    if m == 1 or n_heads % m:
        return None
    spec = (None, "model", None, None)
    s = torch.zeros(batch, n_heads // m, head_dim, head_dim, dtype=torch.float32, device=device)
    return tag(s, spec, mesh, (batch, n_heads, head_dim, head_dim))


@contextlib.contextmanager
def whole_sequence(layer: Dict[str, torch.Tensor], names: Tuple[str, ...] = ("k", "v")):
    """A sequence-sharded cache layer's ``names`` gathered whole for the
    extent (the caller writes and reads them), then this rank's rows
    written back: the cache of Granite-34B and RecurrentGemma-2B, whose one
    KV head cannot split, or of heads a model axis does not divide."""
    shards = {n: layer[n] for n in names}
    spec, mesh, _ = shards[names[0]]._shard
    model = tuple(None if "model" not in _axes(e) else e for e in spec)
    whole = {n: gather(t, model, mesh) for n, t in shards.items()}
    try:
        yield whole
    finally:
        for n, t in shards.items():
            t.copy_(local(whole[n], model, mesh))
