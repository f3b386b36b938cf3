"""The meshes of the port (port of ``repro/launch/mesh.py``) and
:func:`spawn`, which starts the ranks.

Two kinds of mesh.  The **serving mesh** (``make_mesh_auto``,
``make_serving_mesh``) keeps ``data`` host-level, as below.  The **cell
mesh** (:func:`make_cell_mesh`) is a :class:`~repro_torch.distributed.
sharding.Mesh` bound to ``data × model`` (× ``pod``) ranks, one process
each, with one subgroup per set of axes: the layout of the sharded cells
(``launch/cells.py``).  :func:`abstract_mesh`, :func:`make_production_mesh`
(16 × 16 and 2 × 16 × 16) and :func:`make_local_mesh` are descriptions,
bound to nothing, from which the specs of the full configs are computed.

JAX runs one controller over every device; the port runs one process per
tensor-parallel rank, in one ``torch.distributed`` group of ``tp`` ranks.
``dp`` stays host-level inside each process: the router's replicas run one
after another, and rank ``t`` holds shard ``t`` of every replica
(``distributed/tp.replica_groups``).  So a ``(dp, tp)`` mesh needs a group
of world size ``tp``, and :func:`make_mesh_auto` raises ``ValueError`` up
front, naming the fix, when there is none or its size differs.

:func:`spawn` starts ``tp`` ranks with ``torch.multiprocessing`` (the
``spawn`` method) on a file store in a fresh directory, so no TCP port is
fixed and parallel runs cannot collide; the CLI (``--tp``), the tests and
``chip_smoke.py`` all use it.  The backend is chosen up front from where
the ranks live (:func:`layout`) and printed: gloo on the CPU, and gloo
where ranks share one card, since NCCL refuses two ranks of one
communicator on one device.  NCCL, with one rank per card and steps
captured as CUDA graphs, is not written yet; until it is, ranks on cards of
their own also use gloo.  Under gloo the executors run their steps eagerly
(``serve/executor.py``).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh

__all__ = ["ServingMesh", "make_mesh_auto", "make_serving_mesh", "abstract_mesh",
           "make_production_mesh", "make_local_mesh", "make_cell_mesh", "layout", "spawn"]


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """A ``(dp, tp)`` serving layout: ``dp`` host-level replicas, each
    sharded over the ``tp`` ranks of ``group``, an initialised group."""
    dp: int
    tp: int
    group: Any


def make_mesh_auto(shape, axes) -> ServingMesh:
    """The mesh of ``shape`` over ``axes`` (``("data", "model")``) on the
    initialised default group.  ``data`` is host-level; every other axis
    needs ranks, so the group's world size must equal their product.
    Raises ``ValueError`` up front otherwise."""
    sizes = dict(zip(axes, shape))
    want = math.prod(n for axis, n in sizes.items() if axis != "data")
    fix = ("start the ranks with repro_torch.launch.mesh.spawn (python -m "
           "repro_torch.launch.serve --tp N does), or call "
           f"torch.distributed.init_process_group with world_size={want} in each")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"mesh {sizes} needs {want} ranks in an initialised "
                         f"torch.distributed group, and none is initialised: {fix}")
    have = dist.get_world_size()
    if have != want:
        raise ValueError(f"mesh {sizes} needs {want} ranks but the group has {have}: {fix}")
    return ServingMesh(dp=sizes.get("data", 1), tp=want, group=dist.group.WORLD)


def make_serving_mesh(dp: int = 1, tp: int = 1) -> ServingMesh:
    """The ``(dp, tp)`` serving mesh the router slices into per-replica TP
    groups; validated against the initialised group up front."""
    return make_mesh_auto((dp, tp), ("data", "model"))


def abstract_mesh(shape, axes) -> Mesh:
    """A mesh description: ``axes`` of ``shape``, bound to no rank."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return Mesh(tuple(axes), tuple(int(n) for n in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ``("data", "model")``: one pod of 256 chips; (2, 16, 16)
    ``("pod", "data", "model")``: two pods.  Descriptions only (the specs of
    the full configs are computed on them; nothing runs on them here)."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def make_local_mesh() -> Mesh:
    """The 1 × 1 ``("data", "model")`` description (tests, examples)."""
    return abstract_mesh((1, 1), ("data", "model"))


def make_cell_mesh(shape, axes=("data", "model")) -> Mesh:
    """The cell mesh ``axes`` of ``shape`` bound to the initialised default
    group, whose world size must be their product (every axis is ranks,
    ``data`` included, unlike the serving mesh).  Ranks are row-major over
    the axes.  Every rank builds ``LANES`` subgroups per set of axes and
    per coordinate of the others, in the same order; this rank keeps those
    it belongs to.  Raises ``ValueError`` up front, naming the fix, without a
    group or with one of another size."""
    mesh = abstract_mesh(shape, axes)
    fix = (f"start {mesh.size} ranks with repro_torch.launch.mesh.spawn(fn, {mesh.size}, "
           f"grid=({tuple(shape)}, {tuple(axes)})), or call "
           f"torch.distributed.init_process_group with world_size={mesh.size} in each")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"cell mesh {mesh.shape} needs {mesh.size} ranks in an "
                         f"initialised torch.distributed group, and none is initialised: {fix}")
    have = dist.get_world_size()
    if have != mesh.size:
        raise ValueError(f"cell mesh {mesh.shape} needs {mesh.size} ranks but the group has "
                         f"{have}: {fix}")
    rank = dist.get_rank()
    groups = {}
    names = mesh.axis_names
    for bits in range(1, 2 ** len(names)):
        sub = tuple(a for i, a in enumerate(names) if bits >> i & 1)
        if math.prod(mesh.shape[a] for a in sub) == 1:
            groups[sub] = None
            continue
        members = {}
        for r in range(mesh.size):
            c = dataclasses.replace(mesh, rank=r).coords()
            members.setdefault(tuple(c[a] for a in names if a not in sub), []).append(r)
        for ranks in members.values():
            lanes = tuple(dist.new_group(ranks) for _ in range(LANES))
            if rank in ranks:
                groups[sub] = lanes
    return dataclasses.replace(mesh, rank=rank, groups=groups)


# groups over the same ranks that a large collective is split across, run
# at once: gloo moves each group's bytes over one connection, and the card
# measured 2.3-2.7x the bandwidth of one group with four (PERF.md)
LANES = 4


def layout(tp: int, device: str) -> Tuple[str, str]:
    """``(backend, where the ranks live)`` for ``tp`` ranks on ``device``
    ("cpu" or "cuda"): rank ``r`` takes card ``r % cards``."""
    if torch.device(device).type == "cpu":
        return "gloo", f"{tp} ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' for ranks on the CPU")
    if tp > cards:
        return "gloo", (f"{tp} ranks share {cards} card(s), which NCCL refuses "
                        f"({torch.cuda.get_device_name(0)})")
    return "gloo", f"{tp} ranks on cards of their own (NCCL is not written yet)"


# how long a rank waits in a collective for the others before it raises
_TIMEOUT = datetime.timedelta(seconds=600)


def _rank(rank: int, tp: int, store: str, backend: str, device: str, threads: int,
          fn: Callable, args: tuple, grid=None) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=tp, timeout=_TIMEOUT)
    try:
        out = fn(*args) if grid is None else fn(make_cell_mesh(*grid), *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(os.path.dirname(store), "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)


def spawn(fn: Callable, tp: int, *args, device: str = "cuda", store_dir: Optional[str] = None,
          grid=None):
    """Run ``fn(*args)`` on ``tp`` ranks and return rank 0's result.

    ``grid=(shape, axes)``: a cell mesh of ``tp`` ranks; each rank binds it
    (:func:`make_cell_mesh`, the axes' subgroups built in every rank) and
    runs ``fn(mesh, *args)``.

    Each rank is a fresh process (``fn`` and ``args`` are pickled: a
    module-level function; a script that calls this needs a ``__main__``
    guard) that joins a group of ``tp`` ranks over the backend
    :func:`layout` chooses, on a file store in a new directory under
    ``store_dir`` (default: the system's temporary directory), on card
    ``rank % cards`` for ``device="cuda"``, with the caller's number of
    intra-op threads.  A rank that raises fails the call (the others are
    stopped); a collective that waits 10 minutes for the others raises in
    its rank."""
    import torch.multiprocessing as mp

    if grid is not None and math.prod(grid[0]) != tp:
        raise ValueError(f"grid {grid} needs {math.prod(grid[0])} ranks, not {tp}")
    backend, where = layout(tp, device)
    what = f"tp={tp}" if grid is None else f"cell mesh {dict(zip(grid[1], grid[0]))}"
    print(f"# {what}: {where}; backend {backend}, every step eager (a CUDA graph "
          "cannot hold a gloo collective)", flush=True)
    root = tempfile.mkdtemp(prefix="tp-", dir=store_dir)
    try:
        store = os.path.join(root, "store")
        mp.start_processes(_rank, args=(tp, store, backend, device, torch.get_num_threads(),
                                        fn, args, grid),
                           nprocs=tp, join=True, start_method="spawn")
        with open(os.path.join(root, "rank0.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
