"""The serving mesh of the port (port of ``repro/launch/mesh.py``:
``make_mesh_auto`` and ``make_serving_mesh``) and :func:`spawn`, which
starts the ranks.

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

__all__ = ["ServingMesh", "make_mesh_auto", "make_serving_mesh", "layout", "spawn"]


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
          fn: Callable, args: tuple) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=tp, timeout=_TIMEOUT)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(os.path.dirname(store), "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)


def spawn(fn: Callable, tp: int, *args, device: str = "cuda", store_dir: Optional[str] = None):
    """Run ``fn(*args)`` on ``tp`` ranks and return rank 0's result.

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

    backend, where = layout(tp, device)
    print(f"# tp={tp}: {where}; backend {backend}, every step eager (a CUDA graph "
          "cannot hold a gloo collective)", flush=True)
    root = tempfile.mkdtemp(prefix="tp-", dir=store_dir)
    try:
        store = os.path.join(root, "store")
        mp.start_processes(_rank, args=(tp, store, backend, device, torch.get_num_threads(),
                                        fn, args),
                           nprocs=tp, join=True, start_method="spawn")
        with open(os.path.join(root, "rank0.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
