"""Dry-run: count every (arch × shape × mesh) cell's step for one rank
(port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch mixtral_8x7b] [--shape train_4k] [--multi-pod|--both] \\
        [--json out.json] [--tile-consensus]

The reference lowers and compiles each cell with XLA on 512 fake host
devices and reads ``memory_analysis()`` and ``cost_analysis()``.  The port
has no compiler: it builds the cell on the production mesh's description
(16 × 16, or 2 × 16 × 16), takes rank 0 as a dry rank
(``sharding.Mesh.at``), materializes that rank's shards on ``meta`` (shapes
only) and executes its share of the step under ``launch/roofline.
count_step``, every collective recorded and none run.  Nothing is
allocated and no cell falls back to a real allocation.

Per cell, the reference's schema: ``flops_per_device``,
``hbm_bytes_per_device`` (compulsory bytes, ``roofline.py``),
``collective_bytes_per_device``, ``roofline_s`` (H100 rates),
``dominant``, ``model_flops``, ``useful_flops_ratio`` and
``bytes_per_device``: ``args`` (exact: the rank's shard of every argument,
from the specs), ``output`` (the step's results), ``temp`` (the most the
step's own tensors held at once) and ``total`` (args + temp); the
reference's two TPU-only keys have no counterpart.  ``count_s`` takes
``compile_s``'s place.  Also ``ops_per_device`` by class, ``units`` (each
hand kernel's count of units) and ``collectives`` (the runtime's tallies:
``sharding.collectives`` and ``tp.gather``'s, calls and bytes) and ``held``
(the bytes of the materialized state: ``args`` less the batch of a train
cell, which a rank draws each step).

Statuses: ``ok``; ``skipped`` (``long_500k`` on full attention, as the
reference); ``unported``: a cell the port refuses with
``NotImplementedError``, with the refusal's text, counted apart (none
since every family trains; the status stays for a later gap); ``FAIL``
(exit 1).
The sweep covers ``ARCH_IDS`` and ``PAPER_ARCH_IDS`` (13 archs; the
reference's default is the 10 of ``ARCH_IDS``).  The policy is the
reference's (``paper_policy(8, 16, cfg.qgate_skip_layers)``) on the
kernels, so each kernel counts as one unit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

__all__ = ["run_cell", "args_bytes", "state_bytes", "main"]


def _leaf_bytes(t, sharding, mesh) -> int:
    from repro_torch.distributed import sharding as shd

    local = shd.local(t, sharding.spec, mesh) if mesh.bound else t
    return local.numel() * local.element_size()


def args_bytes(cell) -> int:
    """The bytes of this rank's shard of every argument of ``cell``, from
    its specs (``cell.mesh`` a dry or bound rank; a description counts
    whole tensors)."""
    import torch

    def walk(tree, shard) -> int:
        if isinstance(tree, torch.nn.Module):
            return sum(_leaf_bytes(p, shard[k], cell.mesh)
                       for k, p in tree.named_parameters())
        if isinstance(tree, dict):
            return sum(walk(v, shard[k]) for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return sum(walk(v, s) for v, s in zip(tree, shard))
        return _leaf_bytes(tree, shard, cell.mesh)

    return sum(walk(a, s) for a, s in zip(cell.args, cell.in_shardings))


def state_bytes(state) -> int:
    """The bytes a materialized cell state holds (``Cell.materialize``): its
    parameters, optimizer state, cache, tokens and frame embeddings, each
    tensor's own elements."""
    from repro_torch.launch.roofline import _leaves

    return sum(t.numel() * t.element_size()
               for t in _leaves([state.get(k) for k in ("params", "opt", "cache", "tokens",
                                                        "frame_embeds")]))


def _tallies() -> dict:
    from repro_torch.distributed import sharding, tp

    out = {k: list(v) for k, v in sharding.collectives.items()}
    out["tp_gather"] = [tp.gather.calls, tp.gather.bytes]
    return out


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.sizes)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, policy=None, *, cfg=None,
             shape=None, mesh=None, rank: int = 0, grad_accum: int = 16):
    """Count one cell's step on dry rank ``rank`` → the result dict (module
    docstring).  ``cfg``, ``shape`` (a cut of the cell's shape), ``mesh`` (a
    description; default the production mesh) and ``grad_accum`` as
    ``build_cell`` takes them.  A mesh of one rank runs as it is (the
    code a one-rank cell runs); a larger one as dry rank ``rank``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.launch import roofline
    from repro_torch.launch.cells import build_cell, cell_by_name, is_runnable
    from repro_torch.launch.mesh import make_production_mesh

    cfg = cfg or get_config(arch)
    base = cell_by_name(shape_name)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    head = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh)}
    ok, why = is_runnable(cfg, base)
    if not ok:
        return {**head, "status": "skipped", "why": why}
    policy = policy or paper_policy(8, 16, cfg.qgate_skip_layers)
    policy = dataclasses.replace(policy, use_kernels=True)
    t0 = time.time()
    before = _tallies()
    try:
        cell = build_cell(arch, shape_name, mesh.at(rank) if mesh.size > 1 else mesh,
                          policy=policy, cfg=cfg, grad_accum=grad_accum, shape=shape)
        state = cell.materialize(device="meta")
        held = state_bytes(state)
        _, count = roofline.count_step(cell.run, state, args_bytes=args_bytes(cell))
    except NotImplementedError as e:
        return {**head, "status": "unported", "why": str(e)}
    dt = time.time() - t0
    after = _tallies()
    run = cell.shape
    tokens = run.global_batch * (run.seq_len if run.kind != "decode" else 1)
    rep = roofline.analyze(arch, shape_name, head["mesh"], count, cfg, run.kind, tokens,
                           mesh=cell.mesh)
    return {
        **head,
        "status": "ok",
        "count_s": round(dt, 1),
        "held": held,
        "bytes_per_device": {
            "args": int(count.args_bytes),
            "output": int(count.output_bytes),
            "temp": int(count.peak_live_bytes),
            "total": int(count.peak_bytes),
        },
        "flops_per_device": rep.flops_per_dev,
        "ops_per_device": rep.ops_per_dev,
        "hbm_bytes_per_device": rep.bytes_per_dev,
        "collective_bytes_per_device": rep.coll_bytes_per_dev,
        "roofline_s": {
            "compute": rep.compute_s,
            "memory": rep.memory_s,
            "collective": rep.collective_s,
        },
        "dominant": rep.dominant,
        "model_flops": rep.model_flops_total,
        "useful_flops_ratio": rep.model_flops_total / max(rep.flops_per_dev * mesh.size, 1.0),
        "units": count.unit_counts(),
        "collectives": {k: [after[k][0] - before[k][0], after[k][1] - before[k][1]]
                        for k in after},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape cell (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run 16x16 AND 2x16x16 meshes")
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--tile-consensus", action="store_true",
                    help="use the tile-consensus compacted-matmul sparsity mode")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ARCH_IDS, PAPER_ARCH_IDS, SHAPE_CELLS, get_config
    from repro_torch.core.policy import paper_policy

    archs = [args.arch] if args.arch else list(ARCH_IDS) + list(PAPER_ARCH_IDS)
    shapes = [args.shape] if args.shape else [c.name for c in SHAPE_CELLS]
    meshes = [False, True] if args.both else [args.multi_pod]

    results = []
    failures = 0
    for arch in archs:
        policy = None
        if args.tile_consensus:
            policy = paper_policy(8, 16, get_config(arch).qgate_skip_layers,
                                  tile_consensus=True)
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
                try:
                    r = run_cell(arch, shape, mp, policy=policy)
                except Exception as e:
                    traceback.print_exc()
                    r = {"arch": arch, "shape": shape,
                         "mesh": "2x16x16" if mp else "16x16",
                         "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                results.append(r)
                status = r["status"]
                if status == "ok":
                    rf, b = r["roofline_s"], r["bytes_per_device"]
                    print(f"[dryrun] {tag}: OK count={r['count_s']}s "
                          f"mem/dev={b['total'] / 2**30:.2f}GiB "
                          f"(args {b['args'] / 2**30:.2f}) "
                          f"compute={rf['compute']:.3e}s "
                          f"memory={rf['memory']:.3e}s "
                          f"coll={rf['collective']:.3e}s "
                          f"dom={r['dominant']}", flush=True)
                elif status == "skipped":
                    print(f"[dryrun] {tag}: SKIP ({r['why']})", flush=True)
                elif status == "unported":
                    print(f"[dryrun] {tag}: UNPORTED ({r['why']})", flush=True)
                else:
                    print(f"[dryrun] {tag}: FAIL {r['error']}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    print(f"[dryrun] done: {sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{sum(r['status'] == 'unported' for r in results)} unported, "
          f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
