"""MoE training on a mesh: the Qwen3-30B-A3B and Mixtral-8x7B smoke
``train_4k`` cells in float32 on a (data 2, model 2) mesh of four gloo
ranks, against the same cell on one rank.

On the mesh each rank routes its own batch shard's tokens through
``models/moe._moe_shard_map`` on its ``d_ff / 2`` columns of every expert:
the expert stacks are held FSDP-style and gathered over ``data`` alone
(``sharding.gather_data``), the region's inputs and output take
``sharding.copy_to`` / ``reduce_from`` (Megatron's f and g), and the
ZeRO-2 accumulator takes each stack's own shard.  The one-rank reference
runs the same function (``_moe_shard_map`` on the 1 x 1 mesh: the local
path is dropless, the shard-map path drops pairs past capacity) with four
microbatches where each of the two DP ranks runs two, so every routing
call sees the same tokens as the rank that holds them.  A wrong f / g pair
shows as a factor of 2 in the gradients.

Checks: after one step, every rank's loss, grad norm and updated
parameter shards equal one rank's within float32 summation order; dry
ranks (``Mesh.at``, on ``meta``) record the bound ranks' collectives in
the same order and hold the same bytes; the (2, 2) checkpoint restores
exactly at (1, 1).  One start of four ranks runs every multi-rank part.
JAX is not used here (``tests/test_torch_moe_train.py`` holds the one-rank
gradients against ``jax.grad``).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import state_bytes
from repro_torch.launch.mesh import abstract_mesh, make_local_mesh, spawn
from repro_torch.models import moe as tmoe
from repro_torch.train import OptConfig

ARCHS = ("qwen3_30b_a3b", "mixtral_8x7b")
GRID = (2, 2)
TRAIN = ShapeCell("cut", 16, 4, "train")           # 4 x 16 tokens
GA = 2                                             # microbatches a DP rank
OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite runs six
    workers; the ranks take the caller's count); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cell(arch, mesh, ga=GA):
    cfg = dataclasses.replace(tget(arch), dtype="float32")
    return build_cell(arch, "train_4k", mesh, cfg=cfg, shape=TRAIN, grad_accum=ga,
                      opt_cfg=OPT)


def _state_tree(state):
    return {"params": dict(state["params"].named_parameters()),
            "opt": {k: state["opt"][k] for k in ("mu", "nu")}}


def _whole(cell, state):
    """Every parameter and moment of a train cell's state whole (numpy)."""
    sh = cell.shardings()
    gat = lambda t, ns: (shd.gather(t.detach(), ns.spec, ns.mesh) if cell.mesh.bound
                         else t.detach()).numpy()
    return {"params": {k: gat(p, sh["params"][k])
                       for k, p in state["params"].named_parameters()},
            "mu": {k: gat(t, sh["opt"]["mu"][k]) for k, t in state["opt"]["mu"].items()}}


def _step(cell, state):
    """One step, its collectives recorded → (metrics, the log)."""
    with shd.recording() as log:
        metrics = cell.run(state, step=0)
    if not cell.mesh.dry:
        metrics = {k: float(v) for k, v in metrics.items()}
    return metrics, list(log)


def moe_rank(mesh, root):
    """One rank: each arch's train cell, one step, then a checkpoint."""
    import torch.distributed as dist

    out = {"rank": dist.get_rank()}
    for arch in ARCHS:
        cell = _cell(arch, mesh)
        state = cell.materialize(0, "cpu")
        held = state_bytes(state)
        tmoe.shard_map_stats.update(calls=0)
        metrics, log = _step(cell, state)
        save_checkpoint(os.path.join(root, f"{arch}.npz"), _state_tree(state),
                        cell.shardings())
        whole = _whole(cell, state)
        out[arch] = dict(metrics=metrics, log=log, held=held,
                         shard_map_calls=tmoe.shard_map_stats["calls"],
                         specs={k: p._shard[0] for k, p in state["params"].named_parameters()
                                if getattr(p, "_shard", None) is not None},
                         whole=whole if out["rank"] == 0 else None)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, out)
    return everyone


def _one_rank(arch):
    """The cell on one rank through ``_moe_shard_map`` on the 1 x 1 mesh,
    with a microbatch per DP rank's microbatch → (cell, state, metrics)."""
    one = make_local_mesh()
    local = tmoe._moe_local
    tmoe._moe_local = lambda x, p, policy, phase, top_k, act_fn, impl, layer_idx: \
        tmoe._moe_shard_map(one, x, p, policy, phase, top_k, act_fn, layer_idx)
    try:
        cell = _cell(arch, one, ga=GA * GRID[0])
        assert cell.grad_accum == GA * GRID[0]
        state = cell.materialize(0, "cpu")
        return cell, state, _step(cell, state)[0]
    finally:
        tmoe._moe_local = local


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("moe_cells"))
    ranks = spawn(moe_rank, 4, root, device="cpu", store_dir=root,
                  grid=(GRID, ("data", "model")))
    one = {}
    for arch in ARCHS:
        cell, state, metrics = _one_rank(arch)
        one[arch] = dict(metrics=metrics, whole=_whole(cell, state), cell=cell, state=state)
    return root, ranks, one


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_matches_one_rank(runs, arch):
    """Loss, grad norm (within float32 summation order: the DP ranks' sums
    meet in another order) and every parameter and moment after the step."""
    _, ranks, one = runs
    ref = one[arch]
    layers = tget(arch).n_layers
    for rank in ranks:
        got = rank[arch]
        for k in ("loss", "grad_norm"):
            assert got["metrics"][k] == pytest.approx(ref["metrics"][k], rel=1e-5), k
        # once a layer a microbatch: remat's recompute (torch's non-reentrant
        # checkpoint) stops at the block's last saved tensor, the gated
        # combine, before the all-reduce and the count
        assert got["shard_map_calls"] == layers * GA
        # the expert stacks are held on data and on model
        stacks = {k: s for k, s in got["specs"].items() if ".moe.experts." in k}
        assert len(stacks) == 3 * layers
        for k, spec in stacks.items():
            assert "data" in spec and "model" in spec, (k, spec)
    whole = ranks[0][arch]["whole"]
    for part in ("params", "mu"):
        for k, want in ref["whole"][part].items():
            np.testing.assert_allclose(whole[part][k], want, err_msg=f"{part} {k}", **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_ranks_record_the_bound_ranks_collectives(runs, arch):
    """Each rank's step counted on a dry rank (``Mesh.at``, ``meta``): the
    same collectives, in the same order and of the same bytes, and the same
    held bytes, the backward's included (the f / g pair's, the DP gathers'
    reduce-slices, the expert shards' norm over model)."""
    _, ranks, _ = runs
    mesh = abstract_mesh(GRID, ("data", "model"))
    for rank in ranks:
        cell = _cell(arch, mesh.at(rank["rank"]))
        state = cell.materialize(device="meta")
        assert state_bytes(state) == rank[arch]["held"]
        _, log = _step(cell, state)
        # (kind, bytes, group size); a bound rank's group does not name its axes
        assert [e[:3] for e in log] == [e[:3] for e in rank[arch]["log"]]
        kinds = {k for k, *_ in log}
        assert {"all_gather", "all_reduce"} <= kinds


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_checkpoint_restores_at_one_rank(runs, arch):
    """The (2, 2) checkpoint, saved whole from the ranks' shards, loads
    into the one-rank cell's tensors bit for bit as the ranks held them."""
    root, ranks, one = runs
    cell = _cell(arch, make_local_mesh(), ga=GA * GRID[0])
    fresh = cell.materialize(5, "cpu")
    loaded = load_checkpoint(os.path.join(root, f"{arch}.npz"), _state_tree(fresh))
    whole = ranks[0][arch]["whole"]
    for k, t in loaded["params"].items():
        np.testing.assert_array_equal(t.numpy(), whole["params"][k], err_msg=k)
    for k, t in loaded["opt"]["mu"].items():
        np.testing.assert_array_equal(t.numpy(), whole["mu"][k], err_msg=k)


def test_expert_stacks_are_gathered_over_data_alone(monkeypatch):
    """A train cell's expert stacks (on a dry rank of the (2, 2) mesh, on
    ``meta``): gathered over ``data`` alone they are the ``d_ff / 2`` shards
    ``_moe_shard_map`` reads; without that gather the check names the cut."""
    cell = _cell("qwen3_30b_a3b", abstract_mesh(GRID, ("data", "model")).at(3))
    state = cell.materialize(device="meta")
    ex = state["params"].blocks[0].moe.experts
    assert cell.pspecs["blocks.0.moe.experts.gate_proj"] == (None, "data", "model")
    assert cell.pspecs["blocks.0.moe.experts.down_proj"] == (None, "model", "data")
    e, d, f = shd.full_shape(ex.gate_proj)
    assert tuple(ex.gate_proj.shape) == (e, d // 2, f // 2)
    wg, wu, wd = tmoe._expert_shards(cell.mesh, ex)
    assert tuple(wg.shape) == tuple(wu.shape) == (e, d, f // 2)
    assert tuple(wd.shape) == (e, f // 2, d)
    monkeypatch.setattr(shd, "gather_data", lambda t: t)
    with pytest.raises(ValueError, match="a DP axis still cuts it"):
        tmoe._expert_shards(cell.mesh, ex)


def test_remat_recompute_reenters_the_forward_scopes():
    """Remat's recompute runs in autograd's own thread on the card (on the
    CPU, in the caller's): ``transformer._remat_context`` re-enters the
    forward's mesh scope, batch shards and TP scope there, so the recompute
    takes ``_moe_shard_map`` as the forward did, and leaves that thread as
    it found it."""
    import threading

    from repro_torch.distributed import tp
    from repro_torch.models import transformer

    mesh = abstract_mesh(GRID, ("data", "model")).at(1)
    with shd.mesh_scope(mesh, 2), tp.scope(mesh.group(("model",))):
        _, again = transformer._remat_context()
        want = tp.current()
    assert shd._context_mesh() is None and tp.current() is None
    seen = []

    def recompute():
        with again:
            seen.append((shd._context_mesh(), shd._batch_shards(), tp.current()))
        seen.append((shd._context_mesh(), tp.current()))

    t = threading.Thread(target=recompute)
    t.start()
    t.join()
    assert seen[0][0] is mesh and seen[0][1] == 2 and seen[0][2] == want
    assert seen[1] == (None, None)
