"""Training of the recurrent and encoder-decoder families on a mesh: the
RWKV6-7B, RecurrentGemma-2B and Whisper-medium smoke ``train_4k`` cells in
float32 on a (data 2, model 2) and a (data 1, model 2) mesh of gloo ranks,
against the same cell on one rank.

On ``model`` 2 an RWKV6 rank runs each layer's WKV on its heads, from a
zero state held on them (``sharding.fresh_head_state``), the output
gathered whole (``sharding.head_state_local``; its backward passes back the
rank's heads' cotangent, and the inputs' cotangents are gathered whole
again); RecurrentGemma-2B's attention (its smoke config's one KV head does
not split) runs whole on every rank; Whisper's train cell holds its seeded
``frame_embeds``, cut to the rank's batch, beside the tokens it draws from
``lm_batch``.  FSDP weights are gathered a layer at a time (again under
remat), the moments are ZeRO-1 slices, the gradients ZeRO-2 slices.  The
one-rank reference takes a microbatch per DP rank's microbatch
(``grad_accum`` x the DP degree), so every microbatch holds the same rows.

Checks: after one step every rank's loss and grad norm, and the whole of
every parameter and moment, equal one rank's within float32 summation
order (the DP ranks' sums meet in another order; the per-head recurrence
is exact); dry ranks (``Mesh.at``, on ``meta``) record the bound ranks'
collectives in the same order and of the same bytes, and hold the same
bytes.  One start of four ranks and one of two run every multi-rank part.
JAX is not used here (``tests/test_torch_recurrent_train.py`` and
``tests/test_torch_encdec_train.py`` hold one rank's gradients against
``jax.grad``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import state_bytes
from repro_torch.launch.mesh import abstract_mesh, make_local_mesh, spawn
from repro_torch.train import OptConfig

ARCHS = ("rwkv6_7b", "recurrentgemma_2b", "whisper_medium")
GRIDS = ((2, 2), (1, 2))
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


def family_rank(mesh):
    """One rank: each arch's train cell, one step; RWKV6's recurrences
    counted with the heads of the state each ran on."""
    import torch.distributed as dist

    from repro_torch.models import rwkv6

    out = {"rank": dist.get_rank()}
    real, heads = shd.head_state_local, []

    def spy(fn, state, *xs, per_head=()):
        heads.append(state.shape[1])
        return real(fn, state, *xs, per_head=per_head)

    rwkv6.sharding.head_state_local = spy
    try:
        for arch in ARCHS:
            cell = _cell(arch, mesh)
            state = cell.materialize(0, "cpu")
            held = state_bytes(state)
            heads.clear()
            metrics, log = _step(cell, state)
            whole = _whole(cell, state)         # every rank takes part in the gathers
            out[arch] = dict(metrics=metrics, log=log, held=held, heads=list(heads),
                             frames=tuple(state["frame_embeds"].shape)
                             if "frame_embeds" in state else None,
                             whole=whole if out["rank"] == 0 else None)
    finally:
        rwkv6.sharding.head_state_local = real
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, out)
    return everyone


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("family_cells"))
    grids = {grid: spawn(family_rank, grid[0] * grid[1], device="cpu", store_dir=root,
                         grid=(grid, ("data", "model"))) for grid in GRIDS}
    one = {}
    for arch in ARCHS:
        for dp in sorted({g[0] for g in GRIDS}):
            cell = _cell(arch, make_local_mesh(), ga=GA * dp)
            assert cell.grad_accum == GA * dp
            state = cell.materialize(0, "cpu")
            one[arch, dp] = dict(metrics=_step(cell, state)[0], whole=_whole(cell, state))
    return grids, one


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_matches_one_rank(runs, arch, grid):
    """Loss, grad norm (rel 1e-5) and every parameter and moment after the
    step (``F32_TOL``) equal one rank's; RWKV6's WKV ran on half the heads
    a rank (each layer, each microbatch, again in remat's recompute);
    Whisper's frames are the rank's batch rows."""
    grids, one = runs
    ranks, ref = grids[grid], one[arch, grid[0]]
    cfg = tget(arch)
    for rank in ranks:
        got = rank[arch]
        for k in ("loss", "grad_norm"):
            assert got["metrics"][k] == pytest.approx(ref["metrics"][k], rel=1e-5), k
        if arch == "rwkv6_7b":
            assert got["heads"] == [cfg.n_heads // grid[1]] * (2 * cfg.n_layers * GA)
        else:
            assert got["heads"] == []
        if arch == "whisper_medium":
            assert got["frames"] == (TRAIN.global_batch // grid[0], cfg.encoder_seq,
                                     cfg.d_model)
    whole = ranks[0][arch]["whole"]
    for part in ("params", "mu"):
        for k, want in ref["whole"][part].items():
            np.testing.assert_allclose(whole[part][k], want, err_msg=f"{part} {k}", **F32_TOL)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_ranks_record_the_bound_ranks_collectives(runs, arch, grid):
    """Each rank's step counted on a dry rank (``Mesh.at``, ``meta``): the
    same collectives, in the same order and of the same bytes (the WKV's
    head gathers and their backward's among them), and the same held
    bytes (Whisper's frames included)."""
    ranks = runs[0][grid]
    mesh = abstract_mesh(grid, ("data", "model"))
    for rank in ranks:
        cell = _cell(arch, mesh.at(rank["rank"]))
        state = cell.materialize(device="meta")
        assert state_bytes(state) == rank[arch]["held"]
        _, log = _step(cell, state)
        # (kind, bytes, group size); a bound rank's group does not name its axes
        assert [e[:3] for e in log] == [e[:3] for e in rank[arch]["log"]]
        # all-reduces only over data (the loss, the ZeRO-2 reduce-slices)
        kinds = {"all_gather", "all_reduce"} if grid[0] > 1 else {"all_gather"}
        assert {k for k, *_ in log} == kinds


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)], ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_moments_are_their_opt_state_specs_slice(arch, grid):
    """On a dry rank of each train cell, every AdamW moment the optimizer
    holds is the slice its ``opt_state_specs`` spec names (the shardings a
    checkpoint gathers and restores by).  A bias whose spec names only a
    ``model`` axis of size 1 (Whisper's on (2, 1)) is held whole and its
    moments are sliced over ``data``; the spec says so (it named them whole
    until the elastic restore of such a cell found it)."""
    mesh = abstract_mesh(grid, ("data", "model")).at(1)
    cell = _cell(arch, mesh)
    state = cell.materialize(device="meta")
    specs = cell.shardings()["opt"]["mu"]
    params = dict(state["params"].named_parameters())
    for k, mu in state["opt"]["mu"].items():
        whole = torch.empty(shd.full_shape(params[k]), device="meta")
        assert tuple(mu.shape) == tuple(shd.local(whole, specs[k].spec, mesh).shape), k
    if arch == "whisper_medium" and grid == (2, 1):
        b = "enc_blocks.0.attn.q_proj.b"
        assert specs[b].spec == ("data",) and params[b].shape == (tget(arch).d_model,)
