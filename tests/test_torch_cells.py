"""The port's sharded cells (``repro_torch.launch.cells``), ZeRO-1/2
(``train/optimizer.py``, ``train/train_step.py``) and the elastic restore
(``checkpoint/ckpt.py``), on the LLaMA-3.1 smoke config in float32.

Ranks are processes over gloo (``launch.mesh.spawn(..., grid=...)``), one
intra-op thread each; each start costs every rank a fresh interpreter, so
two starts of four ranks run every multi-rank check and return what they
found:

* both meshes: the train cell (``grad_accum`` 2, three steps; a checkpoint
  after two, saved whole from the ranks; then ``grad_accum`` 1);
* ``(data 2, model 2)``: a restore of the
  one-rank cell's checkpoint into each rank's slices, the prefill cell with
  the kernels' column-parallel path (their plain versions on the CPU), the
  decode cell, Granite's sequence-sharded decode cell, the MoE prefill cell
  through ``_moe_shard_map``, and a ``Trainer`` that resumes a one-process
  run and one that checkpoints for a one-process resume;
* ``(data 4, model 1)``: an MoE served under ``EngineConfig(tp=4)`` (the
  local path), and the up-front error of a cell mesh of the wrong size.

The references: JAX ``make_train_step`` on the same weights and batches
(loss and grad norm rel 1e-4, moments atol 1e-4, parameters atol 1e-4
where JAX's ``mu`` exceeds 1e-3 of its leaf's largest at every step, and
AdamW's bound of 2 lr a step elsewhere, after three steps at lr 1e-2:
float32 sums in another order, over DP and over microbatches cut
differently), and this process's one-rank cells (prefill and decode logits
within ``F32_TOL``: a batch split over DP runs the products at other
shapes).  Each rank's moments are exactly the shape
``opt_state_specs`` names, and equal the JAX moments' slice.  Restores are
bit-exact.

JAX is imported inside the functions that use it, never at the top: each
rank imports this module to find its function.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs.base import ShapeCell
from repro_torch.core import policy as tpolicy
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.distributed import sharding as shd
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import abstract_mesh, make_cell_mesh, make_local_mesh, spawn
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
from repro_torch.train import OptConfig, Trainer, TrainerConfig
from repro_torch.train.optimizer import moment_spec

F32_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rel=1e-4)
PARAM_ATOL = 1e-4
TRAIN = ShapeCell("cut", 32, 8, "train")           # 8 x 32 tokens
PREFILL = ShapeCell("cut", 16, 4, "prefill")
DECODE = ShapeCell("cut", 32, 4, "decode")
OPT = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
STEPS = 3
SERVE = dict(max_seq=64, num_slots=2, chunk_size=8)


def _cfg(arch="llama31_8b"):
    return dataclasses.replace(tget(arch), dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite runs six
    workers; the ranks take the caller's count); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _train_cell(mesh, ga):
    return build_cell("llama31_8b", "train_4k", mesh, cfg=_cfg(), shape=TRAIN,
                      grad_accum=ga, opt_cfg=OPT)


def _whole_state(cell, state):
    """Every tensor of a train cell's state whole (numpy), on every rank."""
    sh = cell.shardings()
    gat = lambda t, ns: (shd.gather(t.detach(), ns.spec, ns.mesh) if cell.mesh.bound
                         else t.detach()).numpy()
    return {"params": {k: gat(p, sh["params"][k])
                       for k, p in state["params"].named_parameters()},
            "mu": {k: gat(t, sh["opt"]["mu"][k]) for k, t in state["opt"]["mu"].items()},
            "nu": {k: gat(t, sh["opt"]["nu"][k]) for k, t in state["opt"]["nu"].items()}}


def _train(mesh, ga, ckpt=None, weights=None):
    """Three steps of the train cell: per-step metrics, the whole state,
    this rank's moments (numpy) and, with ``ckpt``, a checkpoint after two
    steps (whole tensors, rank 0 writes)."""
    cell = _train_cell(mesh, ga)
    state = cell.materialize(0, "cpu", weights=weights)
    metrics, at_ckpt = [], None
    for step in range(STEPS):
        if step == 2 and ckpt is not None:
            save_checkpoint(ckpt, {"params": dict(state["params"].named_parameters()),
                                   "opt": {k: state["opt"][k] for k in ("mu", "nu")}},
                            cell.shardings())
            at_ckpt = _whole_state(cell, state)
        metrics.append({k: float(v) for k, v in cell.run(state, step=step).items()})
    mine = {k: t.numpy().copy() for k, t in state["opt"]["mu"].items()}
    return cell, state, metrics, _whole_state(cell, state), mine, at_ckpt


def _serve_cells(mesh):
    """Logits of the prefill cell (kernels' path), the decode cell, Granite's
    decode cell and the MoE prefill cell on ``mesh``, with the MoE's
    shard-map calls."""
    out = {}
    cfg = _cfg()
    pol = tpolicy.paper_policy(8, 16, cfg.qgate_skip_layers, use_kernels=True)
    for name, arch, shape, policy in (
            ("prefill", "llama31_8b", PREFILL, pol), ("decode", "llama31_8b", DECODE, None),
            ("granite", "granite_34b", DECODE, None),
            ("moe", "qwen3_30b_a3b", PREFILL, tpolicy.paper_policy(8, 16, use_kernels=True))):
        cell = build_cell(arch, {"prefill": "prefill_32k"}.get(shape.kind, "decode_32k"),
                          mesh, policy=policy, cfg=_cfg(arch), shape=shape)
        state = cell.materialize(0, "cpu")
        tmoe.shard_map_stats.update(calls=0)
        out[name] = cell.run(state)[0].numpy()
        out[name + ".moe_calls"] = tmoe.shard_map_stats["calls"]
        if name == "granite":
            out["granite.k"] = (tuple(state["cache"]["layers"][0]["k"].shape),
                                cell.in_shardings[2]["layers"][0]["k"].spec)
    return out


def _trainer(directory, steps):
    cfg = _cfg()
    return Trainer(build_model(cfg, device="cpu"), DataConfig(cfg.vocab_size, 16, 4), OPT,
                   TrainerConfig(total_steps=steps, ckpt_every=2, ckpt_dir=str(directory),
                                 log_every=100))


def grid_rank(mesh, root):
    """One rank of a start (module docstring)."""
    import torch.distributed as dist

    out = {"coords": mesh.coords()}
    first = dist.get_rank() == 0
    d, m = mesh.shape["data"], mesh.shape["model"]
    cell, state, out["metrics"], whole, out["mu"], at_ckpt = _train(
        mesh, 2, ckpt=os.path.join(root, f"grid{d}x{m}.npz"))
    out["whole"], out["at_ckpt"] = (whole, at_ckpt) if first else (None, None)
    out["ospecs"] = {k: moment_spec(p, mesh) for k, p in state["params"].named_parameters()}
    _, _, metrics1, whole1, _, _ = _train(mesh, 1)
    out["ga1"] = {"metrics": metrics1, "whole": whole1 if first else None}
    if mesh.shape["model"] > 1:
        # restore the one-rank cell's checkpoint into this rank's slices
        fresh = cell.materialize(1, "cpu")
        like = {"params": dict(fresh["params"].named_parameters()),
                "opt": {k: fresh["opt"][k] for k in ("mu", "nu")}}
        loaded = load_checkpoint(os.path.join(root, "one.npz"), like, cell.shardings())
        out["restored"] = {k: t.numpy() for k, t in loaded["params"].items()}
        out["restored_mu"] = {k: t.numpy() for k, t in loaded["opt"]["mu"].items()}
        out.update(_serve_cells(mesh))
        with shd.mesh_scope(mesh):
            out["resumed"] = _trainer(os.path.join(root, "trainer_one"), 4).run(0)["metrics"]
            t2 = _trainer(os.path.join(root, "trainer_grid"), 2).run(0)
            out["grid_first"] = t2["metrics"]
    else:
        model = build_model(_cfg("qwen3_30b_a3b"), device="cpu")
        params = model.init(0)
        eng = Engine.from_config(model, EngineConfig(tp=4, serving=ContinuousConfig(**SERVE)),
                                 policy=tpolicy.paper_policy(8, 16), device="cpu")
        tmoe.shard_map_stats.update(calls=0)
        rids = [eng.submit(list(range(3 + i, 12 + 2 * i)), 4) for i in range(2)]
        res = eng.run(params)
        out["tp_tokens"] = [res["outputs"][r] for r in rids]
        out["tp_moe_calls"] = tmoe.shard_map_stats["calls"]
        try:
            make_cell_mesh((1, 2))
        except ValueError as e:
            out["wrong_size"] = str(e)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, out)
    return everyone


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """This process's one-rank references, then the two starts."""
    root = str(tmp_path_factory.mktemp("cells"))
    local = make_local_mesh()
    one = {}
    _, _, one["metrics"], one["whole"], _, _ = _train(local, 2)
    # the one-rank state after two steps, for the (2, 2) ranks to restore
    cell = _train_cell(local, 2)
    st = cell.materialize(0, "cpu")
    for step in range(2):
        cell.run(st, step=step)
    save_checkpoint(os.path.join(root, "one.npz"),
                    {"params": dict(st["params"].named_parameters()),
                     "opt": {k: st["opt"][k] for k in ("mu", "nu")}})
    one["two_steps"] = _whole_state(cell, st)
    one.update(_serve_cells(local))
    one["trainer_ref"] = _trainer(os.path.join(root, "trainer_ref"), 4).run(0)["metrics"]
    _trainer(os.path.join(root, "trainer_one"), 2).run(0)
    grids = {
        (2, 2): spawn(grid_rank, 4, root, device="cpu", store_dir=root,
                      grid=((2, 2), ("data", "model"))),
        (4, 1): spawn(grid_rank, 4, root, device="cpu", store_dir=root,
                      grid=((4, 1), ("data", "model"))),
    }
    # the grid's Trainer checkpoint, resumed here at data 1
    one["grid_resumed"] = _trainer(os.path.join(root, "trainer_grid"), 4).run(0)
    return root, one, grids


@pytest.fixture(scope="module")
def jax_train(runs):
    """JAX ``make_train_step`` on the cell's weights and batches: per-step
    metrics and the final params and moments, by port name, per grad_accum."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_smoke_config as jget
    from repro.core.policy import paper_policy as jpaper
    from repro.models import build_model as jbuild
    from repro.train.optimizer import OptConfig as JOpt
    from repro.train.optimizer import adamw_init as jinit
    from repro.train.train_step import make_train_step as jstep
    from repro_torch.weights import named_from_jax

    cfg = dataclasses.replace(jget("llama31_8b"), dtype="float32")
    jm = jbuild(cfg)
    cell = _train_cell(make_local_mesh(), 1)
    weights = {k: p.detach().numpy() for k, p in
               cell.materialize(0, "cpu")["params"].named_parameters()}

    def fill(path, sds):
        keys = [str(k.key) for k in path]
        if keys[0] == "periods":
            return np.stack([weights[f"blocks.{i}.{'.'.join(keys[2:])}"]
                             for i in range(cfg.n_layers)])
        return weights[".".join(keys)]

    params0 = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jm.init,
                                                                    jax.random.PRNGKey(0)))
    out = {}
    for ga in (1, 2):
        step = jax.jit(jstep(jm, JOpt(lr=OPT.lr, warmup_steps=OPT.warmup_steps,
                                      total_steps=OPT.total_steps),
                             jpaper(8, 16, cfg.qgate_skip_layers), grad_accum=ga))
        params = jax.tree_util.tree_map(jnp.asarray, params0)
        opt = jinit(params)
        metrics, mus = [], []
        np_ = lambda t: named_from_jax(cfg, jax.tree_util.tree_map(np.asarray, t))
        for s in range(STEPS):
            tokens = lm_batch(DataConfig(cfg.vocab_size, TRAIN.seq_len, TRAIN.global_batch),
                              s, device="cpu")["tokens"].numpy()
            params, opt, m = step(params, opt, {"tokens": jnp.asarray(tokens)})
            metrics.append({k: float(v) for k, v in m.items()})
            mus.append(np_(opt["mu"]))
        # an entry is firm where every step's mu exceeds 1e-3 of its leaf's largest
        firm = {k: np.all([np.abs(mu[k]) > 1e-3 * np.abs(mu[k]).max() for mu in mus], axis=0)
                for k in mus[0]}
        out[ga] = dict(metrics=metrics, params=np_(params), mu=mus[-1], firm=firm)
    return out


@pytest.mark.parametrize("ga", [1, 2])
@pytest.mark.parametrize("grid", [(2, 2), (4, 1)])
def test_train_cell_matches_jax(runs, jax_train, grid, ga):
    _, _, grids = runs
    ref = jax_train[ga]
    pick = (lambda rank: rank) if ga == 2 else (lambda rank: rank["ga1"])
    for rank in grids[grid]:
        for got, want in zip(pick(rank)["metrics"], ref["metrics"]):
            assert got["loss"] == pytest.approx(want["loss"], **STEP_TOL)
            assert got["grad_norm"] == pytest.approx(want["grad_norm"], **STEP_TOL)
            assert got["step"] == want["step"]
    whole = pick(grids[grid][0])["whole"]
    for k, want in ref["params"].items():
        got, mu = whole["params"][k], ref["mu"][k]
        np.testing.assert_allclose(whole["mu"][k], mu, rtol=0, atol=PARAM_ATOL)
        # Adam divides float32 noise by a near-zero moment: where JAX's mu was
        # tiny at any step only AdamW's own bound holds (test_torch_train.py)
        firm = ref["firm"][k]
        np.testing.assert_allclose(got[firm], want[firm], rtol=0, atol=PARAM_ATOL, err_msg=k)
        assert np.abs(got - want).max() <= 2 * OPT.lr * STEPS, k


@pytest.mark.parametrize("grid", [(2, 2), (4, 1)])
def test_each_ranks_moments_are_its_opt_state_specs_slice(runs, jax_train, grid):
    _, _, grids = runs
    mesh = abstract_mesh(grid, ("data", "model"))
    ref = jax_train[2]["mu"]
    for rank in grids[grid]:
        m = dataclasses.replace(mesh, rank=rank["coords"]["data"] * grid[1]
                                + rank["coords"]["model"])
        for k, mine in rank["mu"].items():
            want = shd.local(torch.from_numpy(ref[k]), rank["ospecs"][k], m).numpy()
            assert mine.shape == want.shape, k
            np.testing.assert_allclose(mine, want, rtol=0, atol=PARAM_ATOL)
        # ZeRO-1 halves (quarters) every moment that divides
        n = sum(v.size for v in rank["mu"].values())
        assert n < sum(v.size for v in ref.values()) / (grid[0] - 0.5)


def test_train_cell_one_rank_matches_the_grid(runs):
    _, one, grids = runs
    for got, want in zip(grids[(2, 2)][0]["metrics"], one["metrics"]):
        assert got["loss"] == pytest.approx(want["loss"], **STEP_TOL)


def test_elastic_restore_from_the_grid_to_one_rank(runs):
    """The (2, 2) run's checkpoint after two steps, restored at data 1: bit
    for bit the state the ranks gathered, and the resumed step's loss is the
    uninterrupted run's."""
    root, one, grids = runs
    cell = _train_cell(make_local_mesh(), 2)
    st = cell.materialize(5, "cpu")
    like = {"params": dict(st["params"].named_parameters()),
            "opt": {k: st["opt"][k] for k in ("mu", "nu")}}
    loaded = load_checkpoint(os.path.join(root, "grid2x2.npz"), like)
    saved = grids[(2, 2)][0]["at_ckpt"]
    for part, tree in (("params", loaded["params"]), ("mu", loaded["opt"]["mu"]),
                       ("nu", loaded["opt"]["nu"])):
        for k, t in tree.items():
            assert np.array_equal(t.numpy(), saved[part][k]), (part, k)
    with torch.no_grad():
        for k, p in st["params"].named_parameters():
            p.copy_(loaded["params"][k])
    st["opt"] = {**loaded["opt"], "step": torch.tensor(2, dtype=torch.int32)}
    got = float(cell.run(st, step=2)["loss"])
    assert got == pytest.approx(grids[(2, 2)][0]["metrics"][2]["loss"], **STEP_TOL)


def test_elastic_restore_from_one_rank_to_the_grid(runs):
    """The one-rank checkpoint restored on (2, 2): every rank's slices are
    bit for bit the slices of the saved tensors."""
    _, one, grids = runs
    saved = one["two_steps"]
    for rank in grids[(2, 2)]:
        m = dataclasses.replace(abstract_mesh((2, 2), ("data", "model")),
                                rank=rank["coords"]["data"] * 2 + rank["coords"]["model"])
        cell = _train_cell(abstract_mesh((2, 2), ("data", "model")), 2)
        for k, got in rank["restored"].items():
            want = shd.local(torch.from_numpy(saved["params"][k]), cell.pspecs[k], m).numpy()
            assert np.array_equal(got, want), k
        for k, got in rank["restored_mu"].items():
            spec = cell.in_shardings[1]["mu"][k].spec
            want = shd.local(torch.from_numpy(saved["mu"][k]), spec, m).numpy()
            assert np.array_equal(got, want), k


def test_trainer_resumes_across_data_degrees(runs):
    """A one-process run checkpointed at step 2 resumes on (2, 2), and a
    (2, 2) run checkpointed at step 2 resumes in one process: each finishes
    with the uninterrupted one-process run's losses."""
    _, one, grids = runs
    ref = [m["loss"] for m in one["trainer_ref"]]
    for rank in grids[(2, 2)]:
        assert [m["loss"] for m in rank["resumed"]] == pytest.approx(ref[2:], **STEP_TOL)
        assert [m["loss"] for m in rank["grid_first"]] == pytest.approx(ref[:2], **STEP_TOL)
    resumed = one["grid_resumed"]
    assert resumed["resumed_from"] == 2
    assert [m["loss"] for m in resumed["metrics"]] == pytest.approx(ref[2:], **STEP_TOL)


@pytest.mark.parametrize("name", ["prefill", "decode", "granite"])
def test_serve_cells_at_model_2_equal_model_1(runs, name):
    _, one, grids = runs
    for rank in grids[(2, 2)]:
        np.testing.assert_allclose(rank[name], one[name], **F32_TOL)
        assert rank[name + ".moe_calls"] == 0
    shape, spec = grids[(2, 2)][0]["granite.k"]
    assert spec == ("data", "model", None, None) and shape[:2] == (2, DECODE.seq_len // 2)


def test_moe_cell_takes_the_shard_map_path(runs):
    _, one, grids = runs
    layers = _cfg("qwen3_30b_a3b").n_layers
    assert one["moe.moe_calls"] == 0                       # one rank: the local path
    for rank in grids[(2, 2)]:
        assert rank["moe.moe_calls"] == layers
        assert np.isfinite(rank["moe"]).all() and rank["moe"].shape == one["moe"].shape


def test_moe_under_serving_tp_keeps_the_local_path(runs):
    _, _, grids = runs
    cfg = _cfg("qwen3_30b_a3b")
    model = build_model(cfg, device="cpu")
    eng = Engine.from_config(model, EngineConfig(serving=ContinuousConfig(**SERVE)),
                             policy=tpolicy.paper_policy(8, 16), device="cpu")
    rids = [eng.submit(list(range(3 + i, 12 + 2 * i)), 4) for i in range(2)]
    res = eng.run(model.init(0))
    for rank in grids[(4, 1)]:
        assert rank["tp_moe_calls"] == 0
        assert rank["tp_tokens"] == [res["outputs"][r] for r in rids]


def test_guards():
    with pytest.raises(ValueError, match="not runnable"):
        build_cell("llama31_8b", "long_500k", make_local_mesh(), cfg=_cfg())
    with pytest.raises(ValueError, match="none is initialised.*spawn"):
        make_cell_mesh((1, 2))
    cell = build_cell("llama31_8b", "decode_32k", abstract_mesh((1, 2), ("data", "model")),
                      cfg=_cfg(), shape=DECODE)
    with pytest.raises(ValueError, match="not bound"):
        cell.materialize(0, "cpu")
    # the recurrent and encoder-decoder cells materialize sharded: only the
    # unbound mesh stops them
    for arch in ("whisper_medium", "rwkv6_7b"):
        cell = build_cell(arch, "prefill_32k", abstract_mesh((1, 2), ("data", "model")),
                          cfg=_cfg(arch), shape=PREFILL)
        with pytest.raises(ValueError, match="not bound"):
            cell.materialize(0, "cpu")


def test_cell_mesh_of_the_wrong_size_raises_up_front(runs):
    _, _, grids = runs
    assert "needs 2 ranks but the group has 4" in grids[(4, 1)][0]["wrong_size"]
    assert "spawn" in grids[(4, 1)][0]["wrong_size"]


def test_grad_accum_folds_until_it_divides():
    mesh = abstract_mesh((4, 1), ("data", "model"))
    assert build_cell("llama31_8b", "train_4k", mesh, cfg=_cfg(),
                      shape=ShapeCell("x", 8, 8, "train"), grad_accum=16).grad_accum == 2
    assert build_cell("llama31_8b", "train_4k", abstract_mesh((16, 16), ("data", "model")),
                      cfg=tget("llama31_8b")).grad_accum == 16


def test_elastic_restore_different_sharding(tmp_path):
    """The port's counterpart of ``tests/test_checkpoint_fault.py:74``: a
    checkpoint restores onto a mesh's sharding (a 1 x 1 mesh: the whole
    tensor), its values unchanged."""
    tree = {"w": torch.randn(8, 8, generator=torch.Generator().manual_seed(0))}
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, tree)
    sh = {"w": shd.NamedSharding(make_local_mesh(), ("data", "model"))}
    out = load_checkpoint(p, tree, shardings=sh)
    assert torch.equal(out["w"], tree["w"])
    assert shd.local(out["w"], sh["w"].spec, sh["w"].mesh).shape == (8, 8)
