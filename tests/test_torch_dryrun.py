"""The port's dry-run (``repro_torch.launch.dryrun``): one rank's share of a
cell's step executed on ``meta`` tensors (a dry rank, ``sharding.Mesh.at``),
counted (``launch/roofline.count_step``), and ``roofline_exact``.

Held to the JAX package where it computes the same thing: each rank's
argument bytes equal XLA's compiled ``argument_size_in_bytes`` on a 2 × 2
mesh of 4 host devices (the smoke LLaMA-3.1 and Qwen3-30B-A3B train,
prefill and decode cells, and the prefill and decode cells of RWKV6-7B,
RecurrentGemma-2B and Whisper-medium); the forward products' FLOPs of
unsharded smoke prefill and decode cells under ``DENSE`` equal the sum over
the reference's jaxpr of its ``dot_general`` and ``ragged_dot_general``
operations (scan bodies times their length): every product, the
attention's included, is counted exactly alike (LLaMA-3.1, Qwen3-30B-A3B,
Whisper-medium, and RecurrentGemma-2B's decode).  Where the products are
other operations they are not asserted: RWKV6-7B's WKV is another
algorithm here (``wkv_chunked``, sub-chunks of 16 tokens, against the
reference's token scan), and RecurrentGemma-2B's banded prefill attention
takes each query chunk's ``window + chunk`` keys from the sequence's start
where the reference pads every slab to that width.  The compiled argument
size leaves out what the step never reads (jit prunes it: an
encoder-decoder decode step's encoder and cross k/v projections), which
the port's count keeps.  JAX
runs in a subprocess, one start for both.

Held to the port's own bound ranks: four gloo ranks on a (data 2, model 2)
cell mesh run the smoke cells (the kernels' column-parallel path in their
plain versions, the MoE's ``_moe_shard_map``, ZeRO-1/2 training), and each
dry rank records the same collectives, in the same order, and holds the
same bytes (RWKV6-7B's prefill on its heads of ``S`` and Whisper-medium's
on its heads of the self and cross K/V among them).  The tile-consensus
prefill of a model with q/k/v biases at model 2 equals one rank's (it added
a column shard of the bias to the gathered output until the dry-run found
it).  The ``--both`` sweep covers all 13 archs × 4 shapes × 2 meshes with no
``FAIL`` and none ``unported``, here on the smoke configs at
``SMOKE_SHAPES`` (the full sweep takes ~40 min of one core).

No JAX at the top of the module: the ranks import it to find their function.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs.base import ShapeCell
from repro_torch.core import policy as tpolicy
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, roofline_exact
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import abstract_mesh, make_local_mesh, make_production_mesh, spawn

ROOT = Path(__file__).resolve().parents[1]
_SRC = str(ROOT / "src")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
CELLS = [(a, s) for a in ("llama31_8b", "qwen3_30b_a3b")
         for s in ("train_4k", "prefill_32k", "decode_32k")] + [("mixtral_8x7b", "train_4k")] \
    + [(a, s) for a in ("rwkv6_7b", "recurrentgemma_2b", "whisper_medium")
       for s in ("prefill_32k", "decode_32k")]
FLOP_CELLS = [(a, k) for a in ("llama31_8b", "qwen3_30b_a3b", "whisper_medium")
              for k in ("prefill", "decode")] + [("recurrentgemma_2b", "decode")]
B, T, S = 2, 64, 64          # the FLOP cells: B x T prompts, an S-deep cache
# the smoke sweep: (seq, batch) a shape, a multiple of both production meshes'
# DP degrees (16 and 32) where the reference's is
SMOKE_SHAPES = {"train_4k": (16, 32), "prefill_32k": (16, 32), "decode_32k": (32, 32),
                "long_500k": (64, 1)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite runs six
    workers; the ranks take the caller's count); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_JAX = """
import json, math, sys
import jax, jax.numpy as jnp
from repro.configs.base import get_smoke_config
from repro.core.policy import DENSE
from repro.launch.cells import build_cell
from repro.launch.mesh import make_mesh_auto
from repro.models import build_model

cells, flop_cells, (B, T, S) = json.loads(sys.argv[1])
mesh = make_mesh_auto((2, 2), ("data", "model"))
args = {}
for arch, shape in cells:
    cell = build_cell(arch, shape, mesh, cfg=get_smoke_config(arch))
    with mesh:
        ma = cell.lower(mesh).compile().memory_analysis()
    args[f"{arch}/{shape}"] = int(ma.argument_size_in_bytes)


def walk(jaxpr, mult=1):
    tot = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        a = eqn.invars[0].aval.shape if eqn.invars else ()
        if name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            b = eqn.invars[1].aval.shape
            tot += mult * 2 * math.prod(a[i] for i in lb) * math.prod(a[i] for i in lc) \\
                * math.prod(a[i] for i in range(len(a)) if i not in lc and i not in lb) \\
                * math.prod(b[i] for i in range(len(b)) if i not in rc and i not in rb)
        elif name.startswith("ragged_dot"):
            tot += mult * 2 * a[0] * a[1] * eqn.invars[1].aval.shape[-1]
        assert name != "while", "a while loop: its trips are not static"
        for sub in eqn.params.values():
            for s in (sub if isinstance(sub, (list, tuple)) else [sub]):
                j = getattr(s, "jaxpr", s)
                if hasattr(j, "eqns"):
                    tot += walk(j, mult * (eqn.params["length"] if name == "scan" else 1))
    return tot


flops = {}
for arch, kind in flop_cells:
    m = build_model(get_smoke_config(arch))
    p = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: m.init_cache(B, S))
    if kind == "prefill":
        fn = lambda p, t, c: m.prefill(p, t, c, policy=DENSE)
        toks = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32)}
        if m.cfg.is_encdec:
            toks["frame_embeds"] = jax.ShapeDtypeStruct((B, m.cfg.encoder_seq, m.cfg.d_model),
                                                        jnp.bfloat16)
    else:
        fn = lambda p, t, c: m.decode_step(p, t, c, policy=DENSE)
        toks = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    flops[f"{arch}/{kind}"] = walk(jax.make_jaxpr(fn)(p, toks, cache).jaxpr)
print(json.dumps({"args": args, "flops": flops}))
"""


@pytest.fixture(scope="module")
def jax_side():
    """The reference's compiled argument sizes and jaxpr product FLOPs, in
    one subprocess with 4 host devices (~20 s of one core)."""
    env = {**os.environ, "PYTHONPATH": _SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", _JAX, json.dumps([CELLS, FLOP_CELLS,
                                                                    [B, T, S]])],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _dry_cell(arch, shape, rank=0, grid=(2, 2), **kw):
    return build_cell(arch, shape, abstract_mesh(grid, ("data", "model")).at(rank),
                      cfg=kw.pop("cfg", tget(arch)), **kw)


def _unread_bytes(cell):
    """The rank's bytes of the arguments its step never reads, which jit
    prunes from the compiled executable: an encoder-decoder decode step's
    encoder and cross-attention k/v projections (it reads the cached cross
    K/V instead)."""
    if not (cell.cfg.is_encdec and cell.shape.kind == "decode"):
        return 0
    return sum(dryrun._leaf_bytes(p, cell.in_shardings[0][k], cell.mesh)
               for k, p in cell.args[0].named_parameters()
               if k.startswith("enc_") or ".cross_attn.k_proj." in k
               or ".cross_attn.v_proj." in k)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_args_match_jax_compiled_argument_size(jax_side, arch, shape):
    for rank in range(4):        # every rank's shard has the same size here
        cell = _dry_cell(arch, shape, rank)
        assert dryrun.args_bytes(cell) - _unread_bytes(cell) == \
            jax_side["args"][f"{arch}/{shape}"]
    assert _unread_bytes(cell) > 0 or arch != "whisper_medium" or shape != "decode_32k"


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dry_rank_state_is_shapes_holding_its_args(arch, shape):
    """``materialize(device="meta")`` on a dry rank: every tensor on
    ``meta``; it holds the arguments' bytes (a train cell's batch aside,
    which a rank draws each step)."""
    cell = _dry_cell(arch, shape, rank=3)
    state = cell.materialize(device="meta")
    leaves = roofline_leaves(state)
    assert leaves and all(t.is_meta for t in leaves)
    batch = 0
    if shape == "train_4k":
        tok = cell.args[2]["tokens"]
        batch = tok.shape[0] // 2 * tok.shape[1] * 4
    assert dryrun.state_bytes(state) + batch == dryrun.args_bytes(cell)


def roofline_leaves(state):
    from repro_torch.launch.roofline import _leaves

    return _leaves([state[k] for k in ("params", "opt", "cache", "tokens") if k in state])


@pytest.mark.parametrize("arch,kind", FLOP_CELLS)
def test_forward_product_flops_match_the_jaxpr(jax_side, arch, kind):
    shape = ShapeCell(f"{kind}_32k", T if kind == "prefill" else S, B, kind)
    r = dryrun.run_cell(arch, f"{kind}_32k", policy=tpolicy.DENSE, cfg=tget(arch),
                        shape=shape, mesh=make_local_mesh())
    assert r["status"] == "ok"
    assert r["flops_per_device"] == jax_side["flops"][f"{arch}/{kind}"]
    assert r["ops_per_device"]["fp32"] > 0       # the attention's float32 products
    assert r["collectives"] == {"all_gather": [0, 0], "all_reduce": [0, 0],
                                "tp_gather": [0, 0]}


# ------------------------------------------------- dry ranks against bound ones

PREFILL = ShapeCell("cut", 16, 4, "prefill")
DECODE = ShapeCell("cut", 32, 4, "decode")
TRAIN = ShapeCell("cut", 32, 8, "train")


def _f32(arch):
    return dataclasses.replace(tget(arch), dtype="float32")


def _cases():
    """name → a function of a mesh that builds the cell (smoke, float32)."""
    kern = lambda arch, **kw: tpolicy.paper_policy(8, 16, tget(arch).qgate_skip_layers,
                                                   use_kernels=True).with_(**kw)
    return {
        "llama prefill": lambda m: build_cell("llama31_8b", "prefill_32k", m, cfg=_f32(
            "llama31_8b"), policy=kern("llama31_8b"), shape=PREFILL),
        "llama decode": lambda m: build_cell("llama31_8b", "decode_32k", m, cfg=_f32(
            "llama31_8b"), shape=DECODE),
        "llama train": lambda m: build_cell("llama31_8b", "train_4k", m, cfg=_f32(
            "llama31_8b"), grad_accum=2, shape=TRAIN),
        "qwen3 prefill": lambda m: build_cell("qwen3_30b_a3b", "prefill_32k", m, cfg=_f32(
            "qwen3_30b_a3b"), policy=kern("qwen3_30b_a3b"), shape=PREFILL),
        "qwen2 tile-consensus prefill": lambda m: build_cell(
            "qwen2_7b", "prefill_32k", m, cfg=_f32("qwen2_7b"),
            policy=kern("qwen2_7b", tile_consensus=True, tile_size=8), shape=PREFILL),
        "rwkv6 prefill": lambda m: build_cell("rwkv6_7b", "prefill_32k", m, cfg=_f32(
            "rwkv6_7b"), policy=kern("rwkv6_7b"), shape=PREFILL),
        "whisper prefill": lambda m: build_cell("whisper_medium", "prefill_32k", m, cfg=_f32(
            "whisper_medium"), policy=kern("whisper_medium"), shape=PREFILL),
    }


def _run(cell, device):
    """(held bytes, the collectives recorded without their axes, the
    tallies' deltas, the logits of a prefill) of one step on ``device``."""
    state = cell.materialize(0, device)
    held = dryrun.state_bytes(state)
    before = dryrun._tallies()
    with shd.recording() as log:
        out = cell.run(state)
    after = dryrun._tallies()
    logits = out[0].detach().clone() if cell.shape.kind == "prefill" and device == "cpu" \
        else None
    return (held, [r[:3] for r in log],
            {k: [after[k][0] - before[k][0], after[k][1] - before[k][1]] for k in after},
            logits)


def bound_rank(mesh):
    """A rank of the (2, 2) cell mesh: every case's step."""
    return {name: _run(build(mesh), "cpu") for name, build in _cases().items()}


@pytest.fixture(scope="module")
def bound(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dry"))
    ranks = spawn(_gather_ranks, 4, device="cpu", store_dir=root,
                  grid=((2, 2), ("data", "model")))
    return ranks


def _gather_ranks(mesh):
    mine = bound_rank(mesh)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return everyone


@pytest.mark.parametrize("name", list(_cases()))
def test_dry_ranks_equal_the_bound_ranks(bound, name):
    for rank in range(4):
        held, log, tallies, _ = bound[rank][name]
        mesh = abstract_mesh((2, 2), ("data", "model")).at(rank)
        d_held, d_log, d_tallies, _ = _run(_cases()[name](mesh), "meta")
        assert (d_held, d_tallies) == (held, tallies), (name, rank)
        assert d_log == log and log, (name, rank)


def test_tile_consensus_with_biases_at_model_2_equals_one_rank(bound):
    """The repair the dry-run found: a biased projection under tile
    consensus adds its bias whole, after the gather of its columns."""
    name = "qwen2 tile-consensus prefill"
    want = _run(_cases()[name](make_local_mesh()), "cpu")[3]
    for rank in range(4):
        got = bound[rank][name][3]
        torch.testing.assert_close(got, want, **F32_TOL)


def test_a_dry_rank_runs_no_collective(monkeypatch):
    """Every collective of a dry rank is recorded, none run; a bound mesh
    cannot be made dry, and a plain description of more than one rank is
    still refused."""
    def boom(*a, **k):
        raise AssertionError("a dry rank ran a collective")

    for name in ("all_reduce", "all_gather", "isend", "irecv", "get_rank"):
        monkeypatch.setattr(dist, name, boom)
    r = dryrun.run_cell("llama31_8b", "train_4k", cfg=_f32("llama31_8b"), shape=TRAIN,
                        grad_accum=2, mesh=abstract_mesh((2, 2), ("data", "model")), rank=1)
    assert r["status"] == "ok" and r["collectives"]["all_reduce"][0] > 0
    desc = abstract_mesh((2, 2), ("data", "model"))
    cell = build_cell("llama31_8b", "decode_32k", desc, cfg=_f32("llama31_8b"), shape=DECODE)
    with pytest.raises(ValueError, match="dry rank"):
        cell.materialize(0, "meta")
    bound_like = dataclasses.replace(desc.at(0), dry=False)
    with pytest.raises(ValueError, match="bound"):
        bound_like.at(1)
    assert desc.at(2).coords() == {"data": 1, "model": 0}
    assert desc.at(2).lanes(("model",))[0].ranks == (2, 3)


def test_gather_to_root_on_a_dry_rank_stays_on_meta():
    mesh = abstract_mesh((1, 2), ("data", "model")).at(0)
    t = torch.empty(4, 3, device="meta")
    with shd.recording() as log:
        whole = shd.gather_to_root(t, (None, "model"), mesh)
    assert whole.is_meta and whole.shape == (4, 6)
    assert log == [("gather_to_root", 4 * 6 * 4, 2, ("data", "model"))]


# --------------------------------------------------- roofline_exact, the sweep

@pytest.mark.parametrize("arch,shape", [("llama31_8b", "train_4k"),
                                        ("qwen2_7b", "prefill_32k"),
                                        ("qwen3_30b_a3b", "decode_32k")])
def test_roofline_exact_equals_the_full_depth_count(monkeypatch, arch, shape):
    """The two-point extrapolation over layers equals the full-depth count
    (``run_cell_exact`` raises otherwise) on the smoke configs; qwen2_7b's
    smoke skip list (0, 3) takes the skipped layers' own slope."""
    from repro_torch.configs import base

    monkeypatch.setattr(base, "get_config", tget)
    pol = tpolicy.paper_policy(8, 16, tget(arch).qgate_skip_layers)
    r = roofline_exact.run_cell_exact(arch, shape, policy=pol)
    assert r["status"] == "ok" and r["full_depth_equal"]
    assert r["flops_per_device"] > 0 and r["dominant"] in ("compute", "memory", "collective")


def test_both_sweep_has_no_fail(monkeypatch, tmp_path, capsys):
    """All 13 archs × 4 shapes × 2 meshes (smoke configs at ``SMOKE_SHAPES``):
    every cell ok or skipped as in the reference; none unported (every
    family trains, the recurrent and encoder-decoder train cells
    included)."""
    from repro_torch.launch.cells import cell_by_name

    real = dryrun.run_cell

    def smoke(arch, shape, multi_pod, policy=None):
        seq, batch = SMOKE_SHAPES[shape]
        return real(arch, shape, multi_pod, policy, cfg=tget(arch),
                    shape=ShapeCell(shape, seq, batch, cell_by_name(shape).kind))

    monkeypatch.setattr(dryrun, "run_cell", smoke)
    out = tmp_path / "sweep.json"
    assert dryrun.main(["--both", "--json", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 13 * 4 * 2
    by = {}
    for r in rows:
        by.setdefault(r["status"], []).append(r)
    assert {k: len(v) for k, v in by.items()} == {"ok": 84, "skipped": 20}
    assert {r["arch"] for r in by["ok"] if r["shape"] == "train_4k"} >= {
        "rwkv6_7b", "recurrentgemma_2b", "whisper_medium"}
    assert all(r["shape"] == "long_500k" for r in by["skipped"])
    assert capsys.readouterr().out.splitlines()[-1] == \
        "[dryrun] done: 84 ok, 20 skipped, 0 unported, 0 failed"


def test_unported_cells_carry_the_refusal():
    """The train cells that carried the refusal until the recurrent and
    encoder-decoder families trained run now, as the MoE's does: each at
    full width, cut to depth 2 and 16 x 64 tokens (the full cells take
    minutes of one core; Whisper-medium over its 1500 frames), RWKV6-7B on
    the multi-pod mesh, its recurrence on the rank's heads: the gathers of
    the WKV's output and of its inputs' cotangents."""
    from repro_torch.configs import get_config

    cut = ShapeCell("train_4k", 64, 16, "train")
    r = dryrun.run_cell("qwen3_30b_a3b", "train_4k",
                        cfg=dataclasses.replace(get_config("qwen3_30b_a3b"), n_layers=2),
                        shape=cut, grad_accum=1)
    assert r["status"] == "ok" and r["collectives"]["all_reduce"][0] > 0
    r = dryrun.run_cell("whisper_medium", "train_4k", grad_accum=1, shape=cut,
                        cfg=dataclasses.replace(get_config("whisper_medium"), n_layers=2,
                                                n_encoder_layers=2))
    assert r["status"] == "ok" and r["collectives"]["all_reduce"][0] > 0
    cfg = dataclasses.replace(get_config("rwkv6_7b"), n_layers=2)
    r = dryrun.run_cell("rwkv6_7b", "train_4k", multi_pod=True, grad_accum=1, shape=cut,
                        cfg=cfg)
    assert r["status"] == "ok"
    cell = build_cell("rwkv6_7b", "train_4k", make_production_mesh(multi_pod=True).at(0),
                      cfg=cfg, shape=cut, grad_accum=1)
    log = _run(cell, "meta")[1]
    sizes = collections.Counter(n for kind, n, size in log if kind == "all_gather" and size == 16)
    # per layer, over the 16 model ranks (the batch of 16 whole on each of
    # the 32 DP ranks): the WKV output's gather in the forward and in remat's
    # recompute, and the bf16 cotangents of r, k and v gathered whole in the
    # backward; u's float32 one
    whole = cut.global_batch * cut.seq_len * cfg.d_model
    assert sizes[2 * whole] == 5 * cfg.n_layers and sizes[4 * cfg.d_model] == cfg.n_layers
    r = dryrun.run_cell("llama31_8b", "long_500k")
    assert r == {"arch": "llama31_8b", "shape": "long_500k", "mesh": "16x16",
                 "status": "skipped",
                 "why": "full-attention arch at 524k context (skip per spec)"}
