"""The port's partition rules and token-local experts
(``repro_torch.distributed.sharding``, ``repro_torch.models.moe.
_moe_shard_map``) against the JAX package's.

* Spec parity: for all 13 configs on the 16 × 16 and 2 × 16 × 16
  production meshes (descriptions: the port's parameters and caches are
  ``meta`` tensors, the reference's ``jax.eval_shape`` stand-ins), every
  port parameter's ``param_specs`` (with and without ``fsdp``), its
  moments' ``opt_state_specs`` (over both) and every cache leaf's
  ``cache_specs`` equal the spec of the reference leaf it is a layer of,
  with the leaf's stack axis (scan periods, the encoder-decoder's stacks)
  removed; every reference leaf has a port counterpart.  The four cases of
  ``tests/test_sharding.py`` are mirrored.
* MoE parity: ``_moe_shard_map`` at model 2 and 4 (ranks over gloo,
  ``launch.mesh.spawn``) against the reference's on forced host devices,
  run in a subprocess (the host device count must be set before JAX
  starts), and at model 1 in this process against the reference on a 1 × 1
  mesh.  The router is skewed so that experts overflow their capacity.  The
  pruned gate input, the ``(E, C, D)`` slot tensor, is bit-identical on
  every rank (so are the routing, the slots, the dropped pairs and the
  masks); the down input's N:M masks over each rank's ``d_ff`` columns are
  bit-identical; the outputs agree within ``F32_TOL`` (float32 sums in
  another order).

JAX is imported inside the functions that use it, never at the top: each
rank imports this module to find its function, and JAX would add seconds
to every rank's start.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCH_IDS, PAPER_ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.core import policy as tpolicy
from repro_torch.distributed import sharding as shd
from repro_torch.launch.cells import meta_params
from repro_torch.launch.mesh import (abstract_mesh, make_local_mesh, make_production_mesh,
                                     spawn)
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe

ALL = ARCH_IDS + PAPER_ARCH_IDS
MESHES = {"16x16": False, "2x16x16": True}
B, S = 128, 1024                     # the cache cells' batch and depth
F32_TOL = dict(rtol=1e-5, atol=1e-5)
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite runs six
    workers; the ranks take the caller's count); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------- spec parity

@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    import jax

    from repro.configs.base import get_config as jget
    from repro.models import build_model as jbuild

    cfg = jget(arch)
    model = jbuild(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(B, S))
    return cfg, params, cache


def _flat(tree, specs):
    """{path: (shape, spec tuple)} of a reference tree and its spec tree."""
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(str(getattr(k, "key", k)) for k in path): (tuple(leaf.shape), tuple(s))
            for (path, leaf), s in zip(leaves, spec_leaves)}


def _jax_param_path(cfg, name):
    """(the reference leaf a port parameter is a layer of, whether it has
    a leading stack axis)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i, plen = int(parts[1]), len(cfg.block_pattern)
        n_per = cfg.n_layers // plen
        head, stacked = ((("tail", f"t{i - n_per * plen}"), False) if i >= n_per * plen
                         else (("periods", f"b{i % plen}"), True))
        rest = parts[2:]
    elif parts[0] in ("enc_blocks", "dec_blocks"):
        head, stacked, rest = (parts[0],), True, parts[2:]
    else:
        head, stacked, rest = (), False, parts
    if len(rest) >= 2 and rest[-2] == "experts":
        rest = rest + ["w"]
    return head + tuple(rest), stacked


def _jax_cache_path(cfg, i, leaf):
    if cfg.is_encdec:
        return ("blocks", {"k": "self_k", "v": "self_v"}.get(leaf, leaf)), True
    path, stacked = _jax_param_path(cfg, f"blocks.{i}.{leaf}")
    return path, stacked


def _unstacked(want, stacked):
    shape, spec = want
    return (shape[1:], spec[1:]) if stacked else (shape, spec)


def _check_params(cfg, named, port_specs, jflat):
    seen = set()
    for name, t in named.items():
        path, stacked = _jax_param_path(cfg, name)
        assert path in jflat, (name, path)
        seen.add(path)
        assert _unstacked(jflat[path], stacked) == (tuple(t.shape), port_specs[name]), name
    assert seen == set(jflat), sorted(set(jflat) - seen)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ALL)
def test_specs_equal_the_references_leaf_for_leaf(arch, mesh_name):
    from repro.distributed import sharding as jshd
    from repro.launch.mesh import abstract_mesh as jabstract_mesh

    jcfg, params, cache = _jax_trees(arch)
    multi = MESHES[mesh_name]
    jmesh = (jabstract_mesh((2, 16, 16), ("pod", "data", "model")) if multi
             else jabstract_mesh((16, 16), ("data", "model")))
    mesh = make_production_mesh(multi_pod=multi)
    cfg = tget(arch)
    named = dict(meta_params(cfg).named_parameters())
    for fsdp in (False, True):
        jspecs = jshd.param_specs(params, jmesh, jcfg.n_experts, fsdp=fsdp)
        specs = shd.param_specs(named, mesh, cfg.n_experts, fsdp=fsdp)
        _check_params(cfg, named, specs, _flat(params, jspecs))
        jopt = jshd.opt_state_specs(jspecs, params, jmesh)
        opt = shd.opt_state_specs(specs, named, mesh)
        for m in ("mu", "nu"):
            _check_params(cfg, named, opt[m], _flat(params, jopt[m]))
        assert opt["step"] == tuple(jopt["step"]) == ()

    jflat = _flat(cache, jshd.cache_specs(cache, jcfg, jmesh))
    tcache = build_model(cfg, device="meta").init_cache(B, S, paged=False)
    cspecs = shd.cache_specs(tcache, cfg, mesh)
    assert cspecs["pos"] == jflat[("pos",)][1] == ()
    seen = {("pos",)}
    for i, (layer, lspec) in enumerate(zip(tcache["layers"], cspecs["layers"])):
        for leaf, t in layer.items():
            path, stacked = _jax_cache_path(cfg, i, leaf)
            seen.add(path)
            assert _unstacked(jflat[path], stacked) == (tuple(t.shape), lspec[leaf]), (i, leaf)
    assert seen == set(jflat)


# the four cases of tests/test_sharding.py

@pytest.mark.parametrize("arch", ALL)
def test_param_specs_divisible(arch):
    """Every sharded dim divides its axes, for the full configs on 16 × 16."""
    mesh = make_production_mesh()
    named = dict(meta_params(tget(arch)).named_parameters())
    for fsdp in (False, True):
        for name, spec in shd.param_specs(named, mesh, fsdp=fsdp).items():
            for dim, ax in zip(named[name].shape, spec):
                assert dim % shd._pieces(ax, mesh) == 0, (name, spec)


def test_known_rules():
    mesh = make_production_mesh()
    specs = shd.param_specs(meta_params(tget("qwen2_5_32b")), mesh)
    assert specs["blocks.0.q_proj.w"][-1] == "model"          # column-parallel q
    assert specs["blocks.0.o_proj.w"][-2] == "model"          # row-parallel o
    assert specs["blocks.0.mlp.down_proj.w"][-2] == "model"
    assert all(s is None for s in specs["blocks.0.ln1.w"])    # norms replicated
    assert "model" in specs["embed.w"]                         # vocab sharding
    assert specs["lm_head.w"][-1] == "model"
    moe = shd.param_specs(meta_params(tget("qwen3_30b_a3b")), mesh)
    assert moe["blocks.0.moe.experts.gate_proj"] == (None, None, "model")   # d_ff, not E
    assert moe["blocks.0.moe.experts.down_proj"] == (None, "model", None)
    assert moe["blocks.0.moe.router.w"] == (None, None)


def test_whisper_odd_vocab_replicates():
    """Vocab 51865 is not divisible by 16: the embedding shards d_model."""
    specs = shd.param_specs(meta_params(tget("whisper_medium")), make_production_mesh())
    assert specs["embed.w"] == (None, "model")


def test_batch_and_cache_specs():
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.data_axes(mesh) == ("pod", "data")
    assert shd.batch_spec(mesh)[0] == ("pod", "data")
    cfg = tget("granite_34b")     # one KV head: heads must not shard
    cache = build_model(cfg, device="meta").init_cache(128, 1024, paged=False)
    k_spec = shd.cache_specs(cache, cfg, mesh)["layers"][0]["k"]
    assert k_spec[-2] is None
    assert k_spec[-3] == "model"  # the sequence instead
    assert k_spec[-4] == ("pod", "data")
    assert shd.shard_zero1((64, 256), mesh) == (None, ("pod", "data"))
    assert shd.shard_zero1((5, 7), mesh) == (None, None)
    assert shd.shard_zero1((64, 256), None) is None


def test_local_mesh_and_descriptions():
    assert make_local_mesh().shape == {"data": 1, "model": 1}
    assert make_production_mesh().size == 256
    assert make_production_mesh(multi_pod=True).size == 512
    with pytest.raises(ValueError, match="description"):
        make_production_mesh().group(("model",))


# ------------------------------------------------------------- MoE parity

def _moe_case():
    """The smoke Qwen3 MoE in float32 with d_ff 128 (32 columns a rank at
    model 4: groups of 16 stay whole), 8 experts top-2, a router skewed to
    experts 0 and 1 so that they overflow their 16 slots."""
    cfg = dataclasses.replace(tget_smoke("qwen3_30b_a3b"), moe_d_ff=128, dtype="float32")
    rng = np.random.default_rng(7)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    router = (rng.standard_normal((d, e)) * d**-0.5).astype(np.float32)
    w = dict(router=router,
             gate=(rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
             up=(rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
             down=(rng.standard_normal((e, f, d)) * f**-0.5).astype(np.float32),
             x=rng.standard_normal((2, 16, d)).astype(np.float32))
    w["x"][..., :8] += 2.0
    w["router"][:8, :2] += 1.0
    return cfg, w


_JAX_MOE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core.policy import paper_policy
from repro.launch.mesh import make_mesh_auto
from repro.models import moe

w = dict(np.load(sys.argv[1]))
seen = []
_orig = moe._maybe_prune

def _spy(x, module, policy, phase):
    out = _orig(x, module, policy, phase)
    jax.debug.callback(lambda i, a: seen.append((module, int(i), np.asarray(a))),
                       jax.lax.axis_index("model"), out)
    return out

moe._maybe_prune = _spy
p = {"router": {"w": jnp.asarray(w["router"])},
     "experts": {"gate_proj": {"w": jnp.asarray(w["gate"])},
                 "up_proj": {"w": jnp.asarray(w["up"])},
                 "down_proj": {"w": jnp.asarray(w["down"])}}}
out = {}
for m in (1, 2, 4):
    seen.clear()
    mesh = make_mesh_auto((1, m), ("data", "model"))
    y = jax.jit(lambda x, p: moe._moe_shard_map(mesh, x, p, paper_policy(8, 16), "prefill",
                                                2, "silu", None))(jnp.asarray(w["x"]), p)
    out[f"{m}/y"] = np.asarray(y)
    jax.effects_barrier()
    for module, i, a in seen:
        out[f"{m}/{module}/{i}"] = a
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    cfg, w = _moe_case()
    d = tmp_path_factory.mktemp("moe")
    np.savez(d / "in.npz", **w)
    env = {**os.environ, "PYTHONPATH": _SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", _JAX_MOE, str(d / "in.npz"),
                           str(d / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(d / "out.npz"))


def _moe_module(cfg, w, mesh):
    """The port's MoE holding ``w``, its expert stacks this rank's d_ff
    shards on ``mesh`` (tagged as a cell holds them)."""
    p = tmoe.init_moe(cfg.d_model, cfg.moe_d_ff, cfg.n_experts, False, dtype=torch.float32,
                      device="cpu", generator=torch.Generator().manual_seed(0))
    specs = {"gate": (None, None, "model"), "up": (None, None, "model"),
             "down": (None, "model", None)}
    with torch.no_grad():
        p.router.w.copy_(torch.from_numpy(w["router"]))
        for k, name in (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj")):
            whole = torch.from_numpy(w[k])
            t = torch.nn.Parameter(shd.local(whole, specs[k], mesh).contiguous()
                                   if mesh.bound else whole, requires_grad=False)
            if mesh.bound:
                shd.tag(t, specs[k], mesh, whole.shape)
            p.experts._parameters[name] = t
    return p


def _moe_run(mesh, cfg, w):
    """This rank's ``_moe_shard_map`` output, its prune inputs' outputs in
    call order, and the pairs it dropped."""
    seen = []
    orig = tmoe._maybe_prune

    def spy(x, module, policy, phase):
        out = orig(x, module, policy, phase)
        seen.append((module, out.detach().numpy().copy()))
        return out

    tmoe._maybe_prune = spy
    tmoe.shard_map_stats.update(calls=0, pairs=0, dropped=0)
    try:
        y = tmoe._moe_shard_map(mesh, torch.from_numpy(w["x"]), _moe_module(cfg, w, mesh),
                                tpolicy.paper_policy(8, 16), "prefill", cfg.top_k, "silu",
                                None)
    finally:
        tmoe._maybe_prune = orig
    return y.numpy(), seen, dict(tmoe.shard_map_stats)


def _moe_rank(mesh, cfg, w):
    import torch.distributed as dist

    mine = (mesh.coords()["model"],) + _moe_run(mesh, cfg, w)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return everyone


@pytest.fixture(scope="module")
def port_moe(tmp_path_factory):
    cfg, w = _moe_case()
    out = {1: [(0,) + _moe_run(make_local_mesh(), cfg, w)]}
    for m in (2, 4):
        out[m] = spawn(_moe_rank, m, cfg, w, device="cpu",
                       store_dir=str(tmp_path_factory.mktemp(f"moe{m}")),
                       grid=((1, m), ("data", "model")))
    return out


@pytest.mark.parametrize("m", [1, 2, 4])
def test_moe_shard_map_matches_jax(jax_moe, port_moe, m):
    for rank, y, seen, stats in port_moe[m]:
        np.testing.assert_allclose(y, jax_moe[f"{m}/y"], **F32_TOL)
        mods = [mod for mod, _ in seen]
        assert mods == ["gate_proj", "up_proj", "down_proj"], mods
        gate, down = seen[0][1], seen[2][1]
        # the pruned (E, C, D) slots: the same routing, slots, drops and masks
        assert np.array_equal(gate, jax_moe[f"{m}/gate_proj/{rank}"])
        assert down.shape[-1] == 128 // m
        assert np.array_equal(down != 0, jax_moe[f"{m}/down_proj/{rank}"] != 0)
        assert stats["calls"] == 1 and stats["capacity"] == 16
        assert 0 < stats["dropped"] < stats["pairs"], stats


def test_moe_masks_equal_the_unsharded_masks(port_moe):
    """Groups of 16 never straddle a 64- or 32-column shard, so the down
    input's masks, concatenated over the ranks, are model 1's."""
    whole = port_moe[1][0][2][2][1] != 0
    for m in (2, 4):
        got = np.concatenate([seen[2][1] != 0 for _, _, seen, _ in
                              sorted(port_moe[m], key=lambda r: r[0])], axis=-1)
        assert np.array_equal(got, whole)


def test_moe_dispatch_follows_the_mesh():
    """Under a mesh of more than one rank ``moe`` takes the shard-map path
    (where the batch divides over DP); under none, or a 1 × 1 mesh, or a
    batch of 1 over 2 DP ranks, the local one."""
    cfg, w = _moe_case()
    p = _moe_module(cfg, w, make_local_mesh())
    x = torch.from_numpy(w["x"])
    pol = tpolicy.paper_policy(8, 16)
    calls = []
    orig = tmoe._moe_shard_map
    tmoe._moe_shard_map = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        tmoe.moe(x, p, pol, "prefill", 2)
        with shd.mesh_scope(make_local_mesh()):
            tmoe.moe(x, p, pol, "prefill", 2)
        assert calls == []
        with shd.mesh_scope(abstract_mesh((2, 1), ("data", "model"))):
            tmoe.moe(x[:1], p, pol, "prefill", 2)
            assert calls == []
        with shd.mesh_scope(abstract_mesh((2, 1), ("data", "model")), batch_shards=2):
            tmoe.moe(x[:1], p, pol, "prefill", 2)
        assert calls == [1]
    finally:
        tmoe._moe_shard_map = orig
