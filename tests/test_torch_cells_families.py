"""The sharded cells of the recurrent and encoder-decoder families
(``repro_torch.launch.cells``): RWKV6-7B, RecurrentGemma-2B and
Whisper-medium, their smoke configs in float32.

One start of four gloo ranks on a ``(data 2, model 2)`` cell mesh runs the
prefill cell (``paper_policy(8, 16)`` on the kernels: their column-parallel
path in their plain versions on the CPU) and the decode cell (seeded
states) of each arch, and returns what every rank found.  Held to:

* this process's one-rank cells: every rank's logits within ``F32_TOL``
  (a batch split over DP runs the products at other shapes), and each
  rank's new cache is the ``cache_specs`` slice of one rank's (its shape
  exactly, its values within ``F32_TOL``): RWKV6's ``S`` on its heads,
  RecurrentGemma-2B's one-KV-head ring on its sequence, Whisper's self and
  cross K/V on heads, every other state on batch;
* the JAX model: the one-rank prefill cell built from the JAX weights
  (``weights.from_jax_params``, ``Cell.materialize(weights=...)``) prefills
  all but the last of its tokens (a row of its cache left for the decode
  step), then decodes one greedy token; both logits within ``F32_TOL`` of
  the JAX model's ``prefill`` and ``decode_step`` on the same weights and
  inputs (``paper_policy(8, 16)`` without scales on both sides);
* a decode cell seeds every state leaf it holds (nonzero) from its own
  ``(seed, name)``.

JAX is imported inside the functions that use it, never at the top: each
rank imports this module to find its function.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs.base import ShapeCell
from repro_torch.core import policy as tpolicy
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import abstract_mesh, make_local_mesh, spawn

F32_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("rwkv6_7b", "recurrentgemma_2b", "whisper_medium")
KINDS = ("prefill", "decode")
PREFILL = ShapeCell("cut", 16, 4, "prefill")     # RecurrentGemma's ring of 8 wraps
DECODE = ShapeCell("cut", 32, 4, "decode")
GRID = (2, 2)


def _cfg(arch):
    return dataclasses.replace(tget(arch), dtype="float32")


def _kern():
    return tpolicy.paper_policy(8, 16, use_kernels=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite runs six
    workers; the ranks take the caller's count); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cell(arch, kind, mesh):
    if kind == "prefill":
        return build_cell(arch, "prefill_32k", mesh, policy=_kern(), cfg=_cfg(arch),
                          shape=PREFILL)
    return build_cell(arch, "decode_32k", mesh, cfg=_cfg(arch), shape=DECODE)


def _leaves(cache):
    return [{k: t.detach().numpy().copy() for k, t in layer.items()}
            for layer in cache["layers"]]


def _run(arch, kind, mesh):
    """(logits, the cache before the step, the cache after it, the
    column-parallel gathers of the step), numpy."""
    cell = _cell(arch, kind, mesh)
    state = cell.materialize(0, "cpu")
    before = _leaves(state["cache"])
    calls = tp.gather.calls
    logits, cache = cell.run(state)
    return logits.numpy(), before, _leaves(cache), tp.gather.calls - calls


def family_rank(mesh):
    """One rank: every arch's prefill and decode cell on ``mesh``."""
    out = {"rank": mesh.rank}
    for arch in ARCHS:
        for kind in KINDS:
            out[arch, kind] = _run(arch, kind, mesh)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, out)
    return everyone


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """This process's one-rank cells, then the ranks."""
    root = str(tmp_path_factory.mktemp("families"))
    one = {(arch, kind): _run(arch, kind, make_local_mesh()) for arch in ARCHS
           for kind in KINDS}
    ranks = spawn(family_rank, 4, device="cpu", store_dir=root,
                  grid=(GRID, ("data", "model")))
    return one, ranks


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_cells_at_model_2_equal_one_rank(runs, arch, kind):
    one, ranks = runs
    want = one[arch, kind][0]
    assert want.shape == (PREFILL.global_batch, _cfg(arch).vocab_size)
    for rank in ranks:
        np.testing.assert_allclose(rank[arch, kind][0], want, **F32_TOL)
        # the kernels' projections ran column-parallel on held shards
        assert (rank[arch, kind][3] > 0) == (kind == "prefill")
    assert one[arch, kind][3] == 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_ranks_state_is_its_cache_specs_slice(runs, arch, kind):
    one, ranks = runs
    desc = abstract_mesh(GRID, ("data", "model"))
    specs = _cell(arch, kind, desc).in_shardings[2]["layers"]
    whole = one[arch, kind][2]
    split = set()
    for rank in ranks:
        mesh = dataclasses.replace(desc, rank=rank["rank"])
        for i, (layer, lspec) in enumerate(zip(rank[arch, kind][2], specs)):
            for name, got in layer.items():
                spec = lspec[name].spec
                want = shd.local(torch.from_numpy(whole[i][name]), spec, mesh).numpy()
                assert got.shape == want.shape, (i, name)
                np.testing.assert_allclose(got, want, err_msg=f"{i} {name}", **F32_TOL)
                split.update((name, e) for e in spec if e is not None)
    # what each family holds where (cache_specs)
    want = {"rwkv6_7b": {("S", "model"), ("S", "data"), ("tm_shift", "data"),
                         ("cm_shift", "data")},
            "recurrentgemma_2b": {("k", "model"), ("v", "model"), ("k", "data"), ("v", "data"),
                                  ("h", "data"), ("conv", "data")},
            "whisper_medium": {(n, a) for n in ("k", "v", "cross_k", "cross_v")
                               for a in ("model", "data")}}[arch]
    assert split == want


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cells_seed_every_state_leaf(runs, arch):
    one, _ = runs
    for i, layer in enumerate(one[arch, "decode"][1]):
        for name, t in layer.items():
            assert np.count_nonzero(t), (arch, i, name)
    # the prefill cell starts from zeros
    for layer in one[arch, "prefill"][1]:
        assert not any(np.count_nonzero(t) for t in layer.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_cell_matches_jax(arch):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_smoke_config as jget
    from repro.core.policy import paper_policy as jpaper
    from repro.models import build_model as jbuild
    from repro_torch.weights import from_jax_params

    cfg = _cfg(arch)
    jm = jbuild(dataclasses.replace(jget(arch), dtype="float32"))
    params = jm.init(jax.random.PRNGKey(0))
    model = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    cell = _cell(arch, "prefill", make_local_mesh())
    state = cell.materialize(0, "cpu", weights=dict(model.named_parameters()))
    state["tokens"] = state["tokens"][:, :-1]          # a cache row for the decode step
    batch = {k: state[k] for k in ("tokens", "frame_embeds") if k in state}
    logits, cache = cell.run(state)
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    step, _ = state["model"].decode_step(state["params"], nxt, cache, policy=cell.policy)

    jbatch = {k: jnp.asarray(v.float().numpy() if v.is_floating_point() else v.numpy())
              for k, v in batch.items()}
    jpol = jpaper(8, 16)
    jcache = jm.init_cache(PREFILL.global_batch, PREFILL.seq_len)
    jlogits, jcache = jm.prefill(params, jbatch, jcache, policy=jpol)
    jstep, _ = jm.decode_step(params, jnp.asarray(nxt.numpy()), jcache, policy=jpol)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32_TOL)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **F32_TOL)
