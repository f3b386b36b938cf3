"""The port's tensor-parallel serving (``repro_torch.distributed.tp``,
``repro_torch.launch.mesh``) against the JAX package's, case by case with
``tests/test_sharded_serving.py``.

Ranks are processes started over gloo by ``launch.mesh.spawn`` on a file
store under ``tmp_path``, one intra-op thread each (the caller's, set by
``one_thread``).  Each start costs every
rank a fresh interpreter and a torch import, so one start runs many checks
and returns what they found, and the tests below assert on it:

* kernel level, at 2 and 4 ranks, at the shapes of the reference's
  ``_TP_PARITY`` script: each of the six sharded entry points (the four
  projections of ``kernels.ops``, ``models.attention.paged_attention`` and
  ``paged_kv_update``, the last two on the rank's share of the pools, as
  the executor holds them) under the scope equals the port's unsharded call
  bit for bit on every rank, and the unsharded call equals the JAX
  package's, run here in interpret mode (int8 GEMMs bit-exact; float
  outputs at the tolerances stated where they are compared).  At 4 ranks
  the two KV heads do not divide and a 66-column weight does not either:
  both fall through to the unsharded call and gather nothing.
* engine level, the reference's dp=2/tp=2 scenario (LLaMA-3.1 smoke in
  float32, 4 requests, 6 new tokens, DENSE): tp=2 and dp=2/tp=2 give the
  JAX ``dp=1`` engine's tokens with one dispatch per work iteration; under
  ``paper_policy(8, 16)`` with the kernels' plain versions, and in W8A8,
  tp=2 gives the port's tp=1 tokens, and the ranks' pools, gathered along
  the head axis, equal the tp=1 pools bit for bit.
* the up-front errors and the CLI's ``--tp 2``.

JAX is imported inside the functions that compute the references, never
at the top: each rank imports this module to find its function, and JAX
would add seconds to every rank's start.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.core import quant as tquant
from repro_torch.core.pruner import precompute_scales
from repro_torch.distributed import tp as tp_mod
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import make_serving_mesh, spawn
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
from repro_torch.weights import quantize_linears

SERVE = dict(max_seq=64, num_slots=2, chunk_size=8)
LENS, ARRIVALS = (9, 17, 12, 21), (0, 0, 2, 3)
QPROJS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj")
# the reference's paged shapes: batch, query heads, KV heads, head_dim,
# block size, blocks, tokens, and 3 new rows for the scatter
B, HQ, HKV, HD, BS, NB, T, NEW = 2, 4, 2, 8, 4, 16, 12, 3
PROJECTIONS = ("nm_prune_matmul", "nm_spmm", "osparse_matmul", "osparse_matmul_noprune",
               "w8a8_matmul")
ATTENTION = ("paged_attention", "paged_attention_oracle", "paged_kv_update",
             "paged_kv_update_oracle")
# float32 products of the same kept channels in another summation order
# (torch's CPU matmul against the Pallas dot, the plain attention against
# the Pallas kernel's online softmax)
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's smoke engines run thousands of tiny torch ops: with the
    suite's six workers, torch's intra-op thread pools oversubscribe the
    cores.  One thread while this module runs (the ranks take the caller's
    count); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- kernels

def parity_arrays():
    """The reference's ``_TP_PARITY`` inputs, drawn in its order from
    ``default_rng(0)``, plus a weight of 66 columns for the fall-through."""
    rng = np.random.default_rng(0)
    a = dict(x=rng.standard_normal((5, 32)), w=rng.standard_normal((32, 64)),
             b=rng.standard_normal((64,)), scale=rng.random(32) + 0.5,
             wq=rng.integers(-127, 127, (32, 64)), smooth=rng.random(32) + 0.5,
             amber=rng.random(32) + 0.5, ws=rng.random(64) * 0.01 + 0.001,
             act=np.asarray([0.02]), xq=rng.integers(-127, 127, (5, 32)))
    a.update(q=rng.standard_normal((B, T, HQ, HD)), kp=rng.standard_normal((NB, BS, HKV, HD)),
             vp=rng.standard_normal((NB, BS, HKV, HD)),
             kn=rng.standard_normal((B, NEW, HKV, HD)),
             vn=rng.standard_normal((B, NEW, HKV, HD)), w66=rng.standard_normal((32, 66)))
    out = {k: v.astype(np.int8 if k in ("wq", "xq") else np.float32) for k, v in a.items()}
    out["bt"] = np.arange(2 * 8, dtype=np.int32).reshape(2, 8)
    return out


def _projections(a):
    """Each projection entry point as a function of the arrays (``wq`` as
    the port stores it: the K-major view)."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    wq = tquant.k_major(t["wq"])
    return {
        "nm_prune_matmul": lambda: tops.nm_prune_matmul(t["x"], t["w"], t["scale"], 2, 4,
                                                        bias=t["b"]),
        "nm_spmm": lambda: tops.nm_spmm(t["x"], t["w"], t["scale"], 2, 4),
        "osparse_matmul": lambda: tops.osparse_matmul(
            t["x"], wq, t["smooth"], t["amber"], t["ws"], 2, 4, act_scale=t["act"],
            bias=t["b"]),
        "osparse_matmul_noprune": lambda: tops.osparse_matmul(
            t["x"], wq, t["smooth"], None, t["ws"], 2, 4, act_scale=t["act"], bias=t["b"],
            prune=False),
        "w8a8_matmul": lambda: tops.w8a8_matmul(t["xq"], wq, t["act"], t["ws"]),
        "nm_prune_matmul_66": lambda: tops.nm_prune_matmul(t["x"], t["w66"], t["scale"], 2,
                                                           4),
    }


def _attention(a, kp, vp, use_kernel):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return tattn.paged_attention(t["q"], kp, vp, t["bt"], q_offset=torch.zeros(B, dtype=torch.int32),
                                 kv_len=torch.full((B,), T, dtype=torch.int32),
                                 use_kernel=use_kernel, kv_heads=HKV)


def _scatter(a, kp, vp, use_kernel):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tattn.paged_kv_update(kp, vp, t["kn"], t["vn"], t["bt"], torch.full((B,), T, dtype=torch.int32),
                          torch.full((B,), NEW, dtype=torch.int32), use_kernel=use_kernel)
    return kp, vp


def kernel_rank():
    """On every rank: each entry point unsharded, then under the scope;
    returns (per rank ``{case: (bit-identical, gathers)}``, rank 0's
    unsharded outputs as numpy)."""
    import torch.distributed as dist

    group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    a = parity_arrays()
    found, ref_out = {}, {}

    def record(name, ref, fn):
        before = tp_mod.gather.calls
        with tp_mod.scope(group):
            got = fn()
        same = all(torch.equal(r, g) for r, g in zip(ref, got))
        found[name] = (same, tp_mod.gather.calls - before)
        ref_out[name] = [r.numpy() for r in ref]

    for name, fn in _projections(a).items():
        record(name, [fn()], lambda fn=fn: [fn()])
    sharded = tp_mod.shards_kv(HQ, HKV, size)
    h = HKV // size if sharded else HKV
    lo = rank * h if sharded else 0

    def share(p):
        """This rank's pool: its heads where they divide, else all."""
        return torch.from_numpy(p[:, :, lo:lo + h].copy())

    def gathered(p):
        if not sharded:
            return p
        parts = [torch.empty_like(p) for _ in range(size)]
        dist.all_gather(parts, p, group=group)
        return torch.cat(parts, dim=2)

    full = (torch.from_numpy(a["kp"]), torch.from_numpy(a["vp"]))
    for uk, tag in ((True, ""), (False, "_oracle")):
        record("paged_attention" + tag, [_attention(a, *full, uk)],
               lambda uk=uk: [_attention(a, share(a["kp"]), share(a["vp"]), uk)])
        ref = _scatter(a, full[0].clone(), full[1].clone(), uk)
        record("paged_kv_update" + tag, ref,
               lambda uk=uk: [gathered(p) for p in _scatter(a, share(a["kp"]),
                                                           share(a["vp"]), uk)])
    everyone = [None] * size
    dist.all_gather_object(everyone, found, group=group)
    return everyone, ref_out


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def kernels_run(request, tmp_path_factory):
    size = request.param
    found, ref = spawn(kernel_rank, size, device="cpu",
                       store_dir=str(tmp_path_factory.mktemp(f"tp{size}")))
    return size, found, ref


@pytest.mark.parametrize("case", PROJECTIONS + ATTENTION)
def test_sharded_entry_points_bit_identical_on_every_rank(kernels_run, case):
    """Under the scope each entry point gives the unsharded call's result
    bit for bit, on every rank; it gathered once (the pools of the scatter
    are never gathered), except where it fell through (4 ranks: the KV
    heads do not divide)."""
    size, found, _ = kernels_run
    assert len(found) == size
    heads_fall_through = size == 4 and case in ATTENTION
    for rank, cases in enumerate(found):
        same, gathers = cases[case]
        assert same, (case, rank)
        want = 0 if heads_fall_through or case.startswith("paged_kv_update") else 1
        assert gathers == want, (case, rank, gathers)


def test_columns_that_do_not_divide_fall_through(kernels_run):
    """A 66-column weight does not divide over 4 ranks (the unsharded call,
    no gather); over 2 it shards."""
    size, found, _ = kernels_run
    for cases in found:
        same, gathers = cases["nm_prune_matmul_66"]
        assert same and gathers == (0 if size == 4 else 1)


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX package's unsharded outputs on the same arrays, its Pallas
    kernels in interpret mode."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.models import attention as jattn

    a = {k: jnp.asarray(v) for k, v in parity_arrays().items()}
    qo, kvl = jnp.zeros((B,), jnp.int32), jnp.full((B,), T, jnp.int32)
    out = {
        "nm_prune_matmul": jops.nm_prune_matmul(a["x"], a["w"], a["scale"], 2, 4,
                                                bias=a["b"], interpret=True),
        "nm_spmm": jops.nm_spmm(a["x"], a["w"], a["scale"], 2, 4, interpret=True),
        "osparse_matmul": jops.osparse_matmul(a["x"], a["wq"], a["smooth"], a["amber"],
                                              a["ws"], 2, 4, act_scale=a["act"], bias=a["b"],
                                              interpret=True),
        "osparse_matmul_noprune": jops.osparse_matmul(
            a["x"], a["wq"], a["smooth"], None, a["ws"], 2, 4, act_scale=a["act"],
            bias=a["b"], prune=False, interpret=True),
        "w8a8_matmul": jops.w8a8_matmul(a["xq"], a["wq"], a["act"], a["ws"], interpret=True),
    }
    for uk, tag in ((True, ""), (False, "_oracle")):
        out["paged_attention" + tag] = jattn.paged_attention(
            a["q"], a["kp"], a["vp"], a["bt"], q_offset=qo, kv_len=kvl, use_kernel=uk,
            interpret=True)
        out["paged_kv_update" + tag] = jattn.paged_kv_update(
            a["kp"], a["vp"], a["kn"], a["vn"], a["bt"], jnp.full((B,), T, jnp.int32),
            jnp.full((B,), NEW, jnp.int32), use_kernel=uk, interpret=True)
    return {k: [np.asarray(x) for x in (v if isinstance(v, tuple) else (v,))]
            for k, v in out.items()}


@pytest.mark.parametrize("case", PROJECTIONS + ATTENTION)
def test_unsharded_entry_points_match_jax(kernels_run, jax_kernels, case):
    """What every rank held its shards to is the JAX package's unsharded
    output: the int8 GEMM bit-exact, the scatter bit-exact (a copy), the
    osparse outputs within an ulp of the product and one of the bias add
    (XLA contracts the Pallas kernel's bias epilogue into one FMA, as
    ``tests/test_torch_quant.py`` states), the float32
    products and attention at ``F32``."""
    got, want = kernels_run[2][case], jax_kernels[case]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if case in ("w8a8_matmul", "paged_kv_update", "paged_kv_update_oracle"):
            np.testing.assert_array_equal(g, w)
        elif case.startswith("osparse"):
            unbiased = g - parity_arrays()["b"]
            lim = np.spacing(np.abs(unbiased)) + np.spacing(np.maximum(np.abs(g), np.abs(w)))
            assert (np.abs(g - w) <= lim).all()
        else:
            np.testing.assert_allclose(g, w, **F32)


def test_shard_columns_views_k_major_and_keeps_row_major_copies():
    """A K-major int8 weight's column block is a block of rows: a view at
    the right offset, which the int8 GEMMs' K-major check takes.  A
    row-major weight's column slice is copied once and kept while the
    weight lives unchanged; an in-place write cuts it again."""
    wq = tquant.k_major(torch.arange(32 * 64, dtype=torch.int32).remainder(127)
                        .to(torch.int8).reshape(32, 64))
    s = tp_mod.shard_columns(wq, 1, 2)
    assert s.data_ptr() == wq.data_ptr() + 32 * 32 and s.t().is_contiguous()
    assert torch.equal(s, wq[:, 32:])
    w = torch.randn(32, 64)
    s1 = tp_mod.shard_columns(w, 1, 4)
    assert s1.is_contiguous() and torch.equal(s1, w[:, 16:32])
    assert tp_mod.shard_columns(w, 1, 4) is s1
    w.mul_(2)
    s2 = tp_mod.shard_columns(w, 1, 4)
    assert s2 is not s1 and torch.equal(s2, w[:, 16:32])


def test_no_scope_no_sharding():
    """Outside a scope every entry point is the unsharded call."""
    assert tp_mod.current() is None and tp_mod.degree() == 1
    with tp_mod.scope(None) as ctx:
        assert ctx is None
    before = tp_mod.gather.calls
    for fn in _projections(parity_arrays()).values():
        fn()
    assert tp_mod.gather.calls == before


# ----------------------------------------------------------------- engines

def _model(kind):
    """The LLaMA-3.1 smoke model in float32 on the CPU, weights from seed 0,
    and its policy: ``dense``, ``paper`` (8:16 with the kernels' plain
    versions and the Amber scales) or ``w8a8`` (``paper`` after the W8A8
    rewrite of q/k/v/o/gate/up from a seeded calibration absmax)."""
    cfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    if kind == "dense":
        return model, params, tpolicy.DENSE
    policy = tpolicy.paper_policy(8, 16, cfg.qgate_skip_layers, use_kernels=True)
    precompute_scales(params, policy)
    if kind == "w8a8":
        rng = np.random.default_rng(3)
        absmax = {(i, name): (np.abs(rng.standard_normal(
            cfg.q_dim if name == "o_proj" else cfg.d_model)) + 0.5).astype(np.float32)
            for i in range(cfg.n_layers) for name in QPROJS}
        quantize_linears(params, absmax, tquant.QuantConfig())
    return model, params, policy


def _serve(kind, prompts, *, dp=1, tp=1):
    """The prompts through ``Engine`` (6 new tokens each): tokens, each
    replica's dispatches per iteration, and the first replica's pools."""
    model, params, policy = _model(kind)
    eng = Engine.from_config(model, EngineConfig(dp=dp, tp=tp, serving=ContinuousConfig(
        **SERVE)), policy=policy, device="cpu")
    rids = [eng.submit(p, 6, arrival=a) for p, a in zip(prompts, ARRIVALS)]
    res = eng.run(params)
    pools = [(layer["k"], layer["v"]) for layer in eng.replicas[0].exec.cache["layers"]]
    return ([res["outputs"][r] for r in rids],
            [p.dispatches_per_iteration for p in eng.metrics.replicas], pools)


def engine_rank(prompts):
    """On every rank: the scenarios at tp = 2; returns rank 0's tokens,
    dispatches per iteration and pools gathered over the ranks (numpy), and
    what the up-front check raised for a mesh of the wrong size."""
    import torch.distributed as dist

    out = {}
    for kind, dp in (("dense", 1), ("dense", 2), ("paper", 1), ("w8a8", 1)):
        tokens, dpi, pools = _serve(kind, prompts, dp=dp, tp=2)
        whole = []
        for k, v in pools:
            layer = []
            for p in (k, v):
                parts = [torch.empty_like(p) for _ in range(2)]
                dist.all_gather(parts, p)
                layer.append(torch.cat(parts, dim=2).numpy())
            whole.append(layer)
        out[kind, dp] = (tokens, dpi, whole, pools[0][0].shape[2])
    try:
        make_serving_mesh(1, 4)
    except ValueError as e:
        out["error"] = str(e)
    return out


def _jax_tree(jm, port):
    """The JAX parameter tree of the port's LLaMA (every layer stacked in
    the scanned period ``b0``): the JAX init's structure (``jax.eval_shape``,
    nothing computed) filled from the port's modules."""
    import jax

    def fill(path, sds):
        keys = [p.key for p in path]
        mods = list(port.blocks) if keys[0] == "periods" else [port]
        leaves = []
        for obj in mods:
            for k in keys[2:] if keys[0] == "periods" else keys:
                obj = getattr(obj, k)
            leaves.append(obj.detach().numpy())
        a = np.stack(leaves) if keys[0] == "periods" else leaves[0]
        assert a.shape == sds.shape and a.dtype == sds.dtype, keys
        return a

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jm.init,
                                                                 jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """The reference's prompts (``jax.random`` from ``seed0=40``), the JAX
    ``dp=1`` engine's tokens on the port's weights, the port's tp=1 runs
    and the ranks' tp=2 runs."""
    import jax

    from repro.configs.base import get_smoke_config
    from repro.core import policy as jpolicy
    from repro.models import build_model as jbuild
    from repro.serve.api import Engine as JEngine
    from repro.serve.api import EngineConfig as JEngineConfig
    from repro.serve.continuous import ContinuousConfig as JConfig

    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(40 + i), (n,), 0,
                                             cfg.vocab_size)).astype(np.int32)
               for i, n in enumerate(LENS)]
    jm = jbuild(cfg)
    jeng = JEngine.from_config(jm, JEngineConfig(dp=1, serving=JConfig(**SERVE)),
                               policy=jpolicy.DENSE)
    rids = [jeng.submit(p, 6, arrival=a) for p, a in zip(prompts, ARRIVALS)]
    res = jeng.run(_jax_tree(jm, _model("dense")[1]))
    want = [list(map(int, res["outputs"][r])) for r in rids]
    one = {kind: _serve(kind, prompts) for kind in ("dense", "paper", "w8a8")}
    two = spawn(engine_rank, 2, prompts, device="cpu",
                store_dir=str(tmp_path_factory.mktemp("engine")))
    return want, one, two


@pytest.mark.parametrize("dp", [1, 2], ids=["tp2", "dp2-tp2"])
def test_tp2_engine_matches_jax_dp1(scenario, dp):
    """``tests/test_sharded_serving.py:389``: tp=2 and dp=2/tp=2 are
    token-identical to the JAX ``dp=1`` engine, with one dispatch per work
    iteration on every replica; each rank's pools hold one of the two KV
    heads."""
    want, one, two = scenario
    tokens, dpi, _, heads = two["dense", dp]
    assert tokens == want == one["dense"][0]
    assert len(dpi) == dp and all(d == 1.0 for d in dpi)
    assert heads == 1


@pytest.mark.parametrize("kind", ["paper", "w8a8"])
def test_tp2_sparse_and_w8a8_match_tp1_tokens_and_pools(scenario, kind):
    """Under ``paper_policy(8, 16)`` (the projections column-parallel) and in
    W8A8 (``osparse_matmul`` column-parallel in prefill and decode), tp=2
    gives the port's tp=1 tokens, and the ranks' pools, gathered along the
    head axis, are the tp=1 pools bit for bit."""
    _, one, two = scenario
    tokens, _, pools, _ = two[kind, 1]
    want_tokens, _, want_pools = one[kind]
    assert tokens == want_tokens
    assert len(pools) == len(want_pools)
    for (k, v), (wk, wv) in zip(pools, want_pools):
        np.testing.assert_array_equal(k, wk.numpy())
        np.testing.assert_array_equal(v, wv.numpy())


def test_mesh_of_the_wrong_size_raises_up_front(scenario):
    """Inside a group of 2 ranks, a mesh of 4 raises ``ValueError`` naming
    the fix."""
    assert "needs 4 ranks but the group has 2" in scenario[2]["error"]
    assert "spawn" in scenario[2]["error"]


@pytest.mark.parametrize("dp", [1, 2])
def test_tp_without_a_group_raises_up_front(dp):
    """``EngineConfig(tp=2)`` outside an initialised group raises
    ``ValueError`` up front, naming the fix (the reference raises on a mesh
    larger than the backend's devices)."""
    model = build_model(dataclasses.replace(tget("llama31_8b"), dtype="float32"),
                        device="cpu")
    with pytest.raises(ValueError, match="none is initialised.*spawn"):
        Engine.from_config(model, EngineConfig(dp=dp, tp=2), device="cpu")


# --------------------------------------------------------------------- CLI

def test_cli_tp2_serves_tp1_tokens(capfd):
    """``--tp 2 --device cpu`` starts two ranks, prints the backend first,
    and serves the ``--tp 1`` tokens (the report's token digest) with the
    same counters."""
    from repro_torch.launch.serve import run

    argv = ["--arch", "llama31_8b", "--smoke", "--device", "cpu", "--trace",
            "--num-requests", "4", "--len-range", "6:20", "--slots", "2", "--chunk", "8",
            "--new-tokens", "4"]
    code, m1 = run(argv)
    one = capfd.readouterr().out
    code2, m2 = run(argv + ["--tp", "2"])
    two = capfd.readouterr().out          # rank 0 prints the report
    assert code == code2 == 0
    assert "backend gloo, every step eager" in two and "tp=2" in two

    def line(out, label):
        return next(x for x in out.splitlines() if x.startswith(f"# {label}:"))

    assert line(one, "tokens") == line(two, "tokens")
    assert m2.generated_tokens == m1.generated_tokens
    assert m2.trace_counts == m1.trace_counts
    assert m2.dispatches_per_iteration == m1.dispatches_per_iteration == 1.0


def test_cli_tp_needs_trace():
    """One-shot mode takes no ``--tp`` (the JAX CLI shards ``--trace`` only)."""
    from repro_torch.launch.serve import main

    with pytest.raises(ValueError, match="--trace"):
        main(["--smoke", "--device", "cpu", "--tp", "2"])
