"""The port's MoE family against the JAX package's, on the Qwen3-30B-A3B and
Llama-4-Scout ``smoke()`` configs in float32, weights carried with
``from_jax_params``.

* The MoE layer alone against ``repro.models.moe._moe_local``: ragged and
  dense impls, DENSE and the paper's 8:16 and 2:4 policies, plain path and
  kernel wrappers (their plain versions on the CPU): the routed expert ids
  equal ``jax.lax.top_k``'s, ties included (the lower expert index first),
  and the outputs are allclose at 1e-4.
* The whole model: the full-sequence pass, chunked prefill at offsets (the
  last chunk padded) and decode; the q/gate skip list leaves a skipped
  layer's q dense while its routed experts are still pruned.
* The continuous engine: greedy tokens, ``trace_counts`` and prefix hits
  equal the JAX engine's.
* The expert tensors round-trip bf16 → f32 → bf16 exactly; the grouped
  product's plain version equals ``torch._grouped_mm`` on the CPU, empty
  groups included; Amber scales land where the JAX walk puts them (the
  read ones); ``n_params`` / ``n_active_params`` are the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core.pruner import precompute_scales as jprecompute
from repro.models import build_model as jbuild
from repro.models.moe import _moe_local
from repro.serve.api import Engine as JEngine
from repro.serve.api import EngineConfig as JEngineConfig
from repro.serve.continuous import ContinuousConfig as JConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.core import pruner as tpruner
from repro_torch.core.pruner import precompute_scales as tprecompute
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
from repro_torch.weights import from_jax_params

# float32; differences are summation order only
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("qwen3_30b_a3b", "llama4_scout_17b_a16e")


def _policies(skip):
    return {
        "dense": (jpolicy.DENSE, tpolicy.DENSE),
        "paper_8_16": (jpolicy.paper_policy(8, 16, skip), tpolicy.paper_policy(8, 16, skip)),
        "paper_2_4": (jpolicy.paper_policy(2, 4, skip), tpolicy.paper_policy(2, 4, skip)),
    }


@pytest.fixture(scope="module")
def jax_models():
    """Per arch: (JAX cfg, port cfg, JAX model, JAX params), float32."""
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        jm = jbuild(cfg)
        out[arch] = (cfg, dataclasses.replace(tget(arch), dtype="float32"), jm,
                     jm.init(jax.random.PRNGKey(0)))
    return out


def _layer0(params):
    return jax.tree_util.tree_map(lambda a: a[0], params["periods"]["b0"]["moe"])


# ----------------------------------------------------------- the layer alone

@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("policy", ["dense", "paper_8_16", "paper_2_4"])
@pytest.mark.parametrize("impl", ["ragged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax(jax_models, arch, impl, policy, use_kernels):
    cfg, tcfg, _, params = jax_models[arch]
    jpol, tpol = _policies(cfg.qgate_skip_layers)[policy]
    jp = jprecompute(params, jpol)
    x = np.random.default_rng(3).standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    want = np.asarray(_moe_local(jnp.asarray(x), _layer0(jp), jpol, "prefill", cfg.top_k,
                                 cfg.act_fn, impl))
    blk = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu").blocks[0]
    got = tmoe.moe(torch.from_numpy(x), blk.moe, tpol.with_(use_kernels=use_kernels),
                   "prefill", tcfg.top_k, tcfg.act_fn, impl, layer_idx=0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    xt = x.reshape(-1, cfg.d_model)
    _, jids = jax.lax.top_k(jnp.asarray(xt) @ _layer0(jp)["router"]["w"], cfg.top_k)
    _, tids = tmoe.route(torch.from_numpy(xt), blk.moe.router.w, tcfg.top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("impl", ["ragged", "dense"])
def test_tied_router_logits_take_the_lower_expert_first(jax_models, impl):
    """Router columns repeated so that logits tie exactly: the kept experts
    and their order are ``jax.lax.top_k``'s (lower index first), and so is
    the layer's output."""
    cfg, tcfg, _, params = jax_models["qwen3_30b_a3b"]
    lp = _layer0(params)
    w = np.asarray(lp["router"]["w"]).copy()
    w[:, 1::2] = w[:, 0::2]                        # experts 2j, 2j+1 tie
    w[:, 4:] = 0.0                                 # a 4-way tie at 0
    lp = {**lp, "router": {"w": jnp.asarray(w)}}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, cfg.d_model)).astype(np.float32)
    x[3] = 0.0                                     # every logit 0: all 8 tie
    _, jids = jax.lax.top_k(jnp.asarray(x) @ jnp.asarray(w), cfg.top_k)
    _, tids = tmoe.route(torch.from_numpy(x), torch.from_numpy(w), cfg.top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids[3].tolist() == [0, 1]
    want = np.asarray(_moe_local(jnp.asarray(x), lp, jpolicy.DENSE, "prefill", cfg.top_k,
                                 cfg.act_fn, impl))
    pn = jax.tree_util.tree_map(np.array, params)
    pn["periods"]["b0"]["moe"]["router"]["w"][0] = w
    blk = from_jax_params(tcfg, pn, device="cpu").blocks[0]
    got = tmoe.moe(torch.from_numpy(x), blk.moe, tpolicy.DENSE, "prefill", cfg.top_k,
                   cfg.act_fn, impl, layer_idx=0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------ the whole model

PROMPT = np.random.default_rng(2).integers(0, 256, size=21)   # 3 chunks of 8
TOKS = np.random.default_rng(1).integers(0, 256, size=(2, 19))


def _chunks():
    """(tokens (1, 8), chunk_len) — the last chunk padded."""
    for s in range(0, len(PROMPT), 8):
        part = PROMPT[s:s + 8]
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :len(part)] = part
        yield chunk, len(part)


@pytest.fixture(scope="module")
def reference(jax_models):
    """Per (arch, policy): the JAX params with scales, forward logits, each
    prefill chunk's logits and four greedy decode steps."""
    out = {}
    for arch, (cfg, _, jm, params) in jax_models.items():
        for name, (jpol, _) in _policies(cfg.qgate_skip_layers).items():
            if name == "paper_2_4":
                continue
            jp = jprecompute(params, jpol)
            fwd = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(TOKS)}, policy=jpol,
                                        phase="prefill"))
            cache, chunks, steps = jm.init_cache(1, 48), [], []
            for chunk, clen in _chunks():
                jl, cache = jm.prefill_chunk(
                    jp, {"tokens": jnp.asarray(chunk),
                         "chunk_len": jnp.asarray(clen, jnp.int32)}, cache, policy=jpol)
                chunks.append(np.asarray(jl))
            for _ in range(4):
                tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
                jl, cache = jm.decode_step(jp, jnp.asarray(tok), cache, policy=jpol)
                steps.append((tok, np.asarray(jl)))
            out[arch, name] = (jax.tree_util.tree_map(np.asarray, jp), fwd, chunks, steps)
    return out


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", ["dense", "paper_8_16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_match(jax_models, reference, arch, name, use_kernels):
    """Forward, then a 21-token prompt in chunks of 8 (the last padded) and
    four greedy decode steps: the JAX logits at every step."""
    tcfg = jax_models[arch][1]
    params_np, fwd, chunks, steps = reference[arch, name]
    tpol = _policies(tcfg.qgate_skip_layers)[name][1].with_(use_kernels=use_kernels)
    tm, tp = build_model(tcfg, device="cpu"), from_jax_params(tcfg, params_np, device="cpu")
    got = tm.forward(tp, {"tokens": torch.from_numpy(TOKS)}, policy=tpol, phase="prefill").numpy()
    np.testing.assert_allclose(got, fwd, **TOL)
    cache = tm.init_cache(1, 48, block_size=8)
    for (chunk, clen), want in zip(_chunks(), chunks):
        tl, cache = tm.prefill_chunk(
            tp, {"tokens": torch.from_numpy(chunk),
                 "chunk_len": torch.tensor(clen, dtype=torch.int32)}, cache, policy=tpol)
        np.testing.assert_allclose(tl.numpy(), want, **TOL)
    assert int(cache["pos"]) == len(PROMPT)
    for tok, want in steps:
        assert int(torch.argmax(tl, dim=-1)[0]) == int(tok[0, 0])
        tl, cache = tm.decode_step(tp, torch.from_numpy(tok), cache, policy=tpol)
        np.testing.assert_allclose(tl.numpy(), want, **TOL)


def test_skipped_layer_keeps_q_dense_and_prunes_its_experts(jax_models, reference,
                                                            monkeypatch):
    """Qwen3's smoke skip list names layer 1 (as the full config names 41, 46
    and 47): there q_proj is not pruned, while the routed experts' gate and
    down inputs are, on plain |X| (``moe.py:55`` passes layer None); layer 0
    prunes q on its Amber scale too."""
    tcfg = jax_models["qwen3_30b_a3b"][1]
    params_np = reference["qwen3_30b_a3b", "paper_8_16"][0]
    tp = from_jax_params(tcfg, params_np, device="cpu")
    pol = tpolicy.paper_policy(8, 16, tcfg.qgate_skip_layers)
    calls = []
    real = tpruner.prune_input

    def spy(x, scale, policy):
        calls.append((x.shape[-1], scale is None))
        return real(x, scale, policy)

    monkeypatch.setattr(tpruner, "prune_input", spy)
    h = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 8, 64))
                         .astype(np.float32))
    pos = torch.arange(8)[None]
    for layer, want in ((0, [(64, False), (64, True), (32, True)]),
                        (1, [(64, True), (32, True)])):
        calls.clear()
        ttransformer._attn_block_apply(tcfg, h, tp.blocks[layer], pol, "prefill", layer,
                                       None, pos)
        assert calls == want, layer


# ------------------------------------------------------------------ engines

def _traffic():
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, size=16)               # two full blocks
    prompts = [rng.integers(0, 256, size=n) for n in (5, 21)]
    prompts += [np.concatenate([shared, rng.integers(0, 256, size=n)]) for n in (7, 11, 3)]
    return prompts, [0, 0, 2, 4, 9], [8, 12, 6, 10, 5]


SERVE = dict(max_seq=64, num_slots=2, chunk_size=8, block_size=8)


@pytest.fixture(scope="module")
def served(jax_models):
    """The JAX continuous engine's run per arch, paper policy, with the
    params it ran on."""
    out = {}
    for arch, (cfg, _, jm, params) in jax_models.items():
        jpol = jpolicy.paper_policy(8, 16, cfg.qgate_skip_layers)
        jp = jprecompute(params, jpol)
        eng = JEngine.from_config(jm, JEngineConfig(serving=JConfig(**SERVE)), policy=jpol)
        for p, a, n in zip(*_traffic()):
            eng.submit(p, n, a)
        out[arch] = (jax.tree_util.tree_map(np.asarray, jp), eng.run(jp))
    return out


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(jax_models, served, arch, use_kernels):
    tcfg = jax_models[arch][1]
    params_np, jres = served[arch]
    eng = Engine.from_config(
        build_model(tcfg, device="cpu"),
        EngineConfig(serving=ContinuousConfig(validate_pool=True, **SERVE)),
        policy=tpolicy.paper_policy(8, 16, tcfg.qgate_skip_layers).with_(
            use_kernels=use_kernels), device="cpu")
    for p, a, n in zip(*_traffic()):
        eng.submit(p, n, a)
    res = eng.run(from_jax_params(tcfg, params_np, device="cpu"))
    assert res["outputs"] == jres["outputs"]
    assert res["metrics"]["paged"]["prefix_hits"] == jres["metrics"]["paged"]["prefix_hits"] > 0
    got = res["metrics"]["trace_counts"]
    assert got == dict(jres["metrics"]["trace_counts"]) == eng.replica.trace_counts
    assert set(got.values()) == {1}


# ------------------------------------------------------ weights and helpers

@pytest.mark.parametrize("arch", ARCHS)
def test_expert_weights_round_trip_bf16(arch):
    cfg16 = get_smoke_config(arch)
    pn = jax.tree_util.tree_map(np.asarray, jbuild(cfg16).init(jax.random.PRNGKey(1)))
    tp = from_jax_params(tget(arch), pn, device="cpu")
    jm = pn["periods"]["b0"]["moe"]
    for i, blk in enumerate(tp.blocks):
        assert blk.moe.router.w.dtype == torch.float32
        np.testing.assert_array_equal(blk.moe.router.w.numpy(), jm["router"]["w"][i])
        for name in ("gate_proj", "up_proj", "down_proj"):
            w = getattr(blk.moe.experts, name)
            assert w.dtype == torch.bfloat16 and w.is_contiguous()
            np.testing.assert_array_equal(w.float().numpy(), jm["experts"][name]["w"][i]
                                          .astype(np.float32))
        if blk.moe.shared is not None:
            np.testing.assert_array_equal(blk.moe.shared.up_proj.w.float().numpy(),
                                          jm["shared"]["up_proj"]["w"][i].astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_plain_matches_grouped_mm(dtype):
    """Groups 1 and 3 empty, the last group ending at the last row."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 64, generator=g).to(dtype)
    w = torch.randn(5, 64, 32, generator=g).to(dtype)
    offs = torch.tensor([9, 9, 30, 30, 40], dtype=torch.int32)
    got = tmoe.grouped_matmul_plain(x, w, offs)
    assert torch.equal(tmoe.grouped_matmul(x, w, offs), got)
    want = torch._grouped_mm(x, w, offs=offs)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.abs().max())
    assert torch.equal(got[9:30].float(), (x[9:30] @ w[2]).float())


def test_amber_scales_land_where_jax_puts_the_read_ones(jax_models):
    """Robust scales: the shared expert's pruned projections get the JAX
    walk's; the routed experts and the router get none (JAX attaches one to
    the router that nothing reads)."""
    cfg, tcfg, _, params = jax_models["llama4_scout_17b_a16e"]
    pol = tpolicy.paper_policy(8, 16)
    jp = jprecompute(params, jpolicy.paper_policy(8, 16))
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tprecompute(tp, pol)
    jm = jp["periods"]["b0"]["moe"]
    for i, blk in enumerate(tp.blocks):
        assert blk.moe.router.amber_scale is None
        assert not [n for n, _ in blk.moe.experts.named_buffers() if n]
        for name in ("gate_proj", "down_proj"):
            np.testing.assert_allclose(getattr(blk.moe.shared, name).amber_scale.numpy(),
                                       np.asarray(jm["shared"][name]["amber_scale"][i]),
                                       rtol=1e-5)
        assert blk.moe.shared.up_proj.amber_scale is None
    assert "amber_scale" in jm["router"] and "amber_scale" not in jm["experts"]["gate_proj"]


@pytest.mark.parametrize("arch", ["llama31_8b", "qwen2_7b", *ARCHS])
def test_param_counts_match_jax(arch):
    for tcfg, jcfg in ((tget_config(arch), jget_config(arch)),
                       (tget(arch), get_smoke_config(arch))):
        assert tcfg.n_params() == jcfg.n_params()
        assert tcfg.n_active_params() == jcfg.n_active_params()
    if arch == "qwen3_30b_a3b":
        assert 30e9 < tget_config(arch).n_params() < 31e9
        assert 3e9 < tget_config(arch).n_active_params() < 3.5e9


def test_chip_smoke_counts_and_books_the_moe_path():
    """``chip_smoke.py``'s launch formula per sparse chunk (45
    ``nm_prune_matmul`` and 96 ``nm_prune`` for Qwen3-30B-A3B under the
    paper's policy; LLaMA-3.1-8B's 86 and 0) and its profile family of the
    grouped product's kernels (their names as the profiler gives them)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for arch, want in (("qwen3_30b_a3b", (45, 96)), ("llama31_8b", (86, 0))):
        cfg = tget_config(arch)
        assert cs.prune_launches(cfg, tpolicy.paper_policy(8, 16, cfg.qgate_skip_layers)) == want
    for key in ("void at::cuda::detail::prepare_grouped_gemm_data<cutlass::bfloat16_t>(int)",
                "_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4"
                "gemm6kernel13GemmUniversalINS5_17GroupProblemShapeIN4cute5tupleIJ"):
        assert cs.kernel_family(key) == cs.GROUPED_GEMM[0]
    assert cs.kernel_family("nvjet_tst_64x8_64x16_4x1_v_bz_NNT") == "cuBLAS GEMM"
