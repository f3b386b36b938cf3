"""The recurrent families of the port against the JAX package's.

RWKV6-7B's and RecurrentGemma-2B's smoke configs in float32, the JAX
weights carried over with ``from_jax_params``, seeded numpy inputs:

* ``rwkv6_block`` and ``rglru_block`` over a multi-token chunk and a single
  step from a nonzero state: outputs and new states within ``TOL``
  (float32; the port's chunked WKV and Hillis-Steele RG-LRU scan sum in
  another order than the reference's ``lax.scan`` / ``associative_scan``);
  the chunked WKV against its plain twin, the token loop, and the loop
  against the reference's step; the RG-LRU scan against a step loop.
* The whole model: ``forward``, ``prefill`` + ``decode_step`` (``TOL``);
  ``prefill_chunk`` over exact dyadic chunks (T = 23, C = 8) equal to the
  one-shot prefill within ``tests/test_prefill_chunk.py``'s 5e-5 and the
  JAX chunked prefill within ``TOL``, under DENSE and ``paper_policy(2,
  4)`` with scales, every N:M keep mask of the chunks bit-identical to the
  one-shot prefill's.
* ``precompute_scales`` attaches the JAX walk's scales (RWKV6's four
  time-mix projections included), ``from_jax_params`` maps periods and the
  tail (and keeps ``w0``, ``u`` and ``lam`` float32 in a bf16 model), and
  ``_dyadic_sizes`` equals the JAX scheduler's on 0-600.
* The continuous engine on both models: greedy tokens, ``trace_counts`` and
  counters equal to the JAX ``ContinuousServingEngine``'s on the same
  stream, fused and legacy split, on the slab with no prefix cache; a
  decode step leaves a prefilling slot's recurrent state bit-unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core.pruner import precompute_scales as jprecompute
from repro.models import build_model as jbuild
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.serve.continuous import ContinuousConfig as JConfig
from repro.serve.continuous import ContinuousServingEngine as JContinuous
from repro.serve.scheduler import _dyadic_sizes as jdyadic
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import nm, scoring
from repro_torch.core import policy as tpolicy
from repro_torch.core.pruner import precompute_scales
from repro_torch.layers.linear import Linear
from repro_torch.models import build_model, rglru, rwkv6
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import ContinuousConfig, ContinuousServingEngine
from repro_torch.serve.scheduler import _dyadic_sizes
from repro_torch.weights import from_jax_params

ARCHS = ("rwkv6_7b", "recurrentgemma_2b")
TOL = dict(rtol=1e-4, atol=1e-4)          # float32, another summation order
CHUNK_TOL = dict(rtol=0, atol=5e-5)       # tests/test_prefill_chunk.py's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's smoke engines run thousands of tiny torch ops: with the
    suite's six workers, torch's intra-op thread pools oversubscribe the
    cores and slow them.  One thread a worker while this module runs;
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX model, JAX params, port model, port cfg), float32."""
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        jm = jbuild(cfg)
        tcfg = dataclasses.replace(tget(arch), dtype="float32")
        out[arch] = (jm, jm.init(jax.random.PRNGKey(0)), build_model(tcfg, device="cpu"), tcfg)
    return out


def _policies(name):
    if name == "dense":
        return jpolicy.DENSE, tpolicy.DENSE
    return jpolicy.paper_policy(2, 4), tpolicy.paper_policy(2, 4)


def _both(models, arch, name):
    """(JAX params with the policy's scales, the port's copy of them)."""
    jm, params, tm, tcfg = models[arch]
    jp = jprecompute(params, _policies(name)[0])
    return jp, from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _np(x):
    return np.asarray(x, np.float32)


def test_configs_copy_the_jax_ones():
    from repro.configs.base import get_config as jget
    from repro_torch.configs import get_config

    for arch in ARCHS:
        assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(get_smoke_config(arch))
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget(arch))


# --------------------------------------------------------------------- blocks

def _state(rng, leaves):
    return {k: rng.standard_normal(shape).astype(np.float32) * scale
            for k, (shape, scale) in leaves.items()}


@pytest.mark.parametrize("t", [7, 1], ids=["chunk", "step"])
@pytest.mark.parametrize("name", ["dense", "paper_2_4"])
def test_rwkv6_block_matches_jax(models, name, t):
    """Layer 0's block over a 7-token chunk and a single step, from a
    nonzero state (a nonzero ``u`` too): output and every state leaf."""
    jp, tp = _both(models, "rwkv6_7b", name)
    cfg = models["rwkv6_7b"][3]
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    rng = np.random.default_rng(5)
    jblk = jax.tree_util.tree_map(lambda a: a[0], jp["periods"]["b0"]["rwkv"])
    u = rng.standard_normal((h, hd)).astype(np.float32) * 0.5
    jblk["tm"]["u"] = jnp.asarray(u)
    tblk = tp.blocks[0].rwkv
    tblk.tm.u.copy_(torch.from_numpy(u))
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    st = _state(rng, {"tm_shift": ((2, d), 1.0), "cm_shift": ((2, d), 1.0),
                      "S": ((2, h, hd, hd), 0.3)})
    jpol, tpol = _policies(name)
    jy, jst = jrwkv6.rwkv6_block(jnp.asarray(x), jblk, jpol, "prefill", h,
                                 {k: jnp.asarray(v) for k, v in st.items()})
    ty, tst = rwkv6.rwkv6_block(torch.from_numpy(x), tblk, tpol, "prefill", h,
                                {k: torch.from_numpy(v) for k, v in st.items()}, 0)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    for k in st:
        np.testing.assert_allclose(tst[k].numpy(), _np(jst[k]), **TOL, err_msg=k)
    assert tst["S"].dtype == torch.float32


@pytest.mark.parametrize("t", [7, 1], ids=["chunk", "step"])
@pytest.mark.parametrize("name", ["dense", "paper_2_4"])
def test_rglru_block_matches_jax(models, name, t):
    """The first rglru block over a 7-token chunk and a single step from a
    nonzero ``h`` and conv history."""
    jp, tp = _both(models, "recurrentgemma_2b", name)
    cfg = models["recurrentgemma_2b"][3]
    w, cw = cfg.rnn_width, cfg.conv_width
    rng = np.random.default_rng(6)
    jblk = jax.tree_util.tree_map(lambda a: a[0], jp["periods"]["b0"]["rglru"])
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    st = _state(rng, {"h": ((2, w), 1.0), "conv": ((2, cw - 1, w), 1.0)})
    jpol, tpol = _policies(name)
    jy, jst = jrglru.rglru_block(jnp.asarray(x), jblk, jpol, "prefill",
                                 {k: jnp.asarray(v) for k, v in st.items()})
    ty, tst = rglru.rglru_block(torch.from_numpy(x), tp.blocks[0].rglru, tpol, "prefill",
                                {k: torch.from_numpy(v) for k, v in st.items()}, 0)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    for k in st:
        np.testing.assert_allclose(tst[k].numpy(), _np(jst[k]), **TOL, err_msg=k)


def test_rglru_scan_matches_the_step_loop():
    """The Hillis-Steele scan against ``h_t = a_t h_{t-1} + bx_t`` step by
    step, at lengths that are and are not powers of two."""
    g = torch.Generator().manual_seed(0)
    for t in (1, 2, 5, 8, 23, 64):
        a = torch.rand(2, t, 16, generator=g)
        bx = torch.randn(2, t, 16, generator=g)
        h0 = torch.randn(2, 16, generator=g)
        want, h = [], h0
        for i in range(t):
            h = a[:, i] * h + bx[:, i]
            want.append(h)
        torch.testing.assert_close(rglru._rglru_scan(a, bx, h0), torch.stack(want, 1),
                                   rtol=1e-5, atol=1e-5)


def test_wkv_scan_matches_the_reference_step():
    """The three-launch WKV loop against the reference's step, token by
    token, from a nonzero state and ``u``."""
    g = torch.Generator().manual_seed(1)
    b, t, h, n = 2, 9, 3, 8
    r, k, v = (torch.randn(b, t, h * n, generator=g) for _ in range(3))
    w = torch.rand(b, t, h * n, generator=g)
    u = torch.randn(h, n, generator=g)
    s0 = torch.randn(b, h, n, n, generator=g)
    s, ys = s0, []
    for i in range(t):
        s, y = rwkv6._time_mix_step(s, r[:, i], k[:, i], v[:, i], w[:, i], u, h)
        ys.append(y)
    s_got, y_got = rwkv6.wkv_scan(s0, r, k, v, w, u, h)
    torch.testing.assert_close(y_got, torch.stack(ys, 1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_got, s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,sub", [(2, 16), (9, 4), (23, 16), (64, 16), (256, 16), (37, 8)])
def test_wkv_chunked_matches_the_loop(t, sub):
    """The chunked form (sub-chunks of ``sub``, the last padded) against its
    plain twin, the token loop, from a nonzero state and ``u``, with decays
    from weak to strong (``lw`` down to ~-20): outputs and final state
    within 1e-5 of the largest magnitude."""
    g = torch.Generator().manual_seed(t)
    b, h, n = 2, 3, 16
    r, k, v = (torch.randn(b, t, h * n, generator=g) for _ in range(3))
    lw = -torch.exp(torch.randn(b, t, h * n, generator=g) * 2 - 1)
    u = torch.randn(h, n, generator=g)
    s0 = torch.randn(b, h, n, n, generator=g)
    s_want, y_want = rwkv6.wkv_scan(s0, r, k, v, lw.exp(), u, h)
    s_got, y_got = rwkv6.wkv_chunked(s0, r, k, v, lw, u, h, sub)
    assert y_got.shape == (b, t, h * n) and s_got.shape == s0.shape
    for got, want in ((y_got, y_want), (s_got, s_want)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---------------------------------------------------------------------- model

TOKS = np.random.default_rng(1).integers(0, 256, size=(2, 23)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(models, arch):
    """``forward`` under ``paper_policy(2, 4)``, then ``prefill`` of 23
    tokens (past RecurrentGemma's window of 8) and 3 greedy decode steps:
    every logit within ``TOL`` of the JAX model's, the same tokens."""
    jm, _, tm, _ = models[arch]
    jp, tp = _both(models, arch, "paper_2_4")
    jpol, tpol = _policies("paper_2_4")
    want = jm.forward(jp, {"tokens": jnp.asarray(TOKS)}, policy=jpol, phase="prefill")
    got = tm.forward(tp, {"tokens": torch.from_numpy(TOKS)}, policy=tpol, phase="prefill")
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(TOKS)}, jc, policy=jpol)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(TOKS)}, tc, policy=tpol)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok[:, 0])
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, policy=jpolicy.DENSE)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok.copy()), tc, policy=tpolicy.DENSE)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    assert int(tc["pos"]) == 26


def _masks(run):
    """Every pruned float projection's per-token N:M keep mask during
    ``run()``, by (module, layer), tokens concatenated in call order."""
    from repro_torch.models import mlp as mlp_lib

    out = {}
    mods = (ttransformer, mlp_lib, rwkv6, rglru)
    real = ttransformer.sparse_linear

    def spy(x, p, module, policy, phase, layer_idx=None):
        if isinstance(p, Linear) and policy.active(phase) and policy.should_prune(module,
                                                                                  layer_idx):
            keep = nm.nm_topk_mask(scoring.score_activations(x, p.amber_scale), policy.n,
                                   policy.m)
            out.setdefault((module, layer_idx, id(p)), []).append(
                keep.reshape(-1, x.shape[-1]))
        return real(x, p, module, policy, phase, layer_idx)

    for mod in mods:
        mod.sparse_linear = spy
    try:
        run()
    finally:
        for mod in mods:
            mod.sparse_linear = real
    return {k: torch.cat(v) for k, v in out.items()}


@pytest.mark.parametrize("name", ["dense", "paper_2_4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_exact_chunks_match_one_shot_prefill(models, arch, name):
    """A 23-token prompt in exact dyadic chunks of at most 8 (8, 8, 4, 2,
    1) through ``prefill_chunk``: the last logits equal the one-shot
    prefill's within 5e-5 and the JAX chunked prefill's within ``TOL``, a
    decode step continues identically, and every N:M keep mask of the
    chunks is bit-identical to the one-shot prefill's."""
    jm, _, tm, _ = models[arch]
    jp, tp = _both(models, arch, name)
    jpol, tpol = _policies(name)
    toks = TOKS[:1]
    c1 = tm.init_cache(1, 48)
    one = {}
    m1 = _masks(lambda: one.update(zip(("l", "c"), tm.prefill(
        tp, {"tokens": torch.from_numpy(toks)}, c1, policy=tpol))))
    c2, jc = tm.init_cache(1, 48), jm.init_cache(1, 48)
    sizes = _dyadic_sizes(23, 8)
    assert sizes == [8, 8, 4, 2, 1]
    chunked = {}

    def run_chunks():
        nonlocal c2, jc
        off = 0
        for size in sizes:
            part = toks[:, off:off + size]
            chunked["l"], c2 = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(part)}, c2,
                                                policy=tpol)
            chunked["j"], jc = jm.prefill_chunk(jp, {"tokens": jnp.asarray(part)}, jc,
                                                policy=jpol)
            off += size

    m2 = _masks(run_chunks)
    assert int(c2["pos"]) == 23
    np.testing.assert_allclose(chunked["l"].numpy(), one["l"].numpy(), **CHUNK_TOL)
    np.testing.assert_allclose(chunked["l"].numpy(), _np(chunked["j"]), **TOL)
    assert m1.keys() == m2.keys() and (len(m1) > 0) == (name != "dense")
    for key in m1:
        assert torch.equal(m1[key], m2[key]), key
    tok = torch.argmax(one["l"], -1).to(torch.int32)[:, None]
    d1, _ = tm.decode_step(tp, tok, one["c"], policy=tpolicy.DENSE)
    d2, _ = tm.decode_step(tp, tok, c2, policy=tpolicy.DENSE)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), **CHUNK_TOL)


# ------------------------------------------------------------ weights, scales

@pytest.mark.parametrize("arch", ARCHS)
def test_precompute_scales_match_the_jax_walk(models, arch):
    """The port's walk over the JAX weights attaches the JAX walk's scale to
    every projection that reads one (RWKV6's r/k/v/g time-mix projections
    included) and none elsewhere; RG-LRU's ``gate_a``/``gate_x``, which the
    JAX walk scales and nothing reads, get none."""
    jm, params, _, tcfg = models[arch]
    pol = jpolicy.paper_policy(8, 16)
    jp = jax.tree_util.tree_map(np.asarray, jprecompute(params, pol))
    tp = precompute_scales(from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params),
                                           device="cpu"), tpolicy.paper_policy(8, 16))
    got = {name: mod.amber_scale for name, mod in tp.named_modules()
           if isinstance(mod, Linear) and mod.amber_scale is not None}
    if arch == "rwkv6_7b":
        want_names = [f"blocks.{i}.rwkv.{m}" for i in range(tcfg.n_layers) for m in (
            "tm.r_proj", "tm.k_proj_tm", "tm.v_proj_tm", "tm.g_proj", "cm.gate_proj",
            "cm.down_proj")]
        for name in want_names:
            i, path = int(name.split(".")[1]), name.split(".")[3:]
            leaf = jp["periods"]["b0"]["rwkv"][path[0]][path[1]]["amber_scale"][i]
            np.testing.assert_allclose(got[name].numpy(), leaf, rtol=1e-6, atol=0)
    else:
        n_per = tcfg.n_layers // 3
        want_names = []
        for i, kind in enumerate(ttransformer.layer_kinds(tcfg)):
            sub = (jp["periods"][f"b{i % 3}"] if i < 3 * n_per
                   else jp["tail"][f"t{i - 3 * n_per}"])
            take = (lambda a: a[i // 3]) if i < 3 * n_per else (lambda a: a)
            mods = (("rglru.q_proj", "rglru.gate_proj", "mlp.gate_proj", "mlp.down_proj")
                    if kind == "rglru" else ("q_proj", "mlp.gate_proj", "mlp.down_proj"))
            for m in mods:
                leaf = sub
                for part in m.split("."):
                    leaf = leaf[part]
                name = f"blocks.{i}.{m}"
                want_names.append(name)
                np.testing.assert_allclose(got[name].numpy(), take(leaf["amber_scale"]),
                                           rtol=1e-6, atol=0)
            if kind == "rglru":
                assert "amber_scale" in sub["rglru"]["gate_a"]
    assert sorted(got) == sorted(want_names)


def test_from_jax_params_maps_periods_and_the_tail(models):
    """RecurrentGemma's 5 layers are period 0's b0, b1, b2 then the tail's
    t0, t1; in a bf16 model ``lam`` (and RWKV6's ``w0`` and ``u``) stay
    float32 and the rest is bf16."""
    jm, params, _, tcfg = models["recurrentgemma_2b"]
    pn = jax.tree_util.tree_map(np.asarray, params)
    tp = from_jax_params(tcfg, pn, device="cpu")
    assert [type(b).__name__ for b in tp.blocks] == ["RGLRULayer", "RGLRULayer", "AttnBlock",
                                                     "RGLRULayer", "RGLRULayer"]
    np.testing.assert_array_equal(tp.blocks[1].rglru.conv_w.numpy(),
                                  pn["periods"]["b1"]["rglru"]["conv_w"][0])
    np.testing.assert_array_equal(tp.blocks[2].q_proj.w.numpy(),
                                  pn["periods"]["b2"]["q_proj"]["w"][0])
    np.testing.assert_array_equal(tp.blocks[4].rglru.lam.numpy(), pn["tail"]["t1"]["rglru"]["lam"])
    np.testing.assert_array_equal(tp.blocks[3].mlp.down_proj.w.numpy(),
                                  pn["tail"]["t0"]["mlp"]["down_proj"]["w"])
    for arch, f32 in (("recurrentgemma_2b", ("rglru.lam",)),
                      ("rwkv6_7b", ("rwkv.tm.w0", "rwkv.tm.u"))):
        cfg16 = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
        p16 = jax.tree_util.tree_map(np.asarray, jbuild(cfg16).init(jax.random.PRNGKey(0)))
        tp16 = from_jax_params(dataclasses.replace(tget(arch), dtype="bfloat16"), p16,
                               device="cpu")
        dtypes = {n: p.dtype for n, p in tp16.blocks[0].named_parameters()}
        assert all(dtypes[n] == torch.float32 for n in f32)
        assert all(dt == torch.bfloat16 for n, dt in dtypes.items() if n not in f32)


def test_dyadic_sizes_match_jax():
    for cap in (1, 8, 16, 256):
        for n in range(0, 601):
            assert _dyadic_sizes(n, cap) == jdyadic(n, cap), (n, cap)


def test_unported_recurrent_layouts_raise(models):
    """A recurrent model's paged cache raises.  Its W8A8 rewrite is ported
    (``tests/test_torch_quant_families.py``) and asks for the calibration
    absmax by each projection's place in the module tree."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.weights import quantize_linears

    tm, tcfg = models["rwkv6_7b"][2:]
    with pytest.raises(KeyError, match="tm.r_proj"):
        quantize_linears(tm.init(0), {}, QuantConfig())
    with pytest.raises(ValueError):
        ttransformer.init_cache(tcfg, 1, 16, device="cpu", paged=True)
    assert not ttransformer.pools_anything(tcfg)


# ------------------------------------------------------------------- serving

SERVE = dict(max_seq=64, num_slots=2, chunk_size=8)
PROMPTS = [np.random.default_rng(3).integers(0, 256, size=n).astype(np.int32)
           for n in (5, 37, 12, 22)]
ARRIVALS, NEW = [0, 0, 2, 5], [6, 9, 5, 7]


def _submit(eng):
    for p, a, n in zip(PROMPTS, ARRIVALS, NEW):
        eng.submit(p, max_new_tokens=n, arrival=a)
    return eng


@pytest.fixture(scope="module")
def served(models):
    """The JAX engine's run per (arch, fused) under ``paper_policy(8, 16)``,
    with its params."""
    out = {}
    for arch in ARCHS:
        jm, params = models[arch][:2]
        jpol = jpolicy.paper_policy(8, 16)
        jp = jprecompute(params, jpol)
        for fused in (True, False):
            eng = _submit(JContinuous(jm, jpol, JConfig(**SERVE, fused_step=fused)))
            assert not eng.paged and eng.exec.exact_chunks
            out[arch, fused] = (jax.tree_util.tree_map(np.asarray, jp), eng.run(jp))
    return out


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_matches_jax(models, served, arch, fused, use_kernels):
    """The same stream (one 37-token prompt: chunks 8, 8, 8, 8, 4, 1) on
    both engines: outputs, ``trace_counts`` (one per chunk length a
    program ran), iterations, dispatches and done iterations equal; the
    slab, no pool, no prefix cache."""
    tm, tcfg = models[arch][2:]
    params_np, jres = served[arch, fused]
    eng = _submit(ContinuousServingEngine(
        tm, tpolicy.paper_policy(8, 16).with_(use_kernels=use_kernels),
        ContinuousConfig(**SERVE, fused_step=fused)))
    assert eng.exec.exact_chunks and not eng.paged and eng.pool is None
    assert not eng.sched.prefix_cache
    res = eng.run(from_jax_params(tcfg, params_np, device="cpu"))
    assert res["outputs"] == jres["outputs"]
    assert res["metrics"]["trace_counts"] == dict(jres["metrics"]["trace_counts"])
    assert res["metrics"]["trace_counts"][("step_prefill" if fused else "prefill")] > 1
    for key in ("iterations", "dispatches", "generated_tokens"):
        assert res["metrics"][key] == jres["metrics"][key], key
    assert [r["done_iter"] for r in res["metrics"]["requests"]] == \
        [r["done_iter"] for r in jres["metrics"]["requests"]]
    assert res["metrics"]["paged"] == jres["metrics"]["paged"] == {"enabled": False}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_leaves_inactive_slots_state_unchanged(models, arch):
    """A fused prefill+decode step: slot 0 decodes, slot 1 is mid-prefill
    and slot 2 is empty; the decode half leaves the recurrent state of
    slots 1 and 2 bit-unchanged (slot 1's moves only by its own chunk,
    which the same chunk run alone reproduces) and moves slot 0's."""
    from repro_torch.serve.executor import Executor
    from repro_torch.serve.scheduler import DecodeWork, PrefillWork, StepPlan
    from types import SimpleNamespace

    tm, tcfg = models[arch][2:]
    params = tm.init(0)
    cfg = ContinuousConfig(max_seq=32, num_slots=3, chunk_size=8)
    ex = Executor(tm, tpolicy.paper_policy(8, 16), cfg)
    ex.init_cache(None)
    g = torch.Generator().manual_seed(2)
    for layer in ex.cache["layers"]:
        for leaf in layer.values():
            leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype))
    ex.cache["pos"].copy_(torch.tensor([9, 4, 0], dtype=torch.int32))
    before = [{k: v.clone() for k, v in layer.items()} for layer in ex.cache["layers"]]
    chunk = np.arange(4, dtype=np.int32)[None, :] + 7
    prefill = PrefillWork(SimpleNamespace(slot=1), chunk, 4, False)
    decode = DecodeWork([], np.array([3, 0, 0], np.int32), np.array([True, False, False]))
    ex.step(params, StepPlan(prefill=prefill, decode=decode))
    fused = [{k: v.clone() for k, v in layer.items()} for layer in ex.cache["layers"]]
    # slot 1 after its chunk alone, from the same state
    for layer, old in zip(ex.cache["layers"], before):
        for k, v in layer.items():
            v.copy_(old[k])
    ex.cache["pos"].copy_(torch.tensor([9, 4, 0], dtype=torch.int32))
    ex.step(params, StepPlan(prefill=prefill))
    kinds = ttransformer.layer_kinds(tcfg)
    moved = False
    for kind, new, alone, old in zip(kinds, fused, ex.cache["layers"], before):
        if kind == "attn":
            continue
        for k in new:
            assert torch.equal(new[k][1], alone[k][1]), (kind, k)
            assert torch.equal(new[k][2], old[k][2]), (kind, k)
            moved |= not torch.equal(new[k][0], old[k][0])
    assert moved
