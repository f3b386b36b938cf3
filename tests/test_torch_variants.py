"""The dense-family variants of the port against the JAX package, on the CPU:
Qwen2.5-32B (q/k/v biases, G = 5), ChatGLM3-6B (2-D RoPE, q/k/v biases,
G = 2 in its smoke config), StableLM-3B (LayerNorm with a bias, MHA) and
Granite-34B (MQA), each through its ``smoke()`` config in float32.

Inputs and weight perturbations are made with numpy from a seed and fed to
both packages.  The LayerNorm biases and weights and the q/k/v biases,
which the JAX initialiser leaves at zero and one, are set to seeded values
so that each is exercised.  The port's kernel wrappers run their plain
versions on the CPU; the JAX side runs as its own tests run it.  Float32
differences are summation order only; greedy tokens and int8 codes are
identical.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.base import get_smoke_config
from repro.core import nm as jnm
from repro.core import policy as jpolicy
from repro.core import quant as jq
from repro.core import scoring as jscoring
from repro.core.pruner import precompute_scales as jprecompute
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.serve.api import Engine as JEngine
from repro.serve.api import EngineConfig as JEngineConfig
from repro.serve.continuous import ContinuousConfig as JConfig
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import nm
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import osparse_matmul as kos
from repro_torch.kernels import paged_attention as kpa
from repro_torch.layers.linear import QuantLinear
from repro_torch.models import build_model, common
from repro_torch.serve import (ContinuousConfig, Engine, EngineConfig, ServeConfig,
                               ServingEngine)
from repro_torch.weights import from_jax_params

ARCHS = ("qwen2_5_32b", "chatglm3_6b", "stablelm_3b", "granite_34b")
# float32 logits; differences are summation order only
TOL = dict(rtol=1e-4, atol=1e-4)
# float32 elementwise functions: an ulp or two of float32
F32 = dict(rtol=1e-5, atol=1e-5)
POLICIES = {
    "dense": (jpolicy.DENSE, tpolicy.DENSE),
    "paper_2_4": (jpolicy.paper_policy(2, 4), tpolicy.paper_policy(2, 4)),
}
TOKS = np.random.default_rng(1).integers(0, 256, size=(2, 19))
PROMPT = np.random.default_rng(2).integers(0, 256, size=21)       # 3 chunks of 8
SERVE = dict(max_seq=64, num_slots=2, chunk_size=8, block_size=8, num_blocks=8)
ONE_SHOT_SEQ, NEW = 32, 6


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


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------ norms and RoPE

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_layer_norm_matches_jax(with_bias, dtype):
    """``layer_norm`` on a LayerNorm (w and b) and on a norm without ``b``,
    with an offset mean (where an unbiased variance would show): float32 to
    summation order, bfloat16 to one rounding of the result."""
    x = _np(3, 2, 7, 96) * 3 + 5
    w, b = _np(4, 96) + 1, _np(5, 96)
    p = {"w": jnp.asarray(w, dtype)}
    norm = common.LayerNorm(96, dtype=torch.float32, device="cpu")
    norm.w.data = torch.from_numpy(np.array(p["w"].astype(jnp.float32)))
    if with_bias:
        p["b"] = jnp.asarray(b, dtype)
        norm.b.data = torch.from_numpy(np.array(p["b"].astype(jnp.float32)))
    else:
        norm = common.RMSNorm(96, dtype=torch.float32, device="cpu")
        norm.w.data = torch.from_numpy(np.array(p["w"].astype(jnp.float32)))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    norm = norm.to(tdtype)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jcommon.layer_norm(xj, p).astype(jnp.float32))
    got = common.layer_norm(torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdtype),
                            norm)
    assert got.dtype == tdtype
    tol = F32 if dtype == jnp.float32 else dict(rtol=2.0**-7, atol=2.0**-7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_allclose(
        common.norm_apply(got.float(), norm.float(), "layernorm").numpy(),
        np.asarray(jcommon.norm_apply(jnp.asarray(got.float().numpy()),
                                      {k: v.astype(jnp.float32) for k, v in p.items()},
                                      "layernorm")), **F32)


def test_init_norm_kinds_match_jax():
    for kind in ("rmsnorm", "layernorm"):
        want = jcommon.init_norm(10, kind)
        got = common.init_norm(10, kind, dtype=torch.float32, device="cpu")
        assert sorted(n for n, _ in got.named_parameters()) == sorted(want)
        for name, arr in want.items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(arr))
    with pytest.raises(NotImplementedError):
        common.init_norm(10, "groupnorm", dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [128, 80, 16])
def test_apply_rope_2d_matches_jax(hd, dtype):
    """Rotary on the first half of head_dim with frequencies over that half
    (``rope_freqs(hd, theta, rotary_dim=hd // 2)``), the second half passed
    through unchanged; positions up to 40000."""
    x = _np(6, 2, 5, 3, hd)
    pos = np.random.default_rng(7).integers(0, 40000, size=(2, 5))
    np.testing.assert_allclose(common.rope_freqs(hd, 1e4, rotary_dim=hd // 2).numpy(),
                               np.asarray(jcommon.rope_freqs(hd, 1e4, rotary_dim=hd // 2)),
                               rtol=1e-6)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jcommon.apply_rope_2d(xj, jnp.asarray(pos), 1e4).astype(jnp.float32))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdtype)
    got = common.apply_rope_2d(xt, torch.from_numpy(pos), 1e4)
    assert got.dtype == tdtype
    tol = F32 if dtype == jnp.float32 else dict(rtol=2.0**-7, atol=2.0**-7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    assert torch.equal(got[..., hd // 2:], xt[..., hd // 2:])
    # the default RoPE still rotates the whole head
    np.testing.assert_allclose(
        common.apply_rope(xt.float(), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jcommon.apply_rope(xj.astype(jnp.float32), jnp.asarray(pos), 1e4)), **F32)


# --------------------------------------------------------- small leftovers

def test_sparsity_fraction_matches_jax():
    x = _np(8, 4, 64)
    x[x < 0.3] = 0.0
    for a in (x, np.zeros((3, 5), np.float32), np.ones(7, np.float32)):
        got = nm.sparsity_fraction(torch.from_numpy(a))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(jnm.sparsity_fraction(jnp.asarray(a)))
    pruned = nm.apply_nm(torch.from_numpy(x[0] + 2), torch.from_numpy(x[0] + 2), 2, 4)
    assert float(nm.sparsity_fraction(pruned)) == 0.5


def test_shape_cells_and_arch_ids_match_jax():
    assert [dataclasses.astuple(c) for c in tbase.SHAPE_CELLS] == \
        [dataclasses.astuple(c) for c in jbase.SHAPE_CELLS]
    assert [f.name for f in dataclasses.fields(tbase.ShapeCell)] == \
        [f.name for f in dataclasses.fields(jbase.ShapeCell)]
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.PAPER_ARCH_IDS == jbase.PAPER_ARCH_IDS
    assert set(ARCHS) <= set(tbase.ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_configs(arch):
    """``CONFIG`` and ``smoke()`` equal the JAX package's field for field,
    parameter counts included."""
    for tcfg, jcfg in ((tget_config(arch), jbase.get_config(arch)),
                       (tget(arch), get_smoke_config(arch))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.n_params() == jcfg.n_params()


# ------------------------------------------------------------ attention plans

@pytest.mark.parametrize("case,args,route", [
    # (dtype, B, Tq, Hq, Hkv, hd, bs, mb, aligned) over a 736-position table
    ("qwen2_5_chunk_g5", (torch.bfloat16, 1, 256, 40, 8, 128, 16, 46, True),
     ("wgmma", 12, 1, 12)),
    ("qwen2_5_decode_g5", (torch.bfloat16, 4, 1, 40, 8, 128, 16, 46, True),
     ("wgmma", 1, 4, 3)),
    ("chatglm3_chunk_g16", (torch.bfloat16, 1, 256, 32, 2, 128, 16, 46, True),
     ("wgmma", 4, 1, 12)),
    ("chatglm3_decode_g16", (torch.bfloat16, 4, 1, 32, 2, 128, 16, 46, True),
     ("wgmma", 1, 12, 1)),
    ("granite_chunk_g48", (torch.bfloat16, 1, 256, 48, 1, 128, 16, 46, True),
     ("wgmma", 1, 1, 12)),
    ("granite_decode_g48", (torch.bfloat16, 4, 1, 48, 1, 128, 16, 46, True),
     ("wgmma", 1, 4, 3)),
    ("stablelm_chunk_hd80", (torch.bfloat16, 1, 256, 32, 32, 80, 16, 46, True),
     ("wgmma", 64, 1, 12)),
    ("stablelm_decode_hd80", (torch.bfloat16, 4, 1, 32, 32, 80, 16, 46, True),
     ("wgmma", 1, 1, 12)),
    ("stablelm_chunk_hd80_f32", (torch.float32, 1, 256, 32, 32, 80, 16, 46, True),
     ("rows", 0, 1, 46)),
    ("stablelm_decode_hd80_f32", (torch.float32, 4, 1, 32, 32, 80, 16, 46, True),
     ("rows", 0, 12, 4)),
])
def test_attention_plan_variants(case, args, route):
    """The variants' serving shapes: the wgmma route packs 12, 4 and 1
    tokens of G = 5, 16 and 48 heads (60, 64 and 48 of the 64 rows), and
    StableLM-3B's 64 tokens of one head at head_dim 80 on the 128-column
    tile (its 32 KV heads give 128 blocks a step, so decode does not split);
    in float32, head_dim 80 keeps the CUDA-core rows kernel, one walk per
    row for a chunk and a split walk for decode."""
    plan = kpa.attention_plan(*args, sms=132)
    assert plan == route
    assert plan.tile_hd == (128 if plan[0] == "wgmma" else 0)
    _, b, tq, hq, hkv, hd, bs, mb, _ = args
    if plan[0] == "wgmma":
        assert plan[1] * (hq // hkv) <= 64 and plan[2] * plan[3] >= -(-mb * bs // 64)
    else:
        assert plan[2] * plan[3] >= mb > (plan[2] - 1) * plan[3]


# ------------------------------------------------------------------ models

def _seeded(params, cfg):
    """The JAX params with seeded LayerNorm weights and biases and seeded
    q/k/v biases (the initialiser's are ones and zeros)."""
    blk = dict(params["periods"]["b0"])
    for i, name in enumerate(("ln1", "ln2")):
        blk[name] = {k: jnp.asarray(_np(40 + 2 * i + (k == "b"), *v.shape) * 0.2
                                    + (k == "w")) for k, v in blk[name].items()}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        if "b" in blk[name]:
            blk[name] = {**blk[name],
                         "b": jnp.asarray(_np(50 + i, *blk[name]["b"].shape) * 0.1)}
    fn = {k: jnp.asarray(_np(60 + (k == "b"), *v.shape) * 0.2 + (k == "w"))
          for k, v in params["final_norm"].items()}
    return {**params, "final_norm": fn, "periods": {**params["periods"], "b0": blk}}


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX cfg, port cfg, JAX model, seeded JAX params), float32."""
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        jm = jbuild(cfg)
        out[arch] = (cfg, dataclasses.replace(tget(arch), dtype="float32"), jm,
                     _seeded(jm.init(jax.random.PRNGKey(0)), cfg))
    return out


def _chunks():
    """(tokens (1, 8), chunk_len) — the last chunk padded."""
    for s in range(0, len(PROMPT), 8):
        part = PROMPT[s:s + 8]
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :len(part)] = part
        yield chunk, len(part)


@pytest.fixture(scope="module")
def reference(models):
    """Per (arch, policy): the JAX params with Amber scales (numpy), forward
    logits, each prefill chunk's logits and three greedy decode steps."""
    out = {}
    for arch, (cfg, _, jm, params) in models.items():
        for name, (jpol, _) in POLICIES.items():
            jp = jprecompute(params, jpol)
            fwd = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(TOKS)}, policy=jpol,
                                        phase="prefill"))
            cache, chunks, steps = jm.init_cache(1, 48), [], []
            for chunk, clen in _chunks():
                jl, cache = jm.prefill_chunk(
                    jp, {"tokens": jnp.asarray(chunk),
                         "chunk_len": jnp.asarray(clen, jnp.int32)}, cache, policy=jpol)
                chunks.append(np.asarray(jl))
            for _ in range(3):
                tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
                jl, cache = jm.decode_step(jp, jnp.asarray(tok), cache, policy=jpol)
                steps.append((tok, np.asarray(jl)))
            out[arch, name] = (jax.tree_util.tree_map(np.asarray, jp), fwd, chunks, steps)
    return out


def _port(models, reference, arch, name, use_kernels):
    tcfg = models[arch][1]
    return (build_model(tcfg, device="cpu"),
            from_jax_params(tcfg, reference[arch, name][0], device="cpu"),
            POLICIES[name][1].with_(use_kernels=use_kernels))


@pytest.mark.parametrize("arch", ARCHS)
def test_norm_and_bias_weights_carried_from_jax(models, arch):
    """``from_jax_params`` carries LayerNorm ``b`` (ln1, ln2, final_norm) and
    the q/k/v biases; RMSNorm models have no ``b``."""
    cfg, tcfg, _, params = models[arch]
    pn = jax.tree_util.tree_map(np.asarray, params)
    tp = from_jax_params(tcfg, pn, device="cpu")
    layer = cfg.norm == "layernorm"
    assert isinstance(tp.final_norm, common.LayerNorm if layer else common.RMSNorm)
    np.testing.assert_array_equal(tp.final_norm.w.numpy(), pn["final_norm"]["w"])
    if layer:
        np.testing.assert_array_equal(tp.final_norm.b.numpy(), pn["final_norm"]["b"])
        assert np.abs(pn["final_norm"]["b"]).max() > 0
    src = pn["periods"]["b0"]
    for i, blk in enumerate(tp.blocks):
        for name in ("ln1", "ln2"):
            np.testing.assert_array_equal(getattr(blk, name).w.numpy(), src[name]["w"][i])
            if layer:
                np.testing.assert_array_equal(getattr(blk, name).b.numpy(), src[name]["b"][i])
            else:
                assert not hasattr(getattr(blk, name), "b")
        for name in ("q_proj", "k_proj", "v_proj"):
            lin = getattr(blk, name)
            assert (lin.b is not None) == cfg.qkv_bias
            if cfg.qkv_bias:
                np.testing.assert_array_equal(lin.b.numpy(), src[name]["b"][i])


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(models, reference, arch, name, use_kernels):
    tm, tp, tpol = _port(models, reference, arch, name, use_kernels)
    got = tm.forward(tp, {"tokens": torch.from_numpy(TOKS)}, policy=tpol, phase="prefill").numpy()
    np.testing.assert_allclose(got, reference[arch, name][1], **TOL)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_and_decode_logits_match(models, reference, arch, name, use_kernels):
    """A 21-token prompt in chunks of 8 (the last padded) then three greedy
    decode steps: RoPE at cache offsets, the paged write and read."""
    tm, tp, tpol = _port(models, reference, arch, name, use_kernels)
    _, _, chunks, steps = reference[arch, name]
    cache = tm.init_cache(1, 48, block_size=8)
    for (chunk, clen), want in zip(_chunks(), chunks):
        tl, cache = tm.prefill_chunk(
            tp, {"tokens": torch.from_numpy(chunk),
                 "chunk_len": torch.tensor(clen, dtype=torch.int32)}, cache, policy=tpol)
        np.testing.assert_allclose(tl.numpy(), want, **TOL)
    for tok, want in steps:
        assert int(torch.argmax(tl, dim=-1)[0]) == int(tok[0, 0])
        tl, cache = tm.decode_step(tp, torch.from_numpy(tok), cache, policy=tpol)
        np.testing.assert_allclose(tl.numpy(), want, **TOL)


# ------------------------------------------------------------------ engines

def _traffic():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 21, 13, 17)]
    return prompts, [0, 0, 2, 5], [8, 12, 6, 10]


@pytest.fixture(scope="module")
def served(models, reference):
    """Per (arch, policy): the JAX continuous engine's outputs and the JAX
    one-shot engine's tokens."""
    out = {}
    for arch, (cfg, _, jm, _) in models.items():
        for name, (jpol, _) in POLICIES.items():
            jp = jax.tree_util.tree_map(jnp.asarray, reference[arch, name][0])
            eng = JEngine.from_config(jm, JEngineConfig(serving=JConfig(**SERVE)),
                                      policy=jpol)
            for p, a, n in zip(*_traffic()):
                eng.submit(p, n, a)
            with warnings.catch_warnings():          # the reference's own deprecation
                warnings.simplefilter("ignore", DeprecationWarning)
                one = JServingEngine(jm, jpol, JServeConfig(max_seq=ONE_SHOT_SEQ))
            toks = np.asarray(one.generate(jp, {"tokens": jnp.asarray(TOKS[:, :16])},
                                           NEW)["tokens"])
            out[arch, name] = (eng.run(jp)["outputs"], toks)
    return out


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_tokens_match_jax(models, reference, served, arch, name,
                                            use_kernels):
    """Staggered requests through a 2-slot paged pool of 8 blocks (chunks of
    8, so prompts span chunks and the pool forces waits): the JAX engine's
    greedy tokens."""
    tm, tp, tpol = _port(models, reference, arch, name, use_kernels)
    eng = Engine.from_config(tm, EngineConfig(serving=ContinuousConfig(
        validate_pool=True, **SERVE)), policy=tpol, device="cpu")
    for p, a, n in zip(*_traffic()):
        eng.submit(p, n, a)
    res = eng.run(tp)
    assert res["outputs"] == served[arch, name][0]
    assert all(len(o) == n for o, n in zip(res["outputs"].values(), _traffic()[2]))


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_one_shot_engine_tokens_match_jax(models, reference, served, arch, name,
                                          use_kernels):
    tm, tp, tpol = _port(models, reference, arch, name, use_kernels)
    out = ServingEngine(tm, tpol, ServeConfig(max_seq=ONE_SHOT_SEQ)).generate(
        tp, {"tokens": torch.from_numpy(TOKS[:, :16])}, max_new_tokens=NEW)
    np.testing.assert_array_equal(out["tokens"].numpy(), served[arch, name][1])


# ------------------------------------------------------------------- W8A8

QPOL = (jpolicy.paper_policy(8, 16), tpolicy.paper_policy(8, 16))
QUANT = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj")
W8A8_ARCHS = ("qwen2_5_32b", "chatglm3_6b")


def _absmax(seed, d):
    x = _np(seed, 64, d) * (1 + 10 * (np.arange(d) < 4))
    return np.abs(x).max(axis=0).astype(np.float32)


def _quantize_jax(params, cfg):
    """The reference's rewrite (``make_quantized_linear``, ``QuantConfig()``)
    of q/k/v/o/gate/up in every layer, the biases and Amber scales kept."""
    keys = ("wq", "w_scale", "smooth", "act_scale")
    rewrite = jax.jit(jax.vmap(lambda w, am: (lambda ql: tuple(getattr(ql, k) for k in keys))(
        jq.make_quantized_linear(w, am, jq.QuantConfig()))))
    blk = dict(params["periods"]["b0"])
    mlp = dict(blk["mlp"])
    for name in QUANT:
        owner = mlp if name in ("gate_proj", "up_proj") else blk
        p = owner[name]
        am = np.stack([_absmax(100 * i + len(name), p["w"].shape[1])
                       for i in range(cfg.n_layers)])
        q = dict(zip(keys, rewrite(p["w"], jnp.asarray(am))))
        q.update({k: v for k, v in p.items() if k != "w"})
        owner[name] = q
    blk["mlp"] = mlp
    return {**params, "periods": {**params["periods"], "b0": blk}}


@pytest.fixture(scope="module")
def qserved(models):
    """Per arch: the quantized JAX params (numpy) and the JAX engine's
    outputs under the paper's policy plus W8A8."""
    out = {}
    for arch in W8A8_ARCHS:
        cfg, _, jm, params = models[arch]
        jp = _quantize_jax(jprecompute(params, QPOL[0]), cfg)
        eng = JEngine.from_config(jm, JEngineConfig(serving=JConfig(**SERVE)), policy=QPOL[0])
        for p, a, n in zip(*_traffic()):
            eng.submit(p, n, a)
        out[arch] = (jax.tree_util.tree_map(np.asarray, jp), eng.run(jp)["outputs"])
    return out


@pytest.mark.parametrize("arch", W8A8_ARCHS)
def test_w8a8_codes_bit_identical(models, qserved, arch):
    """The carried int8 weights are the reference's codes bit for bit (stored
    K-major, the q/k/v biases in the ``QuantLinear``), and the activation
    codes of layer 0's q_proj input (the reference's own normed embedding
    of the prompt, smoothed, Amber-pruned, quantized with the static scale)
    are the reference's."""
    cfg, tcfg = models[arch][:2]
    pn = qserved[arch][0]
    tp = from_jax_params(tcfg, pn, device="cpu")
    src = pn["periods"]["b0"]
    for i, blk in enumerate(tp.blocks):
        for name in QUANT:
            mlp = name in ("gate_proj", "up_proj")
            lin = getattr(blk.mlp if mlp else blk, name)
            p = (src["mlp"] if mlp else src)[name]
            assert isinstance(lin, QuantLinear)
            assert lin.wq.stride() == (1, lin.wq.shape[0])
            np.testing.assert_array_equal(lin.wq.numpy(), p["wq"][i])
            if name in ("q_proj", "k_proj", "v_proj"):
                np.testing.assert_array_equal(lin.b.numpy(), p["b"][i])
    q0 = src["q_proj"]
    x = jcommon.norm_apply(jnp.take(jnp.asarray(pn["embed"]["w"]), jnp.asarray(TOKS), axis=0),
                           {k: jnp.asarray(v[0]) for k, v in src["ln1"].items()}, cfg.norm)
    xs = x / jnp.asarray(q0["smooth"][0])
    xs = jnm.apply_nm(xs, jscoring.score_activations(xs, jnp.asarray(q0["amber_scale"][0])),
                      8, 16)
    want = np.asarray(jq.quantize_act_per_tensor(xs, jnp.asarray(q0["act_scale"][0])))
    lin = tp.blocks[0].q_proj
    got, _ = kos.osparse_quantize_plain(torch.from_numpy(np.asarray(x)), lin.smooth,
                                        lin.amber_scale, 8, 16, lin.act_scale, prune=True)
    assert got.dtype == torch.int8 and (want != 0).mean() > 0.3
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", W8A8_ARCHS)
def test_w8a8_engine_tokens_match_jax(models, qserved, arch, use_kernels):
    """The paper's policy plus W8A8 (biases in the int8 epilogue) through the
    port's Engine: the JAX engine's greedy tokens."""
    tcfg = models[arch][1]
    pn, want = qserved[arch]
    eng = Engine.from_config(build_model(tcfg, device="cpu"),
                             EngineConfig(serving=ContinuousConfig(validate_pool=True,
                                                                   **SERVE)),
                             policy=QPOL[1].with_(use_kernels=use_kernels), device="cpu")
    for p, a, n in zip(*_traffic()):
        eng.submit(p, n, a)
    assert eng.run(from_jax_params(tcfg, pn, device="cpu"))["outputs"] == want


def test_chip_smoke_counts_the_variants_path():
    """``chip_smoke.py``'s phase 8: each variant prunes q, gate and down in
    every layer (48 ``nm_prune_matmul`` launches a chunk for Qwen2.5-32B,
    ChatGLM3-6B and StableLM-3B at the depth 16 they serve, 24 for
    Granite-34B at depth 8), no routed expert input; the depths it serves fit one 80 GB
    card in bf16, and Granite-34B's 88 layers do not."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    want = {"qwen2_5_32b": 48, "chatglm3_6b": 48, "stablelm_3b": 48, "granite_34b": 24}
    served = {arch: depth for _, arch, depth, _ in cs.VARIANT_SERVING}
    assert set(served) == set(want)
    for arch, launches in want.items():
        cfg = dataclasses.replace(tget_config(arch),
                                  n_layers=served[arch] or tget_config(arch).n_layers)
        pol = tpolicy.paper_policy(8, 16, cfg.qgate_skip_layers)
        assert cs.prune_launches(cfg, pol) == (launches, 0)
        assert 2 * cfg.n_params() < 80e9
    assert 2 * tget_config("granite_34b").n_params() > 80e9
    heads = {(hq, hkv, hd) for _, hq, hkv, hd in cs.VARIANT_HEADS}
    assert heads == {(c.n_heads, c.n_kv_heads, c.head_dim)
                     for c in map(tget_config, ARCHS)}
