"""Outstanding-sparse W8A8 on the MoE family against the JAX package, on the
Qwen3-30B-A3B and Llama-4-Scout (shared expert) ``smoke()`` configs in
float32 under ``paper_policy(8, 16, skips)``.

The JAX parameters are rewritten per layer with ``make_quantized_linear``
(``QuantConfig()``: alpha 0.10, Outstanding, ``down_proj`` left float) on
each MoE block's q/k/v/o and, where there is one, its shared expert's gate
and up projections; the routed experts stay float, as the reference has no
quantized grouped product.  The static variant quantizes activations with
the calibrated per-tensor scale, the per-token variant
(``QuantConfig(per_token_act=True)``, the paper's rule for MoE layers)
with dynamic per-token scales.  The carried int8 codes are the reference's
bit for bit; the port's own ``quantize_linears`` on the float model gives
the same codes; logits are allclose (``QTOL``) and greedy tokens equal the
JAX engine's, through the port's plain path and with ``use_kernels`` (the
kernels' plain versions on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core import quant as jq
from repro.core.pruner import precompute_scales as jprecompute
from repro.models import build_model as jbuild
from repro.serve.api import Engine as JEngine
from repro.serve.api import EngineConfig as JEngineConfig
from repro.serve.continuous import ContinuousConfig as JConfig
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.core import quant as tq
from repro_torch.layers.linear import Linear, QuantLinear
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
from repro_torch.weights import from_jax_params, quantize_linears

ARCHS = ("qwen3_30b_a3b", "llama4_scout_17b_a16e")
VARIANTS = ("static", "per_token")
ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
SHARED = ("gate_proj", "up_proj")           # QuantConfig() leaves down_proj float
KEYS = ("wq", "w_scale", "smooth", "act_scale")
# Float32 logits (as tests/test_torch_quant.py states it): upstream of each
# quantizer the packages differ by summation order (~1e-7 relative), which
# can move an activation across an int8 rounding boundary, one code a step
# off: ~1e-3 in that projection's output.  Under jit XLA also rewrites the
# per-token absmax / 127 as a reciprocal multiply, an ulp off on some rows.
# 1e-3 absolute covers such flips; the 2e-2 bound on the largest deviation
# bounds their count.
QTOL = dict(rtol=1e-3, atol=1e-3)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class _Flag:
    """``per_token=True`` in a JAX parameter dict.  A node without leaves, so
    it rides through ``jit`` and ``lax.scan`` as static data (a Python bool
    leaf would be traced, and ``bool()`` of a tracer raises)."""
    value: bool

    def __bool__(self):
        return self.value


def _absmax(seed, d):
    """Calibration absmax with a few outlier channels."""
    x = np.random.default_rng(seed).standard_normal((64, d)).astype(np.float32)
    return np.abs(x * (1 + 10 * (np.arange(d) < 4))).max(axis=0).astype(np.float32)


def _owners(blk):
    """(dict, names) of the projections W8A8 rewrites in a stacked MoE block."""
    yield blk, ATTN
    if "shared" in blk["moe"]:
        yield blk["moe"]["shared"], SHARED


def _quantize_jax_params(params, per_token):
    """Per-layer ``make_quantized_linear`` stacked over the scanned layer axis,
    the Amber scales computed from the float weights kept beside ``wq``."""
    qcfg = jq.QuantConfig(per_token_act=per_token)
    rewrite = jax.jit(jax.vmap(lambda w, am: (lambda ql: tuple(getattr(ql, k) for k in KEYS))(
        jq.make_quantized_linear(w, am, qcfg))))
    blk = dict(params["periods"]["b0"])
    moe = blk["moe"] = dict(blk["moe"])
    if "shared" in moe:
        moe["shared"] = dict(moe["shared"])
    for owner, names in _owners(blk):
        for name in names:
            p = owner[name]
            n_layers, d_in = p["w"].shape[:2]
            am = np.stack([_absmax(100 * i + len(name), d_in) for i in range(n_layers)])
            q = dict(zip(KEYS, rewrite(p["w"], jnp.asarray(am))))
            q.update({k: v for k, v in p.items() if k != "w"})
            if per_token:
                q["per_token"] = _Flag(True)
            owner[name] = q
    return {**params, "periods": {**params["periods"], "b0": blk}}


def _port_absmax(cfg):
    """The same calibration absmax, keyed for ``quantize_linears``."""
    d_in = {"o_proj": cfg.q_dim}
    names = ATTN + (SHARED if cfg.shared_expert else ())
    return {(i, name): _absmax(100 * i + len(name), d_in.get(name, cfg.d_model))
            for i in range(cfg.n_layers) for name in names}


PROMPT = np.random.default_rng(2).integers(0, 256, size=21)   # 3 chunks of 8
TOKS = np.random.default_rng(1).integers(0, 256, size=(2, 19))


def _chunks():
    for s in range(0, len(PROMPT), 8):
        part = PROMPT[s:s + 8]
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :len(part)] = part
        yield chunk, len(part)


def _traffic():
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, size=16)               # two full blocks
    prompts = [rng.integers(0, 256, size=n) for n in (5, 21)]
    prompts += [np.concatenate([shared, rng.integers(0, 256, size=n)]) for n in (7, 11, 3)]
    return prompts, [0, 0, 2, 4, 9], [8, 12, 6, 10, 5]


SERVE = dict(max_seq=64, num_slots=2, chunk_size=8, block_size=8)


def _policies(cfg):
    skip = cfg.qgate_skip_layers
    return jpolicy.paper_policy(8, 16, skip), tpolicy.paper_policy(8, 16, skip)


@pytest.fixture(scope="module")
def reference():
    """Per (arch, variant): port cfg, the float and quantized JAX params as
    numpy, the JAX forward logits, each chunk's logits, four greedy decode
    steps, and the JAX continuous engine's outputs."""
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        tcfg = dataclasses.replace(tget(arch), dtype="float32")
        jm = jbuild(cfg)
        jpol = _policies(cfg)[0]
        params = jprecompute(jm.init(jax.random.PRNGKey(0)), jpol)
        fwd = jax.jit(lambda p, b, jm=jm: jm.forward(p, b, policy=jpol, phase="prefill"))
        prefill = jax.jit(lambda p, b, c, jm=jm: jm.prefill_chunk(p, b, c, policy=jpol))
        decode = jax.jit(lambda p, t, c, jm=jm: jm.decode_step(p, t, c, policy=jpol))
        for variant in VARIANTS:
            jp = _quantize_jax_params(params, variant == "per_token")
            logits = np.asarray(fwd(jp, {"tokens": jnp.asarray(TOKS)}))
            cache, chunks, steps = jm.init_cache(1, 48), [], []
            for chunk, clen in _chunks():
                jl, cache = prefill(jp, {"tokens": jnp.asarray(chunk),
                                         "chunk_len": jnp.asarray(clen, jnp.int32)}, cache)
                chunks.append(np.asarray(jl))
            for _ in range(4):
                tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
                jl, cache = decode(jp, jnp.asarray(tok), cache)
                steps.append((tok, np.asarray(jl)))
            eng = JEngine.from_config(jm, JEngineConfig(serving=JConfig(**SERVE)),
                                      policy=jpol)
            for p, a, n in zip(*_traffic()):
                eng.submit(p, n, a)
            out[arch, variant] = dict(
                cfg=tcfg, float_np=jax.tree_util.tree_map(np.asarray, params),
                quant_np=jax.tree_util.tree_map(np.asarray, jp), fwd=logits, chunks=chunks,
                steps=steps, served=eng.run(jp)["outputs"])
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, **QTOL)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _quantized(blk):
    """(name, module) of the projections W8A8 rewrites in a port MoE block."""
    yield from ((n, getattr(blk, n)) for n in ATTN)
    if blk.moe.shared is not None:
        yield from ((n, getattr(blk.moe.shared, n)) for n in SHARED)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_moe_quantized_dicts(reference, arch, variant):
    """Every rewritten projection of an MoE block, the shared expert's
    included, becomes a ``QuantLinear`` holding the reference's int8 codes
    bit for bit, stored K-major, with its per-token flag; the shared
    expert's down_proj and the routed experts stay float."""
    ref = reference[arch, variant]
    cfg, pn = ref["cfg"], ref["quant_np"]
    tp = from_jax_params(cfg, pn, device="cpu")
    src = pn["periods"]["b0"]
    for i, blk in enumerate(tp.blocks):
        for name, lin in _quantized(blk):
            p = (src if name in ATTN else src["moe"]["shared"])[name]
            assert isinstance(lin, QuantLinear) and lin.wq.dtype == torch.int8
            np.testing.assert_array_equal(lin.wq.numpy(), p["wq"][i])
            assert lin.wq.stride() == (1, lin.wq.shape[0])
            assert lin.per_token == (variant == "per_token")
            assert float(lin.act_scale) == p["act_scale"][i]
        if blk.moe.shared is not None:
            assert isinstance(blk.moe.shared.down_proj, Linear)
        assert isinstance(blk.moe.experts, tmoe.Experts)
        assert blk.moe.experts.gate_proj.dtype == torch.float32
    assert (cfg.shared_expert) == (arch == "llama4_scout_17b_a16e")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_linears_on_moe_matches_make_quantized_linear(reference, arch, variant):
    """The port's own rewrite of the float MoE model (it raised before) gives
    the reference's int8 codes bit for bit, and leaves the routed experts
    untouched in the model dtype."""
    ref = reference[arch, variant]
    cfg = ref["cfg"]
    want = from_jax_params(cfg, ref["quant_np"], device="cpu")
    got = from_jax_params(cfg, ref["float_np"], device="cpu")
    experts = [{k: v.clone() for k, v in blk.moe.experts.named_parameters()}
               for blk in got.blocks]
    quantize_linears(got, _port_absmax(cfg), tq.QuantConfig(
        per_token_act=variant == "per_token"))
    for gb, wb, ex in zip(got.blocks, want.blocks, experts):
        for (name, g), (_, w) in zip(_quantized(gb), _quantized(wb)):
            assert isinstance(g, QuantLinear) and not hasattr(g, "w"), name
            assert torch.equal(g.wq, w.wq), name
            assert g.wq.stride() == w.wq.stride() == (1, g.wq.shape[0])
            assert g.per_token == w.per_token
            for key in ("w_scale", "smooth", "act_scale"):
                np.testing.assert_allclose(getattr(g, key).numpy(), getattr(w, key).numpy(),
                                           rtol=1e-6, atol=0)
            assert (g.amber_scale is None) == (w.amber_scale is None)
        for k, v in gb.moe.experts.named_parameters():
            assert torch.equal(v, ex[k]) and v.dtype == torch.float32


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_moe_logits_and_tokens_match(reference, arch, variant, use_kernels):
    """forward, a 21-token prompt in chunks of 8 (the last padded), then four
    greedy decode steps: logits close, greedy tokens identical."""
    ref = reference[arch, variant]
    cfg = ref["cfg"]
    tm, tp = build_model(cfg, device="cpu"), from_jax_params(cfg, ref["quant_np"], device="cpu")
    tpol = _policies(cfg)[1].with_(use_kernels=use_kernels)
    got = tm.forward(tp, {"tokens": torch.from_numpy(TOKS)}, policy=tpol, phase="prefill").numpy()
    _close(got, ref["fwd"])
    assert (got.argmax(-1) == ref["fwd"].argmax(-1)).all()
    cache = tm.init_cache(1, 48, block_size=8)
    for (chunk, clen), want in zip(_chunks(), ref["chunks"]):
        tl, cache = tm.prefill_chunk(
            tp, {"tokens": torch.from_numpy(chunk),
                 "chunk_len": torch.tensor(clen, dtype=torch.int32)}, cache, policy=tpol)
        _close(tl.numpy(), want)
    for tok, want in ref["steps"]:
        assert int(torch.argmax(tl, dim=-1)[0]) == int(tok[0, 0])
        tl, cache = tm.decode_step(tp, torch.from_numpy(tok), cache, policy=tpol)
        _close(tl.numpy(), want)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_moe_engine_matches_jax_engine(reference, arch, variant, use_kernels):
    """Staggered requests, three behind a shared two-block prefix, through the
    port's Engine and the JAX engine: the same greedy tokens."""
    ref = reference[arch, variant]
    cfg = ref["cfg"]
    eng = Engine.from_config(
        build_model(cfg, device="cpu"),
        EngineConfig(serving=ContinuousConfig(validate_pool=True, **SERVE)),
        policy=_policies(cfg)[1].with_(use_kernels=use_kernels), device="cpu")
    for p, a, n in zip(*_traffic()):
        eng.submit(p, n, a)
    res = eng.run(from_jax_params(cfg, ref["quant_np"], device="cpu"))
    assert res["outputs"] == ref["served"]
    assert all(len(o) == n for o, n in zip(res["outputs"].values(), _traffic()[2]))
