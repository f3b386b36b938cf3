"""Outstanding-sparse W8A8 on the recurrent and encoder-decoder families
against the JAX package: the RWKV6-7B, RecurrentGemma-2B and Whisper-medium
``smoke()`` configs in float32 under ``paper_policy(8, 16)``.

The reference has no rewrite function: any of its ``sparse_linear`` calls
takes a dict built by ``make_quantized_linear``.  So the JAX trees are built
here by hand, one eager ``make_quantized_linear`` per projection and layer
(stacked back over the scanned or vmapped layer axis) on every projection
``QuantConfig().should_quantize`` selects under the module name its JAX
call passes, as the JAX source writes it (``JAX_CALLS``; RWKV6: r/k/v/g as
``q_proj``, so 7 of 8 a layer, the channel mix's ``down_proj`` left float;
RG-LRU: W_in, W_gate, W_out and the MLP's gate and up; Whisper: every
attention's q/k/v/o, the decoder's cross attention included, and fc1, fc2
left float), from a calibration absmax seeded by the projection's place in
the JAX tree.  That table, and the port's own labels
(``weights.projection_sites``), are held to the ``sparse_linear`` calls the
JAX package makes, recorded while it computes the reference logits
(``_jax_steps``).  The per-token variant
(``QuantConfig(per_token_act=True)``) carries its flag as a leafless node.

Held here: ``from_jax_params`` of the JAX trees carries their int8 codes
and float32 scales bit for bit; the port's own ``quantize_linears`` gives
the same int8 codes bit for bit and the same weight scales, smooth factors
and activation scales within ``REWRITE`` (the smooth factor raises float32
values to a fractional power, where XLA's and torch's ``pow`` differ by an
ulp: ``tests/test_torch_quant.py``); logits of ``prefill`` (``forward``'s
last position) and three decode steps are within ``QTOL`` (float32; as
``tests/test_torch_moe_quant.py`` states it, a summation-order ulp upstream
of a quantizer can move one int8 code a step); greedy tokens equal the JAX
continuous engine's, static and per-token, on the port's plain path and
with ``use_kernels`` (the kernels' plain versions on the CPU).

The weights are the port's, made from a seed and carried into the JAX
tree (``_jax_tree``), and each JAX engine serves one request: the JAX
package compiles every program anew on the CPU, and the file has a time
budget.
"""
import contextlib
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core import quant as jq
from repro.layers import linear as jlinear
from repro.models import build_model as jbuild
from repro.models import encdec as jencdec
from repro.models import mlp as jmlp
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtransformer
from repro.serve.api import Engine as JEngine
from repro.serve.api import EngineConfig as JEngineConfig
from repro.serve.continuous import ContinuousConfig as JConfig
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.core import quant as tq
from repro_torch.core.pruner import precompute_scales
from repro_torch.layers.linear import Linear, QuantLinear
from repro_torch.models import build_model, transformer
from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
from repro_torch.weights import from_jax_params, projection_sites, quantize_linears

ARCHS = ("rwkv6_7b", "recurrentgemma_2b", "whisper_medium")
VARIANTS = ("static", "per_token")
KEYS = ("wq", "w_scale", "smooth", "act_scale")
QTOL = dict(rtol=1e-3, atol=1e-3)
REWRITE = dict(rtol=1e-6, atol=0)
# quantized projections a layer under QuantConfig(), by kind
PER_LAYER = {"rwkv6": 7, "rglru": 5, "attn": 6, "enc": 5, "dec": 9}


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class _Flag:
    """``per_token=True`` in a JAX parameter dict: a node without leaves, so
    it rides through ``jit`` and ``lax.scan`` as static data."""
    value: bool

    def __bool__(self):
        return self.value


def _absmax(key, d):
    """Calibration absmax with a few outlier channels, seeded by the key."""
    x = np.random.default_rng(zlib.crc32(repr(key).encode())).standard_normal((64, d))
    return np.abs(x * (1 + 10 * (np.arange(d) < 4))).max(axis=0).astype(np.float32)


def _jax_path(cfg, key):
    """(path into the JAX tree, layer index on its stacked axis or None) of
    the projection the port keys ``key``."""
    if cfg.is_encdec:
        stack, i, name = key
        return [f"{stack}_blocks", *name.split(".")], i
    i, name = key
    plen = len(cfg.block_pattern)
    n_per = cfg.n_layers // plen
    if i >= n_per * plen:
        head, idx = ["tail", f"t{i - n_per * plen}"], None
    else:
        head, idx = ["periods", f"b{i % plen}"], i // plen
    kind = transformer.layer_kinds(cfg)[i]
    if kind == "rwkv6":
        return head + ["rwkv", *name.split(".")], idx
    if "." in name:
        return head + name.split("."), idx
    return head + (["mlp", name] if name in ("gate_proj", "up_proj", "down_proj") else [name]), idx


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# The JAX package's sparse_linear calls of each block kind: (the weight
# dict's path in the block, the module name the call passes).
_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = [(("mlp", n), n) for n in ("gate_proj", "up_proj", "down_proj")]  # models/mlp.py:43-48
_FF = [(("ff", n), n) for n in ("gate_proj", "down_proj")]               # models/encdec.py:39-41
JAX_CALLS = {
    "attn": [((n,), n) for n in _ATTN] + _MLP,               # models/transformer.py:232-236, 378
    "rglru": [(("rglru", n), n) for n in ("q_proj", "gate_proj", "o_proj")] + _MLP,  # rglru.py:100-124
    "rwkv6": [(("rwkv", "tm", n), "q_proj") for n in ("r_proj", "k_proj_tm", "v_proj_tm", "g_proj")]
    + [(("rwkv", "tm", "o_proj"), "o_proj")]
    + [(("rwkv", "cm", n), n) for n in ("gate_proj", "down_proj", "up_proj")],  # rwkv6.py:129-171
    "enc": [(("attn", n), n) for n in _ATTN] + _FF,         # models/encdec.py:96-98, 114
    "dec": [((part, n), n) for part in ("self_attn", "cross_attn") for n in _ATTN] + _FF,  # :177-196
}


def _jax_sites(cfg):
    """(path of the weight dict in the JAX tree, layer index on its stacked
    axis or None, module name) of every JAX ``sparse_linear`` call, from
    ``JAX_CALLS``."""
    if cfg.is_encdec:
        return [((f"{stack}_blocks", *sub), i, module)
                for stack, n in (("enc", cfg.n_encoder_layers), ("dec", cfg.n_layers))
                for i in range(n) for sub, module in JAX_CALLS[stack]]
    plen = len(cfg.block_pattern)
    n_per = cfg.n_layers // plen
    sites = []
    for i in range(cfg.n_layers):
        head, idx = ((("tail", f"t{i - n_per * plen}"), None) if i >= n_per * plen else
                     (("periods", f"b{i % plen}"), i // plen))
        sites += [((*head, *sub), idx, module)
                  for sub, module in JAX_CALLS[cfg.block_pattern[i % plen]]]
    return sites


@contextlib.contextmanager
def _recording(tree, calls):
    """While open, every JAX ``sparse_linear`` call adds (path of its weight
    dict in ``tree``, layer index on the stacked axis or None, the module
    name it passes) to the dict ``calls``: the five model modules'
    ``sparse_linear`` is wrapped to hand its weight (``w``, or ``wq``) to
    ``jax.debug.callback``, which sees the concrete array also inside the
    layer scan and its ``remat``, and finds it in ``tree`` by its bytes."""
    where = {}

    def index(path, a):
        keys = tuple(k.key for k in path)
        if keys[-1] not in ("w", "wq"):
            return
        if keys[0] in ("periods", "enc_blocks", "dec_blocks"):
            where.update({a[i].tobytes(): (keys[:-1], i) for i in range(a.shape[0])})
        else:
            where[a.tobytes()] = (keys[:-1], None)

    jax.tree_util.tree_map_with_path(index, tree)
    real = jlinear.sparse_linear

    def spy(x, p, module, *args, **kwargs):
        def seen(w):
            calls[(*where[np.asarray(w).tobytes()], module)] = None

        jax.debug.callback(seen, p["wq"] if "wq" in p else p["w"])
        return real(x, p, module, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jtransformer, jmlp, jrwkv6, jrglru, jencdec):
            mp.setattr(mod, "sparse_linear", spy)
        yield


def _site(cfg, key):
    """The port's projection ``key`` as a place in the JAX tree."""
    path, idx = _jax_path(cfg, key)
    return tuple(path), idx


def _quantize_jax(cfg, float_np, per_token):
    """The JAX tree with every projection that ``should_quantize`` selects
    under the module name its JAX call passes (``_jax_sites``) rewritten by
    eager ``make_quantized_linear``, per layer, restacked; Amber scales and
    biases kept beside ``wq``."""
    qcfg = jq.QuantConfig(per_token_act=per_token)
    tree = jax.tree_util.tree_map(lambda a: a, float_np)     # fresh dicts, same leaves
    groups = {}
    for path, idx, module in _jax_sites(cfg):
        if not qcfg.should_quantize(module):
            continue
        w = _get(tree, path)["w"]
        w = w if idx is None else w[idx]
        ql = jq.make_quantized_linear(jnp.asarray(w),
                                      jnp.asarray(_absmax((path, idx), w.shape[0])), qcfg)
        groups.setdefault(tuple(path), {})[idx] = {k: np.asarray(getattr(ql, k)) for k in KEYS}
    for path, qls in groups.items():
        p = _get(tree, path)
        q = (qls[None] if None in qls else
             {k: np.stack([qls[i][k] for i in range(len(qls))]) for k in KEYS})
        q.update({k: v for k, v in p.items() if k != "w"})
        if per_token:
            q["per_token"] = _Flag(True)
        _get(tree, path[:-1])[path[-1]] = q
    return tree


def _port_absmax(model):
    return {key: _absmax(_site(model.cfg, key), getattr(owner, name).w.shape[0])
            for key, owner, name, _, _ in projection_sites(model)}


def _jax_tree(cfg, jm, port):
    """The JAX parameter tree of ``port`` (a port model made from a seed):
    the JAX init's structure (``jax.eval_shape``, nothing computed) filled
    from the port's modules, scan-stacked periods and vmap-stacked blocks
    restacked, and every Amber scale the port holds beside its ``w`` (the
    JAX init of these models is slow on the CPU; the weights only have to be
    the same on both sides)."""
    plen = len(cfg.block_pattern)
    n_per = cfg.n_layers // plen

    def at(obj, keys):
        for k in keys:
            obj = getattr(obj, k)
        return obj.detach().numpy()

    def fill(path, sds):
        keys = [p.key for p in path]
        if keys[0] == "periods":
            a = np.stack([at(port.blocks[i * plen + int(keys[1][1:])], keys[2:])
                          for i in range(n_per)])
        elif keys[0] == "tail":
            a = at(port.blocks[n_per * plen + int(keys[1][1:])], keys[2:])
        elif keys[0] in ("enc_blocks", "dec_blocks"):
            a = np.stack([at(b, keys[1:]) for b in getattr(port, keys[0])])
        else:
            a = at(port, keys)
        assert a.shape == sds.shape and a.dtype == sds.dtype, keys
        return a

    tree = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    scales = {}
    for key, owner, name, _, _ in projection_sites(port):
        if getattr(owner, name).amber_scale is not None:
            path, idx = _jax_path(cfg, key)
            scales.setdefault(tuple(path), {})[idx] = getattr(owner, name).amber_scale.numpy()
    for path, by_layer in scales.items():
        _get(tree, path)["amber_scale"] = (by_layer[None] if None in by_layer else np.stack(
            [by_layer[i] for i in range(len(by_layer))]))
    return tree


TOKS = np.random.default_rng(1).integers(0, 256, size=(2, 11)).astype(np.int32)
SERVE = dict(max_seq=32, num_slots=2, chunk_size=8)
PROMPT = np.random.default_rng(3).integers(0, 256, size=8).astype(np.int32)
NEW = 6
# the JAX engine runs: every family static, the per-token variant on RWKV6
# (the quantized call is the same in every family; its selection of
# projections is held for both variants above)
ENGINE_CASES = [(arch, "static") for arch in ARCHS] + [("rwkv6_7b", "per_token")]


def _stubs(cfg, b, seed):
    """``frame_embeds (b, encoder_seq, d_model)`` for the encoder-decoder."""
    if not cfg.is_encdec:
        return {}
    return {"frame_embeds": np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _serve(eng, params, cfg):
    """One request (a prompt of one chunk, its frame embeddings where the
    model takes them) served to the end: its tokens."""
    eng.submit(PROMPT, NEW)
    extras = {0: _stubs(cfg, 1, 100)} if cfg.is_encdec else {}
    return eng.run(params, extras=extras)["outputs"][0]


def _jax_steps(jm, jpol, params, batch, n=3):
    """JAX ``prefill`` then ``n`` greedy ``decode_step``s (a ``lax.scan``),
    in one program: ``[(None, prefill logits), (fed tokens, logits), ...]``,
    and the ``sparse_linear`` calls they made (``_recording``)."""
    def run(p, b):
        logits, cache = jm.prefill(p, b, jm.init_cache(2, 24), policy=jpol)

        def step(carry, _):
            lg, c = carry
            tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
            lg, c = jm.decode_step(p, tok, c, policy=jpol)
            return (lg, c), (tok, lg)

        _, (toks, steps) = jax.lax.scan(step, (logits, cache), None, length=n)
        return logits, toks, steps

    calls = {}
    with _recording(params, calls):
        first, toks, steps = jax.block_until_ready(jax.jit(run)(params, batch))
        jax.effects_barrier()
    return [(None, np.array(first))] + [(np.array(toks[i]), np.array(steps[i]))
                                        for i in range(n)], list(calls)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's smoke engines run thousands of tiny torch ops: with the
    suite's six workers, torch's intra-op thread pools oversubscribe the
    cores and slow them several-fold.  One thread a worker while this
    module runs; restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    """Per arch: the port cfg, the float JAX tree (numpy, from the port's
    seeded model with its Amber scales), per variant the quantized JAX tree
    and, for ``ENGINE_CASES``, the JAX continuous engine's tokens, and the
    static variant's JAX ``prefill`` logits and three greedy decode steps'."""
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        tcfg = dataclasses.replace(tget(arch), dtype="float32")
        jm = jbuild(cfg)
        jpol = jpolicy.paper_policy(8, 16, cfg.qgate_skip_layers)
        model = precompute_scales(build_model(tcfg, device="cpu").init(0),
                                  tpolicy.paper_policy(8, 16, cfg.qgate_skip_layers))
        float_np = _jax_tree(tcfg, jm, model)
        ref = out[arch] = dict(cfg=tcfg, float_np=float_np)
        for variant in VARIANTS:
            entry = ref[variant] = dict(tree=_quantize_jax(tcfg, float_np,
                                                           variant == "per_token"))
            if (arch, variant) in ENGINE_CASES:
                eng = JEngine.from_config(jm, JEngineConfig(serving=JConfig(**SERVE)),
                                          policy=jpol)
                entry["served"] = _serve(eng, entry["tree"], tcfg)
        jp = ref["static"]["tree"]
        batch = {"tokens": jnp.asarray(TOKS),
                 **{k: jnp.asarray(v) for k, v in _stubs(tcfg, 2, 4).items()}}
        ref["steps"], ref["calls"] = _jax_steps(jm, jpol, jp, batch)
    return out


def _pairs(got, want):
    """(key, got's projection, want's) over the sites."""
    sites = {k: getattr(o, n) for k, o, n, _, _ in projection_sites(want)}
    for key, owner, name, _, _ in projection_sites(got):
        yield key, getattr(owner, name), sites[key]


def _kind(cfg, key):
    return key[0] if cfg.is_encdec else transformer.layer_kinds(cfg)[key[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_port_sites_are_the_jax_calls(reference, arch):
    """The ``sparse_linear`` calls the JAX package made while it computed
    the reference logits are ``JAX_CALLS``' sites, each under its module
    name, and the port's: each projection the port keys, as a place in the
    JAX tree with the module name the port's call passes, is one of them,
    and each of them is one of the port's.  So ``should_quantize`` sees the
    reference's own names on both sides."""
    ref = reference[arch]
    cfg = ref["cfg"]
    model = from_jax_params(cfg, ref["float_np"], device="cpu")
    port = [(*_site(cfg, key), module) for key, _, _, module, _ in projection_sites(model)]
    sites = _jax_sites(cfg)
    assert len(set(port)) == len(port) and len(set(sites)) == len(sites)
    assert set(sites) == set(ref["calls"])
    assert set(port) == set(ref["calls"])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_family_quantized_dicts(reference, arch, variant):
    """Every rewritten projection of the JAX tree becomes a ``QuantLinear``
    holding its int8 codes and float32 scales bit for bit, K-major, with its
    per-token flag, bias and Amber scale; the others stay float."""
    ref = reference[arch]
    cfg, tree = ref["cfg"], ref[variant]["tree"]
    tp = from_jax_params(cfg, tree, device="cpu")
    counts = {}
    for key, owner, name, module, _ in projection_sites(tp):
        lin = getattr(owner, name)
        path, idx = _jax_path(cfg, key)
        p = _get(tree, path)
        at = (lambda a: a) if idx is None else (lambda a: a[idx])
        if "wq" not in p:
            assert isinstance(lin, Linear) and module == "down_proj", key
            continue
        counts[_kind(cfg, key)] = counts.get(_kind(cfg, key), 0) + 1
        assert isinstance(lin, QuantLinear) and lin.wq.dtype == torch.int8, key
        assert lin.wq.stride() == (1, lin.wq.shape[0])
        for k in KEYS:
            np.testing.assert_array_equal(getattr(lin, k).numpy(), at(p[k]), err_msg=str(key))
        assert lin.per_token == (variant == "per_token")
        for k in ("b", "amber_scale"):
            if k in p:
                np.testing.assert_array_equal(getattr(lin, k).numpy(), at(p[k]))
            else:
                assert getattr(lin, k) is None, (key, k)
    layers = ({"enc": cfg.n_encoder_layers, "dec": cfg.n_layers} if cfg.is_encdec else
              {k: transformer.layer_kinds(cfg).count(k) for k in cfg.block_pattern})
    assert counts == {k: PER_LAYER[k] * n for k, n in layers.items()}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_linears_on_family_matches_make_quantized_linear(reference, arch, variant):
    """The port's own rewrite of the float model (it raised for these
    families before) against the JAX trees: the same projections rewritten,
    the same int8 codes bit for bit, the weight scales, smooth factors and
    activation scales within ``REWRITE``, the same flags, biases and Amber
    scales; the float ones untouched."""
    ref = reference[arch]
    cfg = ref["cfg"]
    want = from_jax_params(cfg, ref[variant]["tree"], device="cpu")
    got = from_jax_params(cfg, ref["float_np"], device="cpu")
    assert quantize_linears(got, _port_absmax(got), tq.QuantConfig(
        per_token_act=variant == "per_token")) is got
    for key, g, w in _pairs(got, want):
        assert type(g) is type(w), key
        if isinstance(w, Linear):
            assert torch.equal(g.w, w.w)
            continue
        assert not hasattr(g, "w") and g.per_token == w.per_token
        assert torch.equal(g.wq, w.wq), key
        for k in KEYS[1:]:
            np.testing.assert_allclose(getattr(g, k).numpy(), getattr(w, k).numpy(),
                                       err_msg=str((key, k)), **REWRITE)
        assert g.wq.stride() == w.wq.stride() == (1, g.wq.shape[0])
        for k in ("b", "amber_scale"):
            a, b = getattr(g, k), getattr(w, k)
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), (key, k)


def _close(got, want):
    np.testing.assert_allclose(got, want, **QTOL)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_family_logits_match_jax(reference, arch, use_kernels):
    """Static W8A8: ``prefill`` and three greedy decode steps within
    ``QTOL`` of the JAX modules' (so are ``forward``'s last-position logits,
    which ``prefill`` returns in both packages), greedy tokens identical."""
    ref = reference[arch]
    cfg = ref["cfg"]
    tm, tp = build_model(cfg, device="cpu"), from_jax_params(cfg, ref["static"]["tree"],
                                                             device="cpu")
    pol = tpolicy.paper_policy(8, 16, cfg.qgate_skip_layers).with_(use_kernels=use_kernels)
    batch = {"tokens": torch.from_numpy(TOKS),
             **{k: torch.from_numpy(v) for k, v in _stubs(cfg, 2, 4).items()}}
    _close(tm.forward(tp, batch, policy=pol, phase="prefill")[:, -1].numpy(),
           ref["steps"][0][1])
    tl, cache = tm.prefill(tp, batch, tm.init_cache(2, 24), policy=pol)
    _close(tl.numpy(), ref["steps"][0][1])
    for tok, want in ref["steps"][1:]:
        assert (tl.argmax(-1).numpy() == tok[:, 0]).all()
        tl, cache = tm.decode_step(tp, torch.from_numpy(tok), cache, policy=pol)
        _close(tl.numpy(), want)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch,variant", ENGINE_CASES)
def test_quantized_family_engine_matches_jax_engine(reference, arch, variant, use_kernels):
    """A request (Whisper's with its frame embeddings) through the port's
    ``Engine`` (the recurrent families on the slab in exact dyadic chunks)
    and the JAX engine: the same greedy tokens."""
    ref = reference[arch]
    cfg = ref["cfg"]
    pol = tpolicy.paper_policy(8, 16, cfg.qgate_skip_layers).with_(use_kernels=use_kernels)
    eng = Engine.from_config(build_model(cfg, device="cpu"), EngineConfig(
        serving=ContinuousConfig(**SERVE)), policy=pol, device="cpu")
    got = _serve(eng, from_jax_params(cfg, ref[variant]["tree"], device="cpu"), cfg)
    assert got == ref[variant]["served"] and len(got) == NEW


def test_skip_layers_by_block_index_and_the_encdec_refusal(reference):
    """A non-empty ``skip_layers`` (no reference here: the reference's calls
    pass no layer index) keeps every projection of the named blocks float in
    RWKV6 and RecurrentGemma, as in the dense family, and raises in the
    encoder-decoder, whose two stacks a layer index does not name."""
    qcfg = tq.QuantConfig(skip_layers=(1,))
    for arch in ("rwkv6_7b", "recurrentgemma_2b"):
        model = from_jax_params(reference[arch]["cfg"], reference[arch]["float_np"],
                                device="cpu")
        quantize_linears(model, _port_absmax(model), qcfg)
        for key, owner, name, module, layer in projection_sites(model):
            quantized = isinstance(getattr(owner, name), QuantLinear)
            assert quantized == (layer != 1 and module != "down_proj"), (arch, key)
    model = from_jax_params(reference["whisper_medium"]["cfg"],
                            reference["whisper_medium"]["float_np"], device="cpu")
    with pytest.raises(ValueError, match="skip_layers"):
        quantize_linears(model, _port_absmax(model), qcfg)
    assert all(isinstance(getattr(o, n), Linear) for _, o, n, _, _ in projection_sites(model))
