"""The modality families of the port against the JAX package's.

Whisper-medium's (the encoder-decoder, served on the dense slab) and
Qwen2-VL-2B's (M-RoPE and patch embeddings, paged) smoke configs in
float32, the JAX weights carried over with ``from_jax_params``, frame and
patch embeddings and prompts from numpy seeds:

* ``sinusoidal_positions`` and ``apply_mrope`` (distinct t/h/w streams)
  against ``repro.models.common`` (``TOL``).
* The whole model under DENSE and ``paper_policy(8, 16)``, plain and with
  ``use_kernels`` (on the CPU the kernels' plain versions): ``forward``,
  ``prefill`` + ``decode_step`` and ``prefill_chunk`` with the extras on
  chunk 0 only, as ``tests/test_prefill_chunk.py`` sends them (``TOL``
  against the JAX modules, its 5e-5 against the one-shot prefill).
* ``from_jax_params`` round-trips the encoder-decoder's tree; the
  encoder-decoder prunes q, fc1 and fc2 in a layer the skip list names,
  as the reference does (its projections take no layer index).
* ``Engine.run(params, extras)``: greedy tokens, ``trace_counts`` (each
  prefill program traced with and without extras) and counters equal to
  the JAX engine's, fused and legacy, Qwen2-VL through preemptions on a
  small pool; crash and restore; the one-shot ``generate`` with extras;
  the prefix cache off for requests with extras and on for the others.
* ``flash_attention`` over keys of another length (non-causal ``S != T``):
  the plain version against ``flash_attention_pallas`` in interpret mode,
  and the wrapper's refusal of a causal or banded ``S != T``.
* The CLI with ``--device cpu --smoke`` for both archs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core.pruner import precompute_scales as jprecompute
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.serve.api import Engine as JEngine
from repro.serve.api import EngineConfig as JEngineConfig
from repro.serve.continuous import ContinuousConfig as JConfig
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServing
from repro_torch.configs import get_config
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import build_model, common, encdec
from repro_torch.models.model import stub_shapes
from repro_torch.serve import (ContinuousConfig, ContinuousServingEngine, Engine, EngineConfig,
                               ServeConfig, ServingEngine)
from repro_torch.serve.faults import EngineCrash, FaultInjector
from repro_torch.weights import from_jax_params

ARCHS = ("whisper_medium", "qwen2_vl_2b")
TOL = dict(rtol=1e-4, atol=1e-4)          # float32, another summation order
CHUNK_TOL = dict(rtol=0, atol=5e-5)       # tests/test_prefill_chunk.py's
STUB = {"whisper_medium": "frame_embeds", "qwen2_vl_2b": "pixel_embeds"}


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


def _policies(name, kernels=False):
    if name == "dense":
        return jpolicy.DENSE, tpolicy.DENSE.with_(use_kernels=kernels)
    return jpolicy.paper_policy(8, 16), tpolicy.paper_policy(8, 16).with_(use_kernels=kernels)


def _both(models, arch, jpol):
    """(JAX params with the policy's scales, the port's copy of them)."""
    jm, params, tm, tcfg = models[arch]
    jp = jprecompute(params, jpol)
    return jp, from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _stub(cfg, rng, b=1):
    """The arch's modality stub ``(b, rows, d_model)`` float32."""
    (rows, d), = stub_shapes(cfg).values()
    return rng.standard_normal((b, rows, d)).astype(np.float32)


def _np(x):
    return np.asarray(x, np.float32)


def test_configs_copy_the_jax_ones():
    for arch in ARCHS:
        assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(get_smoke_config(arch))
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget(arch))


# ----------------------------------------------------------------- positions

@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoidal_positions_match_jax(d):
    """Positions up to Whisper-medium's 1500 encoder rows.  XLA's and torch's
    float32 ``exp`` differ by one ulp on some frequencies, which moves an
    angle by position x ulp: within ``TOL`` over this range."""
    pos = np.random.default_rng(1).integers(0, 1500, size=(3, 17))
    want = jcommon.sinusoidal_positions(jnp.asarray(pos), d)
    got = common.sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (3, 17, d)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("hd,theta", [(12, 10000.0), (128, 1e6)])
def test_apply_mrope_matches_jax(hd, theta):
    """Distinct temporal, height and width streams, so every section's
    frequencies read their own one."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    p3 = rng.integers(0, 500, size=(3, 2, 5))
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(p3), theta)
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # equal streams: M-RoPE is the default RoPE
    same = np.broadcast_to(p3[:1], p3.shape).copy()
    np.testing.assert_allclose(
        common.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), theta).numpy(),
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]), theta).numpy(),
        **TOL)


# ---------------------------------------------------------------- the model

def _batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32),
             STUB[_arch(cfg)]: _stub(cfg, rng, b)}
    return batch, {k: jnp.asarray(v) for k, v in batch.items()}, \
        {k: torch.from_numpy(v) for k, v in batch.items()}


def _arch(cfg):
    return "whisper_medium" if cfg.is_encdec else "qwen2_vl_2b"


def _chunks(tokens, key, stub):
    """T = 23 in chunks of 8, the last padded: (tokens (1, 8), valid rows,
    the stub on chunk 0 only), as ``tests/test_prefill_chunk.py`` sends them."""
    for off in range(0, 23, 8):
        v = min(8, 23 - off)
        chunk = np.zeros((1, 8), np.int32)
        chunk[:, :v] = tokens[:, off:off + v]
        yield chunk, v, ({key: stub} if off == 0 else {})


_JAX = {}


def _jax_reference(models, arch, name):
    """The JAX package's results on ``arch``'s smoke model under the policy
    ``name``, computed once for the plain and the kernel test: its params
    (numpy, with the policy's scales), ``forward`` logits, ``prefill``
    logits and three greedy ``decode_step``s (the fed tokens and their
    logits), and the logits of each chunk of :func:`_chunks`."""
    if (arch, name) not in _JAX:
        jm, params, _, tcfg = models[arch]
        jpol = _policies(name)[0]
        jp = jprecompute(params, jpol)
        _, jb, _ = _batch(tcfg, 2, 11, 3)
        ref = {"params": jax.tree_util.tree_map(np.asarray, jp),
               "forward": _np(jm.forward(jp, jb, policy=jpol, phase="prefill"))}
        jl, jc = jm.prefill(jp, jb, jm.init_cache(2, 24), policy=jpol)
        steps = [(None, _np(jl))]
        for _ in range(3):
            tok = np.argmax(steps[-1][1], -1)[:, None].astype(np.int32)
            jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, policy=jpolicy.DENSE)
            steps.append((tok, _np(jl)))
        ref["steps"] = steps
        batch, _, _ = _batch(tcfg, 1, 23, 4)
        jc, chunks = jm.init_cache(1, 32), []
        for chunk, v, ex in _chunks(batch["tokens"], STUB[arch], batch[STUB[arch]]):
            jl, jc = jm.prefill_chunk(jp, {"tokens": jnp.asarray(chunk),
                                           "chunk_len": jnp.asarray(v, jnp.int32),
                                           **{k: jnp.asarray(a) for k, a in ex.items()}},
                                      jc, policy=jpol)
            chunks.append(_np(jl))
        ref["chunks"] = chunks
        _JAX[arch, name] = ref
    return _JAX[arch, name]


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", ["dense", "paper_8_16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(models, arch, name, kernels):
    tm, tcfg = models[arch][2:]
    tpol = _policies(name, kernels)[1]
    ref = _jax_reference(models, arch, name)
    tp = from_jax_params(tcfg, ref["params"], device="cpu")
    _, _, tb = _batch(tcfg, 2, 11, 3)
    np.testing.assert_allclose(tm.forward(tp, tb, policy=tpol, phase="prefill").numpy(),
                               ref["forward"], **TOL)
    tl, tc = tm.prefill(tp, tb, tm.init_cache(2, 24), policy=tpol)
    np.testing.assert_allclose(tl.numpy(), ref["steps"][0][1], **TOL)
    for tok, want in ref["steps"][1:]:
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, policy=tpolicy.DENSE)
        np.testing.assert_allclose(tl.numpy(), want, **TOL)
    assert int(tc["pos"]) == 14


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", ["dense", "paper_8_16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax_and_one_shot(models, arch, name, kernels):
    """T = 23 in chunks of 8 (the last one padded), the extras on chunk 0
    only: each chunk's logits against the JAX chunk's, the last against the
    one-shot prefill's, then a decode step from either cache."""
    tm, tcfg = models[arch][2:]
    tpol = _policies(name, kernels)[1]
    ref = _jax_reference(models, arch, name)
    tp = from_jax_params(tcfg, ref["params"], device="cpu")
    batch, _, tb = _batch(tcfg, 1, 23, 4)
    t1, one = tm.prefill(tp, tb, tm.init_cache(1, 32), policy=tpol)
    tc = tm.init_cache(1, 32)
    for (chunk, v, ex), want in zip(_chunks(batch["tokens"], STUB[arch], batch[STUB[arch]]),
                                    ref["chunks"]):
        tl, tc = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(chunk),
                                       "chunk_len": torch.tensor(v, dtype=torch.int32),
                                       **{k: torch.from_numpy(a) for k, a in ex.items()}},
                                  tc, policy=tpol)
        np.testing.assert_allclose(tl.numpy(), want, **TOL)
    assert int(tc["pos"]) == 23
    np.testing.assert_allclose(tl.numpy(), t1.numpy(), **CHUNK_TOL)
    tok = torch.argmax(t1, -1)[:, None].to(torch.int32)
    d1, _ = tm.decode_step(tp, tok, one, policy=tpolicy.DENSE)
    d2, _ = tm.decode_step(tp, tok, tc, policy=tpolicy.DENSE)
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), **CHUNK_TOL)


def test_from_jax_params_round_trips_the_encdec_tree(models):
    """Every leaf of the JAX tree (vmap-stacked blocks included) lands in the
    port's module, its Amber scales too — but the scales the JAX walk gives
    the embedding and the stacked LayerNorms (a 2-D ``w``, which the walk
    takes for a projection's), which nothing reads."""
    jpol = jpolicy.paper_policy(8, 16)
    jp, tp = _both(models, "whisper_medium", jpol)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n = 0
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[-1] == "amber_scale" and keys[-2] in ("embed", "ln1", "ln2", "ln_x"):
            continue
        stack = keys[0] in ("enc_blocks", "dec_blocks")
        for i in range(leaf.shape[0] if stack else 1):
            obj = tp
            for k in keys[:-1]:
                obj = getattr(obj, k)
                if k in ("enc_blocks", "dec_blocks"):
                    obj = obj[i]
            got = getattr(obj, keys[-1])
            want = np.asarray(leaf)[i] if stack else np.asarray(leaf)
            np.testing.assert_array_equal(got.numpy(), want)
            n += 1
    # per encoder layer 18 leaves (2 norms, q/k/v/o, fc1/fc2, q/fc1/fc2
    # scales), per decoder layer 28; the embedding, both final norms, the LM
    # head and its scale
    cfg = models["whisper_medium"][3]
    assert n == 18 * cfg.n_encoder_layers + 28 * cfg.n_layers + 7
    assert tp.dec_blocks[1].cross_attn.q_proj.amber_scale is not None


def test_precompute_scales_match_the_jax_walk_on_the_encdec(models):
    """The port's walk over the ``EncDec`` modules scales exactly the
    projections the JAX walk scales (``should_prune(module, None)``: q, fc1
    and fc2 of every encoder and decoder layer, self and cross q), with the
    same values.  The encoder-decoder's W8A8 rewrite (ported:
    ``tests/test_torch_quant_families.py``) asks for the calibration absmax
    by stack, layer and place, and refuses a ``skip_layers``."""
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.core.quant import QuantConfig
    from repro_torch.layers.linear import Linear
    from repro_torch.weights import quantize_linears

    _, params, _, tcfg = models["whisper_medium"]
    jpol = jpolicy.paper_policy(8, 16)
    jp = jprecompute(params, jpol)
    tp = precompute_scales(from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params),
                                           device="cpu"), tpolicy.paper_policy(8, 16))
    scaled = {name for name, mod in tp.named_modules()
              if isinstance(mod, Linear) and mod.amber_scale is not None}
    assert len(scaled) == 3 * tcfg.n_encoder_layers + 4 * tcfg.n_layers
    for name in scaled:
        parts = name.split(".")
        leaf = jp[parts[0]]
        for k in parts[2:]:
            leaf = leaf[k]
        got = tp.get_submodule(name).amber_scale.numpy()
        np.testing.assert_allclose(got, np.asarray(leaf["amber_scale"])[int(parts[1])], **TOL)
    with pytest.raises(KeyError, match="attn.q_proj"):
        quantize_linears(tp, {}, QuantConfig())
    with pytest.raises(ValueError, match="skip_layers"):
        quantize_linears(tp, {}, QuantConfig(skip_layers=(0,)))


def test_encdec_prunes_q_and_the_mlp_in_every_layer(models, monkeypatch):
    """The reference's encoder-decoder passes no layer index to its
    projections, so a skip list naming every layer does not stop q (encoder,
    decoder self and cross), fc1 or fc2 from being pruned: the logits equal
    those without a skip list (and the JAX ones), not the dense ones, and a
    first chunk prunes 3 projections per encoder layer and 4 per decoder
    layer."""
    jm, _, tm, tcfg = models["whisper_medium"]
    every = tuple(range(tcfg.n_layers))
    jp, tp = _both(models, "whisper_medium", jpolicy.paper_policy(8, 16))
    _, jb, tb = _batch(tcfg, 1, 8, 5)
    skip = tpolicy.paper_policy(8, 16, every)
    got = tm.forward(tp, tb, policy=skip, phase="prefill").numpy()
    np.testing.assert_array_equal(got, tm.forward(tp, tb, policy=tpolicy.paper_policy(
        8, 16), phase="prefill").numpy())
    np.testing.assert_allclose(got, _np(jm.forward(
        jp, jb, policy=jpolicy.paper_policy(8, 16, every), phase="prefill")), **TOL)
    assert not np.allclose(got, tm.forward(tp, tb, policy=tpolicy.DENSE, phase="prefill").numpy(),
                           atol=1e-3)

    calls = []
    real = encdec.sparse_linear

    def spy(x, p, module, policy, phase, layer_idx=None):
        calls.append((module, layer_idx, policy.active(phase)
                      and policy.should_prune(module, layer_idx)))
        return real(x, p, module, policy, phase, layer_idx)

    monkeypatch.setattr(encdec, "sparse_linear", spy)
    tm.prefill_chunk(tp, {"tokens": tb["tokens"], "frame_embeds": tb["frame_embeds"]},
                     tm.init_cache(1, 16), policy=skip)
    assert {layer for _, layer, _ in calls} == {None}
    pruned = sorted(m for m, _, p in calls if p)
    assert pruned.count("q_proj") == tcfg.n_encoder_layers + 2 * tcfg.n_layers
    assert pruned.count("gate_proj") == pruned.count("down_proj") == (
        tcfg.n_encoder_layers + tcfg.n_layers)
    assert len(pruned) == 3 * tcfg.n_encoder_layers + 4 * tcfg.n_layers


# ---------------------------------------------------------------- serving

PROMPTS = [np.random.default_rng(7).integers(0, 256, size=n).astype(np.int32)
           for n in (5, 37, 12, 22, 30)]
ARRIVALS, NEW = [0, 0, 2, 5, 6], [6, 9, 5, 7, 8]
# Qwen2-VL's pool of 12 blocks of 4 rows (48 rows for 2 slots of up to 48)
# runs dry: preemptions, and replays that send the extras again
SERVE = {"whisper_medium": dict(max_seq=48, num_slots=2, chunk_size=8),
         "qwen2_vl_2b": dict(max_seq=48, num_slots=2, chunk_size=8, block_size=4,
                             num_blocks=12)}


def _extras(cfg, with_extras=(0, 1, 2, 3, 4)):
    return {rid: {STUB[_arch(cfg)]: _stub(cfg, np.random.default_rng(100 + rid))}
            for rid in with_extras}


def _submit(eng):
    for p, a, n in zip(PROMPTS, ARRIVALS, NEW):
        eng.submit(p, max_new_tokens=n, arrival=a)
    return eng


@pytest.fixture(scope="module")
def served(models):
    """The JAX ``Engine.run(params, extras)`` per (arch, fused) under
    ``paper_policy(8, 16)`` (request 3 without extras), with its params."""
    out = {}
    for arch in ARCHS:
        jm, params, _, tcfg = models[arch]
        jpol = jpolicy.paper_policy(8, 16)
        jp = jprecompute(params, jpol)
        for fused in (True, False):
            eng = _submit(JEngine.from_config(jm, JEngineConfig(
                serving=JConfig(**SERVE[arch], fused_step=fused)), policy=jpol))
            res = eng.run(jp, extras=_extras(tcfg, (0, 1, 2, 4)))
            out[arch, fused] = (jax.tree_util.tree_map(np.asarray, jp), res)
    return out


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_run_with_extras_matches_jax(models, served, arch, fused, kernels):
    """The same stream on both engines: outputs, ``trace_counts`` (every
    prefill program twice: with and without extras), iterations,
    dispatches, done iterations and preemptions equal; Whisper on the slab,
    Qwen2-VL on a pool small enough to preempt."""
    tm, tcfg = models[arch][2:]
    params_np, jres = served[arch, fused]
    eng = _submit(Engine.from_config(tm, EngineConfig(serving=ContinuousConfig(
        **SERVE[arch], fused_step=fused)), policy=tpolicy.paper_policy(8, 16).with_(
            use_kernels=kernels), device="cpu"))
    res = eng.run(from_jax_params(tcfg, params_np, device="cpu"),
                  extras=_extras(tcfg, (0, 1, 2, 4)))
    assert res["outputs"] == jres["outputs"]
    tc = res["metrics"]["trace_counts"]
    assert tc == dict(jres["metrics"]["trace_counts"])
    assert tc[("step_prefill" if fused else "prefill")] == 2
    for key in ("iterations", "dispatches", "generated_tokens"):
        assert res["metrics"][key] == jres["metrics"][key], key
    assert [r["done_iter"] for r in res["metrics"]["requests"]] == \
        [r["done_iter"] for r in jres["metrics"]["requests"]]
    if arch == "whisper_medium":
        assert res["metrics"]["paged"] == jres["metrics"]["paged"] == {"enabled": False}
    else:
        assert res["metrics"]["paged"]["preemptions"] == \
            jres["metrics"]["paged"]["preemptions"] > 0


@pytest.mark.parametrize("arch", ARCHS + ("qwen2_7b",))
def test_stub_shapes_name_each_models_stub(arch):
    """One (key, rows) per modality family, none for a text-only model."""
    cfg = tget(arch)
    want = {"whisper_medium": {"frame_embeds": (cfg.encoder_seq, cfg.d_model)},
            "qwen2_vl_2b": {"pixel_embeds": (cfg.n_patches, cfg.d_model)}}.get(arch, {})
    assert build_model(cfg, device="cpu").stub_shapes() == stub_shapes(cfg) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_run_takes_extras_as_tensors(models, served, arch):
    """The same stream with every stub a torch tensor instead of a numpy
    array: the JAX engine's outputs and ``trace_counts``."""
    tm, tcfg = models[arch][2:]
    params_np, jres = served[arch, True]
    eng = _submit(Engine.from_config(tm, EngineConfig(serving=ContinuousConfig(**SERVE[arch])),
                                     policy=tpolicy.paper_policy(8, 16), device="cpu"))
    extras = {rid: {k: torch.from_numpy(v) for k, v in ex.items()}
              for rid, ex in _extras(tcfg, (0, 1, 2, 4)).items()}
    res = eng.run(from_jax_params(tcfg, params_np, device="cpu"), extras=extras)
    assert res["outputs"] == jres["outputs"]
    assert res["metrics"]["trace_counts"] == dict(jres["metrics"]["trace_counts"])


def test_chunk_size_must_cover_the_patches(models):
    tm = models["qwen2_vl_2b"][2]
    with pytest.raises(ValueError, match="patch"):
        Engine.from_config(tm, EngineConfig(serving=ContinuousConfig(chunk_size=2)),
                           device="cpu")


CRASHES = [dict(site="decode", kind="crash", iters=tuple(range(4, 9)), limit=1),
           dict(site="prefill", kind="crash", iters=tuple(range(11, 15)), limit=1)]


def _restored(make, params, extras, crash):
    """Run with ``extras``; after every ``crash`` restore the last snapshot
    into a new engine and run again.  Returns (result, crashes, the last
    snapshot restored)."""
    eng = _submit(make())
    crashes, snap = 0, None
    for _ in range(5):
        try:
            return eng.run(params, extras=extras), crashes, snap
        except crash:
            crashes += 1
        snap = eng.last_snapshot
        del eng
        eng = make()
        eng.restore(snap)
    raise AssertionError("engine never finished after restores")


@pytest.mark.parametrize("arch", ARCHS)
def test_crash_restore_with_extras_matches_jax(models, served, arch):
    """A decode crash and a prefill crash, each restored from the last
    snapshot into a new engine: the requests replay from their first chunk
    with their extras, and the tokens equal the undisturbed JAX run's."""
    tm, tcfg = models[arch][2:]
    params_np, base = served[arch, True]
    inj = FaultInjector(seed=0, schedule=CRASHES)
    res, crashes, snap = _restored(
        lambda: ContinuousServingEngine(tm, tpolicy.paper_policy(8, 16), ContinuousConfig(
            **SERVE[arch], snapshot_every=1), faults=inj),
        from_jax_params(tcfg, params_np, device="cpu"), _extras(tcfg, (0, 1, 2, 4)),
        EngineCrash)
    assert crashes == 2 and res["metrics"]["lifecycle"]["restores"] == 2
    assert snap["extra_rids"] == {0, 1, 2, 4}
    assert res["outputs"] == base["outputs"]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_shot_generate_with_extras_matches_jax(models, arch):
    jm, _, tm, tcfg = models[arch]
    jpol, tpol = _policies("paper_8_16", True)
    jp, tp = _both(models, arch, jpol)
    _, jb, tb = _batch(tcfg, 2, 9, 8)
    want = JServing(jm, jpol, JServeConfig(max_seq=24), _via_api=True).generate(
        jp, jb, max_new_tokens=6)["tokens"]
    eng = ServingEngine(tm, tpol, ServeConfig(max_seq=24))
    got = eng.generate(tp, tb, max_new_tokens=6)["tokens"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same shape again reuses its program; a VLM batch without the stub
    # is another one
    eng.generate(tp, tb, max_new_tokens=2)
    assert eng.trace_counts["prefill_2x9"] == 1
    if not tcfg.is_encdec:
        eng.generate(tp, {"tokens": tb["tokens"]}, max_new_tokens=2)
        assert eng.trace_counts["prefill_2x9"] == 2


def test_prefix_cache_is_off_for_requests_with_extras(models):
    """Four Qwen2-VL requests behind one 16-token prefix: the two with patch
    embeddings neither match nor register blocks, the two text-only ones
    share theirs — as in the JAX engine."""
    jm, params, tm, tcfg = models["qwen2_vl_2b"]
    jp = jprecompute(params, jpolicy.paper_policy(8, 16))
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 256, size=16).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 256, size=6).astype(np.int32)])
               for _ in range(4)]
    extras = _extras(tcfg, (0, 2))
    serve = dict(max_seq=40, num_slots=2, chunk_size=8, block_size=4)

    def run(eng, params):
        for i, p in enumerate(prompts):
            eng.submit(p, max_new_tokens=3, arrival=2 * i)
        return eng.run(params, extras=extras)

    jres = run(JEngine.from_config(jm, JEngineConfig(serving=JConfig(**serve)),
                                   policy=jpolicy.paper_policy(8, 16)), jp)
    eng = Engine.from_config(tm, EngineConfig(serving=ContinuousConfig(**serve)),
                             policy=tpolicy.paper_policy(8, 16), device="cpu")
    res = run(eng, from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu"))
    assert res["outputs"] == jres["outputs"]
    cached = {r["rid"]: r["cached_tokens"] for r in res["metrics"]["requests"]}
    assert cached == {r["rid"]: r["cached_tokens"] for r in jres["metrics"]["requests"]}
    assert cached[0] == cached[2] == 0 and cached[3] > 0
    assert res["metrics"]["paged"]["prefix_hits"] == \
        jres["metrics"]["paged"]["prefix_hits"] >= 1
    assert eng.replica.sched._extra_rids == {0, 2}
    eng.clear()
    assert eng.replica.sched._extra_rids == set()


# ------------------------------------------------------- flash, S != T

@pytest.mark.parametrize("b,hq,hkv,t,s,d", [(2, 2, 2, 64, 128, 32), (1, 6, 2, 32, 96, 16)],
                         ids=["jax_test_case", "gqa"])
def test_flash_plain_takes_keys_longer_than_queries(b, hq, hkv, t, s, d):
    """``tests/test_kernels.py``'s non-causal ``(2, 2, 64, 128, 32)`` case and
    a GQA one: the plain version (the wrapper on CPU tensors) against
    ``flash_attention_pallas`` in interpret mode."""
    from repro.kernels.flash_attention import flash_attention_pallas

    rng = np.random.default_rng(10)
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=False, block_q=32, block_k=32, interpret=True)

    def port(a):
        return torch.from_numpy(a.transpose(0, 2, 1, 3).copy())

    got = kfa.flash_attention(port(q), port(k), port(v), causal=False)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3), _np(want), **TOL)


def test_flash_raises_on_causal_or_banded_keys_of_another_length():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 12, 2, 16)
    for causal, window in ((True, 0), (False, 4), (True, 4)):
        with pytest.raises(ValueError, match="S != T"):
            kfa.flash_attention(q, k, k, causal=causal, window=window)


# ---------------------------------------------------------------------- CLI

@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_modality_families_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    rc, m = serve.run(["--device", "cpu", "--smoke", "--arch", arch, "--trace",
                       "--num-requests", "4", "--len-range", "6:20", "--slots", "2",
                       "--chunk", "8"])
    assert rc == 0
    assert m.lifecycle.terminal_states["done"] == 4
    assert m.trace_counts == {"step_prefill": 1, "step_prefill_decode": 2, "step_decode": 1}
    assert m.paged.enabled == (arch == "qwen2_vl_2b")
    rc, _ = serve.run(["--device", "cpu", "--smoke", "--arch", arch, "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "3"])
    assert rc == 0
    assert "greedy-decode agreement" in capsys.readouterr().out
