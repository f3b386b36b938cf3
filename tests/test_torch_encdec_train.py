"""Training of the encoder-decoder against ``jax.grad`` of the JAX package,
on the Whisper-medium smoke config in float32: the loss and every gradient
leaf (both stacks, the cross-attention and the biases included), one AdamW
step, the weight-decay rule on the vmap-stacked tree, compression with the
reference's stacked-leaf scales, and the tokens-only batch the reference's
trainer feeds.

Two policies: ``DENSE``, and ``paper_policy(8, 16)`` active in ``"train"``
with ``use_kernels=True``: q of the encoder, of the self- and of the
cross-attention, fc1 and fc2 through ``nm_prune_matmul``'s ``PruneMatmul``
(its plain forward on the CPU), biases included, in every layer (no layer
index: no skips).  The batch is seeded tokens and ``frame_embeds``, fed to
both packages as numpy.  The JAX tree is the port's seeded init in the
reference's layout (``test_torch_recurrent_train.jax_layout``: ``jax.eval_shape``
of the JAX init, each leaf filled through ``weights.named_from_jax``'s own
map); one jitted function steps
both policies side by side and hands out the first step's gradients
through the compressor hook.  Tolerances are stated where they are used:
float32 differences are summation order only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.distributed import ef_int8_compress, ef_int8_init
from repro_torch.models import build_model
from repro_torch.train import (OptConfig, adamw_init, loss_fn, make_train_step, make_trainable,
                               trainable_params)
from repro_torch.train.optimizer import decays, tail_layers
from repro_torch.weights import from_jax_params, named_from_jax, reference_leaves
from test_torch_recurrent_train import jax_layout

ARCH = "whisper_medium"
POLICIES = ("dense", "sparse")
SPARSE = ("train", "prefill")
_G = np.random.default_rng(60)
TOKS = _G.integers(0, 256, size=(2, 13)).astype(np.int32)
FRAMES = _G.standard_normal((2, 16, 64)).astype(np.float32)     # (B, encoder_seq, d)
STEP_LR = 1e-2
# the gradients' tolerance: rtol 1e-4, atol this x the leaf's largest |g|
G_ATOL = 4e-6


def _tpolicy(name):
    return (tpolicy.DENSE if name == "dense" else
            tpolicy.paper_policy(8, 16).with_(phases=SPARSE, use_kernels=True))


def _batch():
    return {"tokens": torch.from_numpy(TOKS), "frame_embeds": torch.from_numpy(FRAMES)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of tiny torch ops: one intra-op thread a worker while this
    module runs (the suite runs six workers); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke():
    """(JAX config, port config, JAX model, the params as numpy in the JAX
    layout, filled from the port's seeded init: ``jax_layout``)."""
    from repro.configs.base import get_smoke_config
    from repro.models import build_model as jbuild

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tget(ARCH), dtype="float32")
    assert (tcfg.encoder_seq, tcfg.d_model) == FRAMES.shape[1:]
    jm = jbuild(cfg)
    return cfg, tcfg, jm, jax_layout(jm, tcfg, build_model(tcfg, device="cpu").init(0))


@pytest.fixture(scope="module")
def jax_runs(smoke):
    """Per policy: JAX's first step at lr ``STEP_LR`` from the smoke weights
    on the batch: its loss and gradients (port names), its metrics, and the
    parameters and ``mu`` after it; and (``"compressed"``) a dense step's
    gradients compressed by the reference's ``ef_int8_compress`` from zero
    error feedback.  One jitted function steps every case."""
    import jax
    import jax.numpy as jnp

    from repro.core import policy as jpolicy
    from repro.distributed.compression import ef_int8_compress as j_compress
    from repro.distributed.compression import ef_int8_init as j_init
    from repro.train.optimizer import OptConfig as JOptConfig
    from repro.train.optimizer import adamw_init as j_adamw_init
    from repro.train.train_step import make_train_step as j_make_train_step

    cfg, tcfg, jm, pn = smoke
    jpols = {"dense": jpolicy.DENSE, "sparse": jpolicy.paper_policy(8, 16).with_(phases=SPARSE)}
    named = lambda t: named_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, t))
    seen = {case: [] for case in ("dense", "sparse", "compressed")}

    def stepper(case):
        def hand_out(g):
            if case == "compressed":
                g = j_compress(g, j_init(g))[0]
            jax.debug.callback(seen[case].append, g)
            return g

        return j_make_train_step(jm, JOptConfig(lr=STEP_LR, warmup_steps=1, total_steps=10),
                                 jpols.get(case, jpolicy.DENSE), compressor=hand_out)

    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    every = jax.jit(lambda p, b: {case: stepper(case)(p, j_adamw_init(p), b) for case in seen})
    res = every(jp, {"tokens": jnp.asarray(TOKS), "frame_embeds": jnp.asarray(FRAMES)})
    out = {}
    for case, (p, opt, m) in res.items():
        jax.block_until_ready(p)
        out[case] = dict(metrics={k: float(v) for k, v in m.items()},
                         grads=named(seen[case][0]), params=named(p), mu=named(opt["mu"]))
    return out


def _port(smoke):
    tcfg = smoke[1]
    return build_model(tcfg, device="cpu"), make_trainable(
        from_jax_params(tcfg, smoke[3], device="cpu"))


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_grads_match_jax(smoke, jax_runs, policy):
    """The loss within rel 1e-5 and every gradient leaf allclose: rtol
    1e-4, atol ``G_ATOL`` x the leaf's largest |g| (float32 summation
    order); both stacks' leaves, the cross-attention's and every bias among
    them."""
    tm, tp = _port(smoke)
    named = trainable_params(tp)
    loss = loss_fn(tm, tp, _batch(), _tpolicy(policy))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want = jax_runs[policy]
    assert loss.item() == pytest.approx(want["metrics"]["loss"], rel=1e-5)
    assert set(grads) == set(want["grads"])
    for part in ("enc_blocks.1.attn.q_proj.b", "dec_blocks.1.cross_attn.k_proj.w",
                 "dec_blocks.0.ff.down_proj.b", "enc_norm.w", "lm_head.w"):
        assert part in grads and bool(grads[part].any()), part
    for k, g in grads.items():
        w = want["grads"][k]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=G_ATOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_train_step_matches_jax(smoke, jax_runs, policy):
    """One ``make_train_step`` step at lr 1e-2 against JAX's jitted one:
    loss and ``grad_norm`` within rel 1e-5; the new parameters within rtol
    1e-5, atol 1e-6 wherever JAX's new ``mu`` exceeds 1e-3 of its leaf's
    largest, and within AdamW's own bound of 2 lr elsewhere; ``mu`` within
    the gradients' tolerance.  A stacked layer's 1-D leaves (LayerNorms,
    biases) are decayed, as on the reference's vmap-stacked tree."""
    tm, tp = _port(smoke)
    step = make_train_step(tm, OptConfig(lr=STEP_LR, warmup_steps=1, total_steps=10),
                           _tpolicy(policy))
    _, opt, m = step(tp, adamw_init(trainable_params(tp)), _batch())
    want = jax_runs[policy]
    assert m["loss"].item() == pytest.approx(want["metrics"]["loss"], rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(want["metrics"]["grad_norm"], rel=1e-5)
    for k, p in trainable_params(tp).items():
        mu = want["mu"][k]
        np.testing.assert_allclose(opt["mu"][k].numpy(), mu, rtol=1e-4,
                                   atol=G_ATOL * np.abs(mu).max(), err_msg=k)
        got, firm = p.detach().numpy(), np.abs(mu) > 1e-3 * np.abs(mu).max()
        np.testing.assert_allclose(got[firm], want["params"][k][firm], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        assert np.abs(got - want["params"][k]).max() <= 2 * STEP_LR + 1e-6, k


def test_weight_decay_on_the_stacked_tree(smoke):
    """``decays`` equals the reference's ``p.ndim >= 2`` on its tree leaf
    for leaf: every leaf of ``enc_blocks`` and ``dec_blocks`` (vmap-stacked
    there: a LayerNorm's ``w`` is ``(n_layers, d)``) is decayed, the
    embedding and the LM head are, ``enc_norm`` and ``dec_norm`` are not."""
    import jax

    _, tcfg, _, pn = smoke
    flags = named_from_jax(tcfg, jax.tree_util.tree_map(lambda p: np.asarray(p.ndim >= 2), pn))
    named = trainable_params(_port(smoke)[1])
    assert set(flags) == set(named) and tail_layers(tcfg) == ()
    for k, p in named.items():
        assert decays(k, p) == bool(flags[k]), k
    assert decays("enc_blocks.0.ln1.w", named["enc_blocks.0.ln1.w"])
    assert not decays("dec_norm.w", named["dec_norm.w"])


def test_compression_matches_the_reference_step(smoke, jax_runs):
    """The first step with ``ef_int8_compress`` over the reference's stacked
    leaves (``weights.reference_leaves``: both layers of ``enc_blocks`` share
    each scale) against the reference's ``make_train_step(compressor=...)``:
    loss and grad norm within rel 1e-5; per reference leaf the scale within
    rel 1e-5, the codes equal but for entries on a rounding boundary (at
    most 0.2%: float32 summation order before the rounding), never more than
    one step apart."""
    tm, tp = _port(smoke)
    named = trainable_params(tp)
    leaves = reference_leaves(smoke[1], named)
    assert leaves["enc_blocks.1.ln1.w"] == leaves["enc_blocks.0.ln1.w"] == "enc_blocks.ln1.w"
    ef, seen = ef_int8_init(named), []

    def compressor(grads):
        comp = ef_int8_compress(grads, ef, leaves)[0]
        seen.append(comp)
        return comp

    step = make_train_step(tm, OptConfig(lr=STEP_LR, warmup_steps=1, total_steps=10),
                           compressor=compressor)
    _, _, m = step(tp, adamw_init(named), _batch())
    want = jax_runs["compressed"]
    assert m["loss"].item() == pytest.approx(want["metrics"]["loss"], rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(want["metrics"]["grad_norm"], rel=1e-5)
    top = {}
    for k, w in want["grads"].items():
        top[leaves[k]] = max(top.get(leaves[k], 0.0), float(np.abs(w).max()))
    mine = {}
    for k, c in seen[0].items():
        mine[leaves[k]] = max(mine.get(leaves[k], 0.0), float(c.abs().max()))
    for k, c in seen[0].items():
        scale, ref = mine[leaves[k]] / 127, top[leaves[k]] / 127
        assert scale == pytest.approx(ref, rel=1e-5), k
        cg, cw = np.round(c.numpy() / scale), np.round(want["grads"][k] / ref)
        assert np.abs(cg - cw).max() <= 1 and (cg != cw).mean() <= 2e-3, k


def test_tokens_only_batch_raises_as_the_reference():
    """The reference's trainer feeds ``lm_batch``, tokens only, which its
    encoder-decoder cannot take; the port's forward raises ``KeyError``
    there too, saying what is missing, and the same step runs once the
    batch carries the frames."""
    tcfg = dataclasses.replace(tget(ARCH), dtype="float32")
    tm = build_model(tcfg, device="cpu")
    tp = make_trainable(tm.init(0))
    step = make_train_step(tm, OptConfig(lr=1e-3, warmup_steps=1))
    batch = lm_batch(DataConfig(tcfg.vocab_size, 12, 2), 0, device="cpu")
    opt = adamw_init(trainable_params(tp))
    with pytest.raises(KeyError, match="needs batch\\['frame_embeds'\\]"):
        step(tp, opt, batch)
    _, _, m = step(tp, opt, {**batch, "frame_embeds": torch.from_numpy(FRAMES)})
    assert np.isfinite(float(m["loss"]))
