"""The port's training slice against the JAX package's on the LLaMA-3.1
smoke config in float32: the cosine schedule, AdamW, the error-feedback
int8 compression, the loss and its gradients (dense and ``--sparse-train``,
the plain path and ``nm_prune_matmul``'s ``torch.autograd.Function``), one
train step, five steps, gradient accumulation, remat, the default phase,
and the families that do not train yet.

The JAX parameters reach the port through ``weights.from_jax_params``;
gradients and optimizer state go through ``weights.named_from_jax``, which
does not cast.  Token arrays are numpy, fed to both packages.  JAX runs
jitted once per configuration in module-scoped fixtures.  Tolerances are
stated where they are used: float32 differences are summation order only.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import nm as jnm
from repro.core import policy as jpolicy
from repro.distributed.compression import ef_int8_compress as j_ef_compress
from repro.distributed.compression import ef_int8_init as j_ef_init
from repro.models import build_model as jbuild
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import cosine_lr as j_cosine_lr
from repro.train.optimizer import global_norm as j_global_norm
from repro.train.train_step import loss_fn as j_loss_fn
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import nm, pruner, scoring
from repro_torch.core import policy as tpolicy
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.distributed import ef_int8_compress, ef_int8_init
from repro_torch.kernels import _build
from repro_torch.kernels import nm_prune_matmul as knm
from repro_torch.models import build_model
from repro_torch.train import (OptConfig, adamw_init, adamw_update, cosine_lr, loss_fn,
                               make_train_step, make_trainable, trainable_params)
from repro_torch.train.optimizer import decays
from repro_torch.weights import from_jax_params, named_from_jax, projection_sites, \
    quantize_linears

SPARSE = ("train", "prefill")
POLICIES = {
    "dense": (jpolicy.DENSE, tpolicy.DENSE),
    "sparse": (jpolicy.paper_policy(8, 16, (3,)).with_(phases=SPARSE),
               tpolicy.paper_policy(8, 16, (3,)).with_(phases=SPARSE)),
}
# five steps' batches (B, S + 1), fed to both packages; the first is also
# the gradient tests' batch
STEP_TOKS = [np.random.default_rng(10 + i).integers(0, 256, size=(4, 33)).astype(np.int32)
             for i in range(5)]
TOKS = STEP_TOKS[0]
# steps at a learning rate that moves every entry by ~1e-2; five
# free-running steps at 1e-3 (test_five_steps_losses_match_jax says why)
STEP_LR, FREE_LR = 1e-2, 1e-3
opt_cfg = lambda lr: OptConfig(lr=lr, warmup_steps=1, total_steps=10)


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
    """(JAX config, port config, JAX model, JAX params, the params as numpy).
    The JAX tree is the port's seeded init in the reference's layout
    (``jax.eval_shape`` of the JAX init filled from the port's modules:
    JAX's own init takes ~9 s of one core, eager or jitted)."""
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    jm = jbuild(cfg)
    port = build_model(tcfg, device="cpu").init(0)
    get = lambda mod, name: functools.reduce(getattr, name.split("."), mod).detach().numpy()

    def fill(path, sds):
        keys = [str(k.key) for k in path]
        if keys[0] == "periods":
            a = np.stack([get(blk, ".".join(keys[2:])) for blk in port.blocks])
        else:
            a = get(port, ".".join(keys))
        assert a.shape == sds.shape and a.dtype == sds.dtype, keys
        return a

    pn = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    return cfg, tcfg, jm, jax.tree_util.tree_map(jnp.asarray, pn), pn


def _port(smoke, remat=True):
    """(model, trainable params) holding the JAX weights."""
    tcfg = dataclasses.replace(smoke[1], remat=remat)
    return build_model(tcfg, device="cpu"), make_trainable(
        from_jax_params(tcfg, smoke[4], device="cpu"))


def _grads(tm, tp, toks, policy):
    named = trainable_params(tp)
    loss = loss_fn(tm, tp, {"tokens": torch.from_numpy(toks)}, policy)
    return loss.item(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


@pytest.fixture(scope="module")
def jax_runs(smoke):
    """JAX's train steps run from the smoke weights on ``STEP_TOKS``, per
    policy: the first step's loss and gradients (port names; a
    ``jax.debug.callback`` in the compressor hook hands them out), and at
    lr ``STEP_LR`` the state before each step (params, ``mu``, ``nu`` by
    port name, ``step``), that step's metrics, and the parameters and
    ``mu`` after it; at ``FREE_LR`` the five losses.  One jitted function
    steps both policies side by side and takes the learning rate as an
    argument: one compile, ~16 s of one core where two take ~26 s."""
    cfg, tcfg, jm, jp, _ = smoke
    named = lambda t: named_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, t))
    seen = {name: [] for name in POLICIES}

    def stepper(name, lr):
        def hand_out(g):
            jax.debug.callback(seen[name].append, g)
            return g

        return j_make_train_step(jm, JOptConfig(lr=lr, warmup_steps=1, total_steps=10),
                                 POLICIES[name][0], compressor=hand_out)

    both = jax.jit(lambda states, b, lr: {name: stepper(name, lr)(*states[name], b)
                                          for name in POLICIES})
    out = {name: {"states": [], "free": []} for name in POLICIES}
    for lr in (STEP_LR, FREE_LR):
        run = {name: (jp, j_adamw_init(jp)) for name in POLICIES}
        for toks in STEP_TOKS:
            res = both(run, {"tokens": jnp.asarray(toks)}, lr)
            for name, (p, opt, m) in res.items():
                if lr == FREE_LR:
                    out[name]["free"].append(float(m["loss"]))
                    continue
                p0, opt0 = run[name]
                before = (jax.tree_util.tree_map(np.asarray, p0), named(opt0["mu"]),
                          named(opt0["nu"]), int(opt0["step"]))
                out[name]["states"].append((before, {k: float(v) for k, v in m.items()},
                                            named(p), named(opt["mu"])))
            run = {name: res[name][:2] for name in POLICIES}
    for name in POLICIES:
        out[name]["first"] = (out[name]["states"][0][1]["loss"], named(seen[name][0]))
    return out


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("cfg", [dict(lr=1.0, warmup_steps=10, total_steps=100),
                                 dict(lr=3e-4, warmup_steps=7, total_steps=60,
                                      min_lr_frac=0.05)], ids=["unit", "default-like"])
def test_cosine_lr_matches_jax(cfg):
    """Steps 0-100 against JAX's: the warm-up bit for bit, the decay within
    one float32 ulp of the result plus what one ulp of the cosine becomes.
    Neither torch's nor XLA's float32 ``cos`` is correctly rounded (they
    part on 5 of these 101 arguments), and near the end of the decay
    ``1 + cos`` cancels, so one ulp of the cosine (at most 2**-24 there) is
    ``lr * (1 - min_lr_frac) / 2 * 2**-24`` of the result: 3 ulps of it at
    step 98 of the ``unit`` case."""
    c = OptConfig(**cfg)
    want = np.asarray(j_cosine_lr(JOptConfig(**cfg), jnp.arange(101, dtype=jnp.int32)))
    got = cosine_lr(c, torch.arange(101, dtype=torch.int32)).numpy()
    assert got.dtype == np.float32
    warm = c.warmup_steps
    np.testing.assert_array_equal(got[:warm], want[:warm])
    bound = np.spacing(np.abs(want)) + c.lr * (1 - c.min_lr_frac) / 2 * 2.0**-24
    assert np.all(np.abs(got - want) <= bound)
    assert got[0] == 0.0 and float(cosine_lr(OptConfig(**cfg), 0)) == 0.0


def _bf16_ulps(got, want):
    """|got - want| in units of bf16 ulps at ``want``."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return np.abs(got.astype(np.float64) - want) / ulp


# a parameter tree of the reference's layout at a small size: 1-D and 2-D
# top-level leaves and stacked per-layer leaves (1-D norm weights and biases,
# weights, over 2 layers; three shapes, since eager JAX compiles each
# primitive once a shape)
ADAM_SHAPES = {"embed": {"w": (2, 16)}, "final_norm": {"w": (16,)},
               "lm_head": {"w": (2, 16)},
               "periods": {"b0": {"ln1": {"w": (2, 16)}, "ln2": {"w": (2, 16)},
                                  "q_proj": {"w": (2, 16, 16), "b": (2, 16)}}}}


@pytest.mark.parametrize("clip", ["clipped", "unclipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(smoke, dtype, clip):
    """One AdamW update at step 3 on identical numpy inputs against the
    eager JAX function, on ``ADAM_SHAPES`` (stacked per-layer leaves in
    JAX, one tensor a layer in the port).  ``clipped``: the gradients'
    norm is ~60, so the clip scale fires.  ``mu``, ``nu`` and float32
    parameters within rtol 1e-6, or two float32 ulps of the larger term of
    their last sum where it cancels (``b1 * mu + (1 - b1) * g``; ``p -
    lr * delta``): the clip scale comes from a sum taken in another order,
    so ``g * scale`` may part by an ulp.  bf16 parameters within one bf16
    ulp.  Eager, because under jit XLA contracts the moments' products and
    sums into FMAs (about one entry in nine of a leaf then parts from the
    eager result by an ulp)."""
    tcfg = dataclasses.replace(smoke[1], n_layers=2)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(5)
    gscale = 1.0 if clip == "clipped" else 1e-4
    leaves = lambda f: jax.tree_util.tree_map(lambda s: f(s).astype(np.float32), ADAM_SHAPES,
                                              is_leaf=lambda v: isinstance(v, tuple))
    p_np = leaves(lambda s: rng.standard_normal(s) * 0.05)
    g_np = leaves(lambda s: rng.standard_normal(s) * gscale)
    mu_np = leaves(lambda s: rng.standard_normal(s) * 1e-2 * gscale)
    nu_np = leaves(lambda s: np.abs(rng.standard_normal(s)) * 1e-2 * gscale ** 2)
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jcast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), t)
    jopt_in = {"mu": jax.tree_util.tree_map(jnp.asarray, mu_np),
               "nu": jax.tree_util.tree_map(jnp.asarray, nu_np), "step": jnp.int32(3)}
    jnew, jopt = j_adamw_update(JOptConfig(**cfg), jcast(g_np), jopt_in, jcast(p_np))
    assert (float(j_global_norm(jcast(g_np))) > 1.0) == (clip == "clipped")

    named = lambda t: named_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, t))
    tt = lambda t, d: {k: torch.from_numpy(np.asarray(v, np.float32)).to(d)
                       for k, v in named(t).items()}
    params = tt(p_np, tdt)
    p0, g = {k: v.float().numpy() for k, v in params.items()}, named(g_np)
    new, opt = adamw_update(OptConfig(**cfg), tt(g_np, tdt),
                            {"mu": tt(mu_np, torch.float32), "nu": tt(nu_np, torch.float32),
                             "step": torch.tensor(3, dtype=torch.int32)}, params)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 4

    def close(got, want, term, what):
        bound = np.maximum(1e-6 * np.abs(want), 2 * np.spacing(term.astype(np.float32)))
        assert np.all(np.abs(got - want) <= bound), what

    for key, b, old in (("mu", 0.9, named(mu_np)), ("nu", 0.95, named(nu_np))):
        want = named(jopt[key])
        for k, v in opt[key].items():
            assert v.dtype == torch.float32
            gg = np.abs(g[k]) if key == "mu" else g[k] ** 2
            close(v.numpy(), want[k], np.maximum(b * np.abs(old[k]), (1 - b) * gg), (key, k))
    want = named(jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), jnew))
    for k, v in new.items():
        assert v.dtype == tdt
        got = v.float().numpy()
        if dtype == "bfloat16":
            assert _bf16_ulps(got, want[k]).max() <= 1.0, k
        else:
            close(got, want[k], np.maximum(np.abs(p0[k]), np.abs(want[k] - p0[k])), k)


def test_weight_decay_follows_the_stacked_layout(smoke):
    """The port decays exactly the leaves the reference decays
    (``p.ndim >= 2`` on its stacked tree): every per-layer leaf, 1-D norm
    weights included, the embedding and the LM head; not ``final_norm``."""
    tcfg, jp = smoke[1], smoke[3]
    flags = named_from_jax(tcfg, jax.tree_util.tree_map(lambda p: np.asarray(p.ndim >= 2), jp))
    want = {k for k, v in flags.items() if bool(v)}
    tp = from_jax_params(tcfg, smoke[4], device="cpu")
    got = {k for k, p in tp.named_parameters() if decays(k, p)}
    assert got == want
    assert "blocks.0.ln1.w" in got and tp.blocks[0].ln1.w.dim() == 1
    assert set(flags) - got == {"final_norm.w"}


def test_ef_int8_compress_matches_eager_jax():
    """Twenty steps of error feedback, bit-identical to the eager JAX
    function (under jit XLA rewrites ``/ 127`` as a multiply); plus the
    reference's unbiasedness bound: the accumulated compressed gradient is
    within 1% of the accumulated true one."""
    rng = np.random.default_rng(7)
    g = {"w": (rng.standard_normal((32, 32)) * 0.01).astype(np.float32),
         "b": (rng.standard_normal((17,)) * 3).astype(np.float32)}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jef, tef = j_ef_init(jg), ef_int8_init(tg)
    total = torch.zeros(32, 32)
    for _ in range(20):
        jcomp, jef = j_ef_compress(jg, jef)
        comp, tef = ef_int8_compress(tg, tef)
        for k in g:
            np.testing.assert_array_equal(comp[k].numpy(), np.asarray(jcomp[k]))
            np.testing.assert_array_equal(tef[k].numpy(), np.asarray(jef[k]))
        total += comp["w"]
    true = tg["w"] * 20
    assert float(torch.linalg.norm(total - true) / torch.linalg.norm(true)) < 0.01


# ------------------------------------------------------------- gradients

@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_loss_and_grads_match_jax(smoke, jax_runs, name, use_kernels):
    """The loss within rel 1e-5 and every gradient allclose: rtol 1e-4,
    atol 4e-6 x the leaf's largest |g|.  Each package's float32 gradient
    lies 0.8-2.5e-6 of that largest value from the float64 gradient (the
    port's model in float64, measured on this batch, both packages alike),
    so two of them part by up to twice that.  ``kernels`` runs the pruned
    projections through ``PruneMatmul`` (its plain forward on the CPU)."""
    tm, tp = _port(smoke)
    loss, grads = _grads(tm, tp, TOKS, POLICIES[name][1].with_(use_kernels=use_kernels))
    want_loss, want = jax_runs[name]["first"]
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=4e-6 * np.abs(want[k]).max(), err_msg=k)


def test_sparse_masks_match_jax(smoke, monkeypatch):
    """Every N:M selection of a ``--sparse-train`` forward: JAX's
    ``nm_topk_mask`` on the same projection inputs gives bit-identical
    masks, and so does ``PruneMatmul``'s (the CPU kernel path)."""
    tm, tp = _port(smoke)
    seen = []
    real = pruner.prune_input

    def spy(x, scale, policy):
        seen.append((x.detach().clone(), scale))
        return real(x, scale, policy)

    monkeypatch.setattr(pruner, "prune_input", spy)
    _grads(tm, tp, TOKS, POLICIES["sparse"][1])
    # q and gate in layers 0-2 (layer 3 skips them), down in all four; remat
    # runs each again in the backward
    assert len(seen) == 2 * 10
    for x, scale in seen:
        sc = scoring.score_activations(x, scale)
        mask = nm.nm_topk_mask(sc, 8, 16)
        np.testing.assert_array_equal(
            mask.numpy(), np.asarray(jnm.nm_topk_mask(jnp.asarray(sc.numpy()), 8, 16)))
        flat = x.reshape(-1, x.shape[-1])
        np.testing.assert_array_equal(knm._plain(flat, torch.zeros(x.shape[-1], 3), scale,
                                                 8, 16, None)[2].numpy(),
                                      mask.reshape(flat.shape).numpy())


def test_prune_matmul_function_keeps_zero_channels():
    """``PruneMatmul`` (the kernel path's autograd.Function) against the
    plain path's autograd on the same inputs, bit for bit, with a whole
    group of exact zeros and a lone zero: a kept channel whose value is 0
    passes its gradient (the reference's ``jnp.where(mask, x, 0)``); the
    channel scale gets none."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 32, generator=g)
    x[1, :16] = 0.0                                # a whole 16-group of zeros
    x[2, 3] = 0.0
    w, b = torch.randn(32, 8, generator=g), torch.randn(8, generator=g)
    scale = torch.rand(32, generator=g) + 0.5
    dy = torch.randn(6, 8, generator=g)
    outs = []
    for via_fn in (True, False):
        xa, wa, ba = (t.clone().requires_grad_() for t in (x, w, b))
        if via_fn:
            y = knm.nm_prune_matmul(xa, wa, scale, 2, 16, bias=ba)
            assert y.grad_fn is not None and "PruneMatmul" in type(y.grad_fn).__name__
        else:
            y = nm.apply_nm(xa, scoring.score_activations(xa, scale), 2, 16) @ wa + ba
        y.backward(dy)
        outs.append((y.detach(), xa.grad, wa.grad, ba.grad))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)
    dx = outs[0][1]
    assert (dx[1, :2] != 0).all() and (dx[1, 2:16] == 0).all()   # the first two of the zeros kept
    assert not scale.requires_grad


def test_remat_on_and_off_bitwise(smoke):
    """``cfg.remat`` (each block under ``torch.utils.checkpoint``) changes
    no bit of the loss or the gradients, on the kernel path of
    ``--sparse-train`` too."""
    pol = POLICIES["sparse"][1].with_(use_kernels=True)
    on = _grads(*_port(smoke, remat=True), TOKS, pol)
    off = _grads(*_port(smoke, remat=False), TOKS, pol)
    assert on[0] == off[0]
    for k in on[1]:
        assert torch.equal(on[1][k], off[1][k]), k


# ------------------------------------------------------------- train step

def _sign_partings(grads, want):
    return sum(int(np.sum(np.sign(g.numpy()) != np.sign(want[k]))) for k, g in grads.items())


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_train_step_matches_jax(smoke, jax_runs, name, capsys):
    """``make_train_step`` against JAX's, one step from each of the five
    states JAX's own run passes through at lr 1e-2 (the port is given
    JAX's parameters and moments before each step): loss and ``grad_norm``
    within rel 1e-5; at the first step no gradient entry of another sign;
    the new parameters within rtol 1e-5, atol 1e-6 wherever JAX's new
    ``mu`` exceeds 1e-3 of its leaf's largest, and within 2 lr elsewhere.
    There Adam's ``m / (sqrt(v) + eps)`` divides float32 noise by a
    near-zero moment (a gradient entry ~eps moves by a sizable fraction of
    lr on 4e-7 of noise), so only AdamW's own bound holds."""
    tcfg = smoke[1]
    tm = build_model(tcfg, device="cpu")
    seen = {}

    def record(grads):
        seen.update(grads)
        return grads

    step = make_train_step(tm, opt_cfg(STEP_LR), POLICIES[name][1], compressor=record)
    t32 = lambda d: {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in d.items()}
    loose = 0
    for i, ((p_np, mu, nu, n), want, after, mu_after) in enumerate(jax_runs[name]["states"]):
        tp = make_trainable(from_jax_params(tcfg, p_np, device="cpu"))
        opt = {"mu": t32(mu), "nu": t32(nu), "step": torch.tensor(n, dtype=torch.int32)}
        _, opt, m = step(tp, opt, {"tokens": torch.from_numpy(STEP_TOKS[i])})
        assert m["loss"].item() == pytest.approx(want["loss"], rel=1e-5), i
        assert m["grad_norm"].item() == pytest.approx(want["grad_norm"], rel=1e-5), i
        assert int(m["step"]) == i + 1 and m["step"].dtype == torch.int32
        if i == 0:
            partings = _sign_partings(seen, jax_runs[name]["first"][1])
            with capsys.disabled():
                print(f"\n[{name}] gradient entries whose sign parts from JAX's: {partings}")
            assert partings == 0
        for k, p in trainable_params(tp).items():
            got, firm = p.detach().numpy(), np.abs(mu_after[k]) > 1e-3 * np.abs(mu_after[k]).max()
            loose += int((~firm).sum())
            np.testing.assert_allclose(got[firm], after[k][firm], rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {k}")
            assert np.abs(got - after[k]).max() <= 2 * STEP_LR + 1e-6, (i, k)
    with capsys.disabled():
        print(f"[{name}] entries held to AdamW's 2 lr bound only: {loose} of "
              f"{5 * sum(v.size for v in jax_runs[name]["states"][0][2].values())}")


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_five_steps_losses_match_jax(smoke, jax_runs, name):
    """Five free-running steps on the same token arrays at lr 1e-3: every
    loss within rel 1e-4.  (At lr 3e-3 and above the ``--sparse-train``
    runs part from step 2-3 on: a float32 difference in the parameters
    flips a near tie of one N:M selection, a gradient entry changes by
    O(1), and Adam's first steps, which move every entry by ~lr whatever
    its size, spread it; the dense runs stay within 4e-6.  The test above
    holds each step at lr 1e-2 from the same state.)"""
    tm, tp = _port(smoke)
    step = make_train_step(tm, opt_cfg(FREE_LR), POLICIES[name][1])
    opt = adamw_init(trainable_params(tp))
    for toks, want in zip(STEP_TOKS, jax_runs[name]["free"]):
        _, opt, m = step(tp, opt, {"tokens": torch.from_numpy(toks)})
        assert float(m["loss"]) == pytest.approx(want, rel=1e-4)


def test_grad_accum_equivalence(smoke):
    """Two microbatches accumulated in float32 ≡ one batch: the loss within
    rel 1e-5 and every parameter within 1e-5 (the reference's bound)."""
    data = DataConfig(vocab_size=256, seq_len=16, global_batch=4)
    batch = lm_batch(data, 0, device="cpu")
    out = []
    for accum in (1, 2):
        tm, tp = _port(smoke)
        step = make_train_step(tm, OptConfig(), grad_accum=accum)
        _, _, m = step(tp, adamw_init(trainable_params(tp)), batch)
        out.append((float(m["loss"]), {k: p.detach() for k, p in trainable_params(tp).items()}))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    assert max(float((out[0][1][k] - out[1][1][k]).abs().max()) for k in out[0][1]) < 1e-5


def test_loss_decreases(smoke):
    """Forty steps at lr 3e-3 on the port's data stream: the mean of the
    last five losses is 0.3 below the first five's (the reference's
    ``test_loss_decreases`` bound).  Without remat, which changes no bit
    (``test_remat_on_and_off_bitwise``) and would run each forward twice."""
    tm = build_model(dataclasses.replace(smoke[1], remat=False), device="cpu")
    tp = make_trainable(tm.init(0))
    data = DataConfig(vocab_size=256, seq_len=32, global_batch=4)
    step = make_train_step(tm, OptConfig(lr=3e-3, total_steps=60))
    opt, losses = adamw_init(trainable_params(tp)), []
    for i in range(40):
        _, opt, m = step(tp, opt, lm_batch(data, i, device="cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


# ------------------------------------------------------ phase and families

def test_forward_default_phase_is_train(smoke):
    """``Model.forward(params, batch, policy=paper_policy(8, 16))`` with no
    phase is the reference's same call: the train phase, in which that
    policy is not active, so the pass is dense."""
    cfg, tcfg, jm, jp, pn = smoke
    want = np.asarray(jax.jit(lambda p, t: jm.forward(
        p, {"tokens": t}, policy=jpolicy.paper_policy(8, 16)))(jp, jnp.asarray(TOKS)))
    tm, tp = build_model(tcfg, device="cpu"), from_jax_params(tcfg, pn, device="cpu")
    batch = {"tokens": torch.from_numpy(TOKS)}
    got = tm.forward(tp, batch, policy=tpolicy.paper_policy(8, 16))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tm.forward(tp, batch, policy=tpolicy.DENSE))
    assert not torch.allclose(got, tm.forward(tp, batch, policy=tpolicy.paper_policy(8, 16),
                                              phase="prefill"), atol=1e-3)


def _batch(model, rng):
    b = {"tokens": torch.from_numpy(rng.integers(0, model.cfg.vocab_size, size=(1, 8)))}
    for key, (rows, d) in model.stub_shapes().items():
        b[key] = torch.from_numpy(rng.standard_normal((1, rows, d)).astype(np.float32))
    return b


def _w8a8(params):
    absmax = {key: torch.ones(getattr(owner, name).w.shape[0])
              for key, owner, name, _, _ in projection_sites(params)}
    return quantize_linears(params, absmax, QuantConfig())


@pytest.mark.parametrize("arch,what", [
    ("qwen3_30b_a3b-w8a8", "a W8A8 projection"), ("rwkv6_7b", "a recurrent layer"),
    ("recurrentgemma_2b", "a recurrent layer"), ("whisper_medium", "encoder-decoder"),
    ("llama31_8b-w8a8", "a W8A8 projection")])
def test_untrained_families_raise(arch, what):
    """A W8A8 model (an MoE's too) raises ``NotImplementedError`` in a
    forward that autograd would record, saying why (its int8 weights have
    no gradient, and the reference trains no quantized model); the same
    forward runs under ``no_grad`` and on parameters that need no grad.
    The recurrent models and the encoder-decoder, which raised here until
    they trained, take one train step on the same batch: a finite loss and
    a finite, nonzero gradient on every trainable leaf."""
    model = build_model(tget(arch.split("-")[0]), device="cpu")
    params = model.init(0)
    if arch.endswith("w8a8"):
        params = _w8a8(params)
    batch = _batch(model, np.random.default_rng(0))
    assert model.forward(params, batch).isfinite().all()
    make_trainable(params)
    with torch.no_grad():
        assert model.forward(params, batch).isfinite().all()
    if what == "a W8A8 projection":
        with pytest.raises(NotImplementedError, match=f"{what} does not train: its int8 "
                                                      "weights have no gradient"):
            model.forward(params, batch)
        return
    seen = {}

    def record(grads):
        seen.update(grads)
        return grads

    named = trainable_params(params)
    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1), compressor=record)
    tokens = torch.cat([batch["tokens"], batch["tokens"][:, :1]], 1)      # (1, 9): 8 targets
    _, _, m = step(params, adamw_init(named), {**batch, "tokens": tokens})
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert set(seen) == set(named)
    for k, g in seen.items():
        assert g.isfinite().all() and (g != 0).any(), k


DENSE_ARCHS = ["qwen2_7b", "qwen2_5_32b", "chatglm3_6b", "stablelm_3b", "granite_34b",
               "qwen2_vl_2b", "llama31_8b-swa"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_family_trains_one_step(arch):
    """One CPU train step of each other dense smoke config in float32 (and
    LLaMA's with a sliding window, on the plain banded path): a finite
    loss, a finite gradient on every trainable leaf, not all zero, and
    every leaf moved (in bf16 a 1e-3 step of a norm weight of 1 rounds
    away)."""
    cfg = dataclasses.replace(tget(arch.split("-")[0]), dtype="float32")
    if arch.endswith("swa"):
        cfg = dataclasses.replace(cfg, attn_type="swa", window=8)
    model = build_model(cfg, device="cpu")
    params = make_trainable(model.init(0))
    before = {k: p.detach().clone() for k, p in trainable_params(params).items()}
    seen = {}

    def record(grads):
        seen.update(grads)
        return grads

    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1), compressor=record)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 17))
    _, _, m = step(params, adamw_init(before), {"tokens": torch.from_numpy(tokens)})
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert set(seen) == set(before)
    for k, p in trainable_params(params).items():
        assert seen[k].isfinite().all() and (seen[k] != 0).any(), k
        assert not torch.equal(p.detach(), before[k]), k


def test_refuse_grad_guard():
    """The guard every kernel without a backward calls on CUDA tensors: it
    raises, naming the kernel, where autograd would record the call, and
    nowhere else."""
    x, w = torch.ones(2, 2, requires_grad=True), torch.ones(2, 2)
    with pytest.raises(RuntimeError, match="flash_attention: the CUDA kernel has no backward"):
        _build.refuse_grad("flash_attention", w, x, None)
    _build.refuse_grad("nm_prune", w, None)
    with torch.no_grad():
        _build.refuse_grad("nm_prune", x)
