"""MoE training of the port against ``jax.grad`` of the JAX package, on the
Qwen3-30B-A3B, Mixtral-8x7B and Llama-4-Scout smoke configs in float32:
the loss and every gradient leaf (expert stacks and router included), one
AdamW step, the N:M masks inside the experts, ``nm_prune``'s
``torch.autograd.Function`` alone, and the weight-decay rule on the
stacked MoE tree.

Two policies: ``DENSE``, and ``paper_policy(8, 16)`` active in ``"train"``
with ``use_kernels=True`` (q through ``PruneMatmul``, the routed experts'
gate and down inputs through ``nm_prune``'s ``Prune``, their plain
forwards on the CPU).  The JAX tree is the port's seeded init in the
reference's layout (``jax.eval_shape`` of the JAX init filled from the
port's modules); one jitted function per arch steps both policies side by
side and hands out the first step's gradients through the compressor
hook.  Tolerances are stated where they are used: float32 differences are
summation order only.  JAX is imported inside the fixtures.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import nm, scoring
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import nm_prune as knp
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.train import (OptConfig, loss_fn, make_train_step, make_trainable,
                               trainable_params)
from repro_torch.train.optimizer import decays
from repro_torch.weights import from_jax_params, named_from_jax

ARCHS = ("qwen3_30b_a3b", "mixtral_8x7b", "llama4_scout_17b_a16e")
POLICIES = ("dense", "sparse")
SPARSE = ("train", "prefill")
TOKS = np.random.default_rng(20).integers(0, 256, size=(2, 17)).astype(np.int32)
STEP_LR = 1e-2


def _tpolicy(name):
    return (tpolicy.DENSE if name == "dense" else
            tpolicy.paper_policy(8, 16).with_(phases=SPARSE, use_kernels=True))


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
    """Per arch: (JAX config, port config, JAX model, the params as numpy in
    the JAX layout, filled from the port's seeded init)."""
    import jax

    from repro.configs.base import get_smoke_config
    from repro.models import build_model as jbuild

    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        tcfg = dataclasses.replace(tget(arch), dtype="float32")
        jm = jbuild(cfg)
        port = build_model(tcfg, device="cpu").init(0)

        def get(mod, keys):
            if len(keys) >= 3 and keys[-3] == "experts":    # the port drops a stack's w
                keys = keys[:-1]
            return functools.reduce(getattr, keys, mod).detach().numpy()

        def fill(path, sds):
            keys = [str(k.key) for k in path]
            if keys[0] == "periods":
                a = np.stack([get(blk, keys[2:]) for blk in port.blocks])
            else:
                a = get(port, keys)
            assert a.shape == sds.shape and a.dtype == sds.dtype, keys
            return a

        pn = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jm.init,
                                                                   jax.random.PRNGKey(0)))
        out[arch] = (cfg, tcfg, jm, pn)
    return out


@pytest.fixture(scope="module")
def jax_runs(smoke):
    """Per arch and policy: JAX's first step at lr ``STEP_LR`` from the
    smoke weights on ``TOKS``: its loss and gradients (port names), its
    metrics, and the parameters and ``mu`` after it.  One jitted function a
    arch steps both policies."""
    import jax
    import jax.numpy as jnp

    from repro.core import policy as jpolicy
    from repro.train.optimizer import OptConfig as JOptConfig
    from repro.train.optimizer import adamw_init as j_adamw_init
    from repro.train.train_step import make_train_step as j_make_train_step

    jpols = {"dense": jpolicy.DENSE, "sparse": jpolicy.paper_policy(8, 16).with_(phases=SPARSE)}
    out = {}
    for arch in ARCHS:
        cfg, tcfg, jm, pn = smoke[arch]
        named = lambda t: named_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, t))
        seen = {name: [] for name in POLICIES}

        def stepper(name):
            def hand_out(g):
                jax.debug.callback(seen[name].append, g)
                return g

            return j_make_train_step(jm, JOptConfig(lr=STEP_LR, warmup_steps=1,
                                                    total_steps=10), jpols[name],
                                     compressor=hand_out)

        jp = jax.tree_util.tree_map(jnp.asarray, pn)
        both = jax.jit(lambda p, b: {name: stepper(name)(p, j_adamw_init(p), b)
                                     for name in POLICIES})
        res = both(jp, {"tokens": jnp.asarray(TOKS)})
        for name, (p, opt, m) in res.items():
            jax.block_until_ready(p)
            out[arch, name] = dict(metrics={k: float(v) for k, v in m.items()},
                                   grads=named(seen[name][0]), params=named(p),
                                   mu=named(opt["mu"]))
    return out


def _port(smoke, arch):
    tcfg = smoke[arch][1]
    return build_model(tcfg, device="cpu"), make_trainable(
        from_jax_params(tcfg, smoke[arch][3], device="cpu"))


def _grads(tm, tp, policy):
    named = trainable_params(tp)
    loss = loss_fn(tm, tp, {"tokens": torch.from_numpy(TOKS)}, policy)
    return loss.item(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(smoke, jax_runs, arch, policy):
    """The loss within rel 1e-5 and every gradient leaf allclose: rtol 1e-4,
    atol 4e-6 x the leaf's largest |g| (``test_torch_train.py`` says why);
    Llama-4-Scout's router gradient is exactly 0 in both packages (its
    top-1 softmax is the constant 1)."""
    loss, grads = _grads(*_port(smoke, arch), _tpolicy(policy))
    want = jax_runs[arch, policy]
    assert loss == pytest.approx(want["metrics"]["loss"], rel=1e-5)
    assert set(grads) == set(want["grads"])
    assert any(".moe.experts." in k for k in grads) and any(".moe.router." in k for k in grads)
    for k, g in grads.items():
        w = want["grads"][k]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=4e-6 * np.abs(w).max(),
                                   err_msg=k)
        if ".moe.router." in k:
            scout = arch == "llama4_scout_17b_a16e"
            assert (not np.any(w)) == scout and (not bool(g.any())) == scout, k


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(smoke, jax_runs, arch, policy):
    """One ``make_train_step`` step at lr 1e-2 against JAX's jitted one:
    loss and ``grad_norm`` within rel 1e-5; the new parameters within rtol
    1e-5, atol 1e-6 wherever JAX's new ``mu`` exceeds 1e-3 of its leaf's
    largest, and within AdamW's own bound of 2 lr elsewhere (Adam divides
    float32 noise by a near-zero moment there); ``mu`` within the gradients'
    tolerance."""
    tm, tp = _port(smoke, arch)
    step = make_train_step(tm, OptConfig(lr=STEP_LR, warmup_steps=1, total_steps=10),
                           _tpolicy(policy))
    from repro_torch.train import adamw_init

    _, opt, m = step(tp, adamw_init(trainable_params(tp)), {"tokens": torch.from_numpy(TOKS)})
    want = jax_runs[arch, policy]
    assert m["loss"].item() == pytest.approx(want["metrics"]["loss"], rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(want["metrics"]["grad_norm"], rel=1e-5)
    for k, p in trainable_params(tp).items():
        mu = want["mu"][k]
        # mu is (1 - b1) x the clipped gradient: the gradients' tolerance
        np.testing.assert_allclose(opt["mu"][k].numpy(), mu, rtol=1e-4,
                                   atol=4e-6 * np.abs(mu).max(), err_msg=k)
        got, firm = p.detach().numpy(), np.abs(mu) > 1e-3 * np.abs(mu).max()
        np.testing.assert_allclose(got[firm], want["params"][k][firm], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        assert np.abs(got - want["params"][k]).max() <= 2 * STEP_LR + 1e-6, k


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_masks_match_jax(smoke, monkeypatch, arch):
    """Every N:M selection inside the experts of a ``--sparse-train``
    forward and backward (the gate and down inputs, each layer, remat's
    recompute included): ``Prune``'s mask equals JAX's ``nm_topk_mask`` on
    the same input, and on the input rounded to a grid of 1/4, where most
    groups hold ties (the first occurrence wins in both)."""
    import jax.numpy as jnp

    from repro.core import nm as jnm

    seen = []
    real = knp.Prune.forward

    def spy(ctx, x, scale, n, m):
        seen.append(x.detach().clone())
        return real(ctx, x, scale, n, m)

    monkeypatch.setattr(knp.Prune, "forward", staticmethod(spy))
    _grads(*_port(smoke, arch), _tpolicy("sparse"))
    layers = smoke[arch][1].n_layers
    assert len(seen) == 2 * 2 * layers        # gate and down, a forward and its recompute
    for x in seen:
        for xs in (x, torch.round(x * 4) / 4):
            keep = knp._plain(xs, None, 8, 16)[1]
            want = np.asarray(jnm.nm_topk_mask(jnp.asarray(scoring.score_activations(
                xs, None).numpy()), 8, 16))
            np.testing.assert_array_equal(keep.numpy(), want)
            assert torch.equal(keep, nm.nm_topk_mask(scoring.score_activations(xs, None),
                                                     8, 16))


def test_prune_function_passes_a_kept_zero():
    """``Prune`` (the kernel path's autograd.Function) against the plain
    path's autograd on the same inputs, bit for bit, with a whole group of
    exact zeros and a lone zero: a kept channel whose value is 0 passes its
    gradient (the reference's ``jnp.where(mask, x, 0)``); through
    ``ops.nm_prune``'s reshapes of an ``(E, C, D)`` slot tensor too."""
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 2, 32, generator=g)
    x[0, 1, :16] = 0.0                             # a whole 16-group of zeros
    x[1, 0, 3] = 0.0
    dy = torch.randn(3, 2, 32, generator=g)
    outs = []
    for via_fn in (True, False):
        xa = x.clone().requires_grad_()
        if via_fn:
            y = ops.nm_prune(xa, None, 2, 16)
            assert "PruneBackward" in str(y.grad_fn.next_functions)
        else:
            y = nm.apply_nm(xa, scoring.score_activations(xa, None), 2, 16)
        y.backward(dy)
        outs.append((y.detach(), xa.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    dx = outs[0][1]
    assert torch.equal(dx[0, 1, :2], dy[0, 1, :2]) and not bool(dx[0, 1, 2:16].any())


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_on_the_stacked_moe_tree(smoke, arch):
    """``decays`` equals the reference's ``p.ndim >= 2`` on its stacked
    tree, leaf for leaf: every expert stack, router and norm of a block is
    decayed; only ``final_norm`` is not."""
    import jax

    _, tcfg, _, pn = smoke[arch]
    flags = named_from_jax(tcfg, jax.tree_util.tree_map(lambda p: np.asarray(p.ndim >= 2), pn))
    named = trainable_params(_port(smoke, arch)[1])
    assert set(flags) == set(named)
    for k, p in named.items():
        assert decays(k, p) == bool(flags[k]), k
    assert not decays("final_norm.w", named["final_norm.w"])
    assert all(decays(k, p) for k, p in named.items() if ".moe." in k)


def test_grouped_matmul_plain_differentiates_like_the_library():
    """The per-expert loop (the CPU's grouped product) differentiates
    through its slice writes: ``dX`` and ``dW`` equal those of
    ``torch._grouped_mm``'s own backward on the CPU, empty groups and
    groups of odd length included."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(13, 8, generator=g)
    w = torch.randn(4, 8, 12, generator=g)      # rows of 16-byte multiples
    offs = torch.tensor([3, 3, 10, 13], dtype=torch.int32)
    dy = torch.randn(13, 12, generator=g)
    got, want = [], []
    for fn, out in ((tmoe.grouped_matmul_plain, got),
                    (lambda a, b, o: torch._grouped_mm(a, b, offs=o), want)):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        out.extend(torch.autograd.grad(fn(xa, wa, offs), [xa, wa], dy))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert not bool(got[1][1].any())               # the empty group's weight gets 0


def test_count_step_counts_the_grouped_backward():
    """``launch/roofline.count_step`` on ``meta``: the grouped product's
    forward and its backward (``torch._grouped_mm`` again, in its ``dX`` form
    on the transposed weights and its ``dW`` form of ``Xᵀ · dY`` with the
    offsets along K) each count ``2·R·K·N`` bf16 operations, and the layer's
    backward under remat counts the same forward products again."""
    from repro_torch.launch import roofline

    r, k, n, g = 96, 64, 32, 8
    x = torch.empty(r, k, dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty(g, k, n, dtype=torch.bfloat16, device="meta", requires_grad=True)
    offs = torch.empty(g, dtype=torch.int32, device="meta")
    dy = torch.empty(r, n, dtype=torch.bfloat16, device="meta")

    def fwd():
        return tmoe.grouped_matmul(x, w, offs)

    def fwd_bwd():
        return torch.autograd.grad(tmoe.grouped_matmul(x, w, offs), [x, w], dy)

    _, once = roofline.count_step(fwd)
    _, both = roofline.count_step(fwd_bwd)
    assert once.ops["bf16"] == 2 * r * k * n
    assert both.ops["bf16"] == 3 * 2 * r * k * n
