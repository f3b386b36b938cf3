"""Training of the recurrent families against ``jax.grad`` of the JAX
package, on the RWKV6-7B and RecurrentGemma-2B smoke configs in float32:
the loss and every gradient leaf (the WKV's decay LoRA, ``u``, the RG-LRU's
``lam``, gates and convolution included), one AdamW step, the recurrences
alone under autograd, the weight-decay rule on the stacked tree (its
unrolled tail included), and gradient compression on a ZeRO mesh.

Two policies: ``DENSE``, and ``paper_policy(8, 16)`` active in ``"train"``
with ``use_kernels=True`` (the pruned projections through
``nm_prune_matmul``'s ``PruneMatmul``, its plain forward on the CPU).  The
JAX tree is the port's seeded init in the reference's layout
(``jax.eval_shape`` of the JAX init, each leaf filled through
``weights.named_from_jax``'s own map); one jitted function per arch steps
both policies side by side and hands out the first step's gradients
through the compressor hook.

The recurrences alone: ``rwkv6.wkv_chunked`` (log decays, 16-token
sub-chunks) against ``wkv_scan`` (its token loop) and the reference's
``lax.scan`` of ``_time_mix_step``, values and gradients, at T = 1, 17
and 33 from a nonzero entering state, with channels whose decay
``exp(-exp(z))`` underflows to 0 in float32; ``rglru._rglru_scan``
(Hillis-Steele doubling) against ``lax.associative_scan``.

Compression: ``make_train_step(compressor=...)`` over
``ef_int8_compress`` on a (data 2, model 1) mesh of two gloo ranks
(ZeRO-1/2: each rank compresses its slice of every gradient with the
whole leaf's scale) against the same two steps on one rank, and its first
step against the reference's ``make_train_step(compressor=...)``.
Tolerances are stated where they are used: float32 differences are
summation order only.  JAX is imported inside the fixtures and tests: the
ranks import this module to find their function.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.distributed import ef_int8_compress, ef_int8_init
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.train import (OptConfig, adamw_init, loss_fn, make_train_step, make_trainable,
                               trainable_params)
from repro_torch.train.optimizer import decays, tail_layers
from repro_torch.weights import from_jax_params, named_from_jax, reference_leaves

ARCHS = ("rwkv6_7b", "recurrentgemma_2b")
POLICIES = ("dense", "sparse")
SPARSE = ("train", "prefill")
TOKS = np.random.default_rng(30).integers(0, 256, size=(2, 21)).astype(np.int32)
STEP_LR = 1e-2
# the gradients' tolerance: rtol 1e-4, atol this x the leaf's largest |g|
# (float32 summation order; the WKV's chunked form sums in another order)
G_ATOL = 4e-6


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


def jax_layout(jm, tcfg, port):
    """The port's parameters as numpy in the JAX layout: the JAX init's
    shapes, each entry numbered, the numbers mapped to port names by
    ``named_from_jax`` and every entry filled from the parameter that
    holds it."""
    import jax

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    leaves, tdef = jax.tree_util.tree_flatten(shapes)
    sizes = [int(np.prod(s.shape)) for s in leaves]
    offs = np.cumsum([0] + sizes)
    ids = tdef.unflatten([np.arange(o, o + n).reshape(s.shape)
                          for o, n, s in zip(offs, sizes, leaves)])
    flat = np.full(offs[-1], np.nan, np.float64)
    params = dict(port.named_parameters())
    for k, where in named_from_jax(tcfg, ids).items():
        flat[where.reshape(-1)] = params[k].detach().double().numpy().reshape(-1)
    assert not np.isnan(flat).any()
    return tdef.unflatten([flat[o:o + n].reshape(s.shape).astype(s.dtype)
                           for o, n, s in zip(offs, sizes, leaves)])


@pytest.fixture(scope="module")
def smoke():
    """Per arch: (JAX config, port config, JAX model, the params as numpy
    in the JAX layout, filled from the port's seeded init)."""
    from repro.configs.base import get_smoke_config
    from repro.models import build_model as jbuild

    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        tcfg = dataclasses.replace(tget(arch), dtype="float32")
        jm = jbuild(cfg)
        out[arch] = (cfg, tcfg, jm, jax_layout(jm, tcfg, build_model(tcfg, device="cpu").init(0)))
    return out


@pytest.fixture(scope="module")
def jax_runs(smoke):
    """Per arch and policy: JAX's first step at lr ``STEP_LR`` from the
    smoke weights on ``TOKS``: its loss and gradients (port names), its
    metrics, and the parameters and ``mu`` after it.  One jitted function
    an arch steps both policies."""
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
    """The loss within rel 1e-5 and every gradient leaf allclose: rtol
    1e-4, atol ``G_ATOL`` x the leaf's largest |g|; the recurrences'
    own leaves (RWKV6's ``w0``, ``w_A``, ``w_B``, ``u``; the RG-LRU's
    ``lam``, ``gate_a``, ``gate_x``, ``conv_w``) among them, and
    RecurrentGemma's local attention over T = 20 tokens, past its smoke
    window of 8."""
    loss, grads = _grads(*_port(smoke, arch), _tpolicy(policy))
    want = jax_runs[arch, policy]
    assert loss == pytest.approx(want["metrics"]["loss"], rel=1e-5)
    assert set(grads) == set(want["grads"])
    own = ("w0", "w_A", "w_B", "u") if arch == "rwkv6_7b" else ("lam", "conv_w", "gate_a.w")
    assert TOKS.shape[1] - 1 > (smoke[arch][1].window if arch != "rwkv6_7b" else 0)
    assert all(any(k.endswith("." + o) for k in grads) for o in own)
    for k, g in grads.items():
        w = want["grads"][k]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=G_ATOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(smoke, jax_runs, arch, policy):
    """One ``make_train_step`` step at lr 1e-2 against JAX's jitted one:
    loss and ``grad_norm`` within rel 1e-5; the new parameters within rtol
    1e-5, atol 1e-6 wherever JAX's new ``mu`` exceeds 1e-3 of its leaf's
    largest, and within AdamW's own bound of 2 lr elsewhere (Adam divides
    float32 noise by a near-zero moment there); ``mu`` within the
    gradients' tolerance."""
    tm, tp = _port(smoke, arch)
    step = make_train_step(tm, OptConfig(lr=STEP_LR, warmup_steps=1, total_steps=10),
                           _tpolicy(policy))
    _, opt, m = step(tp, adamw_init(trainable_params(tp)), {"tokens": torch.from_numpy(TOKS)})
    want = jax_runs[arch, policy]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_bitwise(smoke, arch):
    """Remat around a recurrent layer (its state dropped: no cache takes
    it) changes no bit of the loss or of any gradient."""
    tcfg = smoke[arch][1]
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        tp = make_trainable(from_jax_params(cfg, smoke[arch][3], device="cpu"))
        out.append(_grads(build_model(cfg, device="cpu"), tp, _tpolicy("sparse")))
    assert out[0][0] == out[1][0]
    for k, g in out[0][1].items():
        assert torch.equal(g, out[1][1][k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_on_the_stacked_tree(smoke, arch):
    """``decays`` with the config's ``tail_layers`` equals the reference's
    ``p.ndim >= 2`` on its stacked tree, leaf for leaf: every leaf of a
    layer in a scan-stacked period is decayed, the 1-D leaves of
    RecurrentGemma's unrolled tail (layers 3 and 4 of the smoke config's
    five: one period of three, then two) are not, nor is ``final_norm``."""
    import jax

    _, tcfg, _, pn = smoke[arch]
    flags = named_from_jax(tcfg, jax.tree_util.tree_map(lambda p: np.asarray(p.ndim >= 2), pn))
    named = trainable_params(_port(smoke, arch)[1])
    assert set(flags) == set(named)
    tail = tail_layers(tcfg)
    assert tail == ((3, 4) if arch == "recurrentgemma_2b" else ())
    for k, p in named.items():
        assert decays(k, p, tail) == bool(flags[k]), k
    if tail:
        assert not decays("blocks.3.ln1.w", named["blocks.3.ln1.w"], tail)


# ------------------------------------------------------- the recurrences alone

def _wkv_inputs(t, seed=0, b=2, h=2, n=8):
    """(S, r, k, v, z, u) float32 numpy: the decay ``w = exp(-exp(z))``;
    ``z`` of the last four channels of head 0 is 5-6, where ``w`` underflows
    to 0 in float32 (``exp(-exp(5)) = 3e-65``), the rest near the init's -4."""
    g = np.random.default_rng(seed)
    d = h * n
    z = g.normal(-3.0, 1.0, size=(b, t, d)).astype(np.float32)
    z[..., n - 4:n] = g.uniform(5.0, 6.0, size=(b, t, 4))
    return (g.standard_normal((b, h, n, n)).astype(np.float32),
            *(g.standard_normal((b, t, d)).astype(np.float32) for _ in range(3)), z,
            (g.standard_normal((h, n)) * 0.5).astype(np.float32))


def _wkv_port(fn, arrays, cot_y, cot_s):
    """``fn`` of the port (``wkv_chunked`` on log decays, or ``wkv_scan``
    on decays) → (new S, y, the gradients of ``sum(y·cot_y) + sum(S·cot_s)``
    with respect to S, r, k, v, z, u), numpy."""
    S, r, k, v, z, u = (torch.from_numpy(a).requires_grad_() for a in arrays)
    lw = -torch.exp(z)
    h = u.shape[0]
    S1, y = fn(S, r, k, v, lw, u, h) if fn is trwkv6.wkv_chunked else fn(S, r, k, v,
                                                                         lw.exp(), u, h)
    obj = (y * torch.from_numpy(cot_y)).sum() + (S1 * torch.from_numpy(cot_s)).sum()
    grads = torch.autograd.grad(obj, [S, r, k, v, z, u])
    return S1.detach().numpy(), y.detach().numpy(), [g.numpy() for g in grads]


def _wkv_jax(arrays, cot_y, cot_s):
    """The reference's recurrence: ``lax.scan`` of its ``_time_mix_step``
    over ``w = exp(-exp(z))``, and ``jax.grad`` of the same objective."""
    import jax
    import jax.numpy as jnp

    from repro.models.rwkv6 import _time_mix_step

    def run(S, r, k, v, z, u):
        w = jnp.exp(-jnp.exp(z))
        xs = tuple(a.transpose(1, 0, 2) for a in (r, k, v, w))
        S1, ys = jax.lax.scan(lambda s, x: _time_mix_step(s, x, u, u.shape[0]), S, xs)
        return S1, ys.transpose(1, 0, 2)

    def obj(*a):
        S1, y = run(*a)
        return (y * cot_y).sum() + (S1 * cot_s).sum()

    S1, y = run(*arrays)
    grads = jax.grad(obj, argnums=tuple(range(6)))(*arrays)
    return np.asarray(S1), np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("t", [1, 17, 33])
def test_wkv_chunked_grads_match_the_scan_and_jax(t):
    """``wkv_chunked``'s new state, output and gradients (of S, r, k, v, the
    decay's pre-activation z and u) against ``wkv_scan``'s and the
    reference's scan's, at T not a multiple of 16, from a nonzero state,
    with strongly decaying channels: rtol 1e-4, atol 2e-5 x the largest
    entry (float32 summation order; the chunked form sums a sub-chunk's
    terms in another order).  Where ``w`` underflows to 0 the reference's
    ``jax.grad`` through it is 0 and the port's, through ``exp`` of the
    log decays, is 0 too; no gradient is NaN (the masked pairs' ``-inf``
    stays out of the backward)."""
    arrays = _wkv_inputs(t)
    g = np.random.default_rng(t)
    cot_y = g.standard_normal(arrays[1].shape).astype(np.float32)
    cot_s = g.standard_normal(arrays[0].shape).astype(np.float32)
    chunked = _wkv_port(trwkv6.wkv_chunked, arrays, cot_y, cot_s)
    scan = _wkv_port(trwkv6.wkv_scan, arrays, cot_y, cot_s)
    ref = _wkv_jax(arrays, cot_y, cot_s)
    names = ("S", "y", "dS", "dr", "dk", "dv", "dz", "du")
    for other in (scan, ref):
        for name, a, b in zip(names, chunked[:2] + tuple(chunked[2]), other[:2] + tuple(other[2])):
            assert np.isfinite(a).all(), name
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5 * np.abs(b).max(),
                                       err_msg=name)
    dz = chunked[2][4]
    assert not dz[..., 4:8].any()        # w = 0 there: no gradient reaches z


@pytest.mark.parametrize("t", [1, 17, 33])
def test_rglru_scan_grads_match_associative_scan(t):
    """``_rglru_scan`` (Hillis-Steele doubling) against the reference's
    ``lax.associative_scan`` of the same combine, from a nonzero ``h0``:
    the states and the gradients of ``a``, ``bx`` and ``h0``, rtol 1e-5,
    atol 1e-6 x the largest entry (both sum in a tree order of their own)."""
    import jax
    import jax.numpy as jnp

    from repro.models.rglru import _rglru_scan as j_scan

    g = np.random.default_rng(40 + t)
    a = g.uniform(0.2, 1.0, size=(2, t, 16)).astype(np.float32)
    bx = g.standard_normal((2, t, 16)).astype(np.float32)
    h0 = g.standard_normal((2, 16)).astype(np.float32)
    cot = g.standard_normal((2, t, 16)).astype(np.float32)
    ta, tb, th = (torch.from_numpy(x).requires_grad_() for x in (a, bx, h0))
    hs = trglru._rglru_scan(ta, tb, th)
    got = [hs.detach().numpy()] + [x.numpy() for x in torch.autograd.grad(
        (hs * torch.from_numpy(cot)).sum(), [ta, tb, th])]
    want = [np.asarray(j_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0)))] + [
        np.asarray(x) for x in jax.grad(lambda *xs: (j_scan(*xs) * cot).sum(),
                                        argnums=(0, 1, 2))(a, bx, h0)]
    for name, x, y in zip(("h", "da", "dbx", "dh0"), got, want):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6 * np.abs(y).max(), err_msg=name)


# ------------------------------------------------------------- compression

COMP_ARCH = "rwkv6_7b"
COMP_STEPS = [np.random.default_rng(50 + i).integers(0, 256, size=(4, 17)).astype(np.int32)
              for i in range(2)]
COMP_OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def compressed_run(params_np):
    """Two compressed steps of the RWKV6 smoke config from ``params_np`` (the
    JAX layout, numpy) on this process's mesh (a bound ``mesh_scope``, or
    none) → per step (loss, grad norm, the compressed gradients as this
    rank holds them), the parameters after the steps, and the mesh's rank."""
    import contextlib

    tcfg = dataclasses.replace(tget(COMP_ARCH), dtype="float32")
    model = build_model(tcfg, device="cpu")
    params = make_trainable(from_jax_params(tcfg, params_np, device="cpu"))
    named = trainable_params(params)
    mesh = shd._context_mesh()
    ef = ef_int8_init(named)
    leaves = reference_leaves(tcfg, named)
    seen = []

    def compressor(grads):
        nonlocal ef
        comp, ef = ef_int8_compress(grads, ef, leaves)
        seen.append({k: v.clone() for k, v in comp.items()})
        return comp

    step = make_train_step(model, COMP_OPT, compressor=compressor)
    opt = adamw_init(named)
    out = []
    for toks in COMP_STEPS:
        batch = torch.from_numpy(toks)
        if mesh is not None:
            batch = shd.local(batch, shd.batch_spec(mesh), mesh)
        opt, m = step(params, opt, {"tokens": batch})[1:]
        out.append((float(m["loss"]), float(m["grad_norm"]), seen[-1]))
    return out, {k: p.detach().clone() for k, p in named.items()}, \
        None if mesh is None else mesh.rank


def compression_rank(mesh, params_np):
    import torch.distributed as dist

    with shd.mesh_scope(mesh, batch_shards=2):
        mine = compressed_run(params_np)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return everyone


@pytest.fixture(scope="module")
def compression(smoke, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("compression"))
    params_np = smoke[COMP_ARCH][3]
    ranks = spawn(compression_rank, 2, params_np, device="cpu", store_dir=root,
                  grid=((2, 1), ("data", "model")))
    return ranks, compressed_run(params_np)


def _codes(comp, leaves):
    """Compressed gradients' int8 codes and scales: each reference leaf's
    largest entry is the code ±127 (``_quant_dequant``), its layers sharing
    that scale → ``{name: (codes, scale)}``."""
    top = {}
    for k, c in comp.items():
        top[leaves[k]] = max(top.get(leaves[k], 0.0), float(np.abs(c).max()))
    return {k: (np.round(c / (top[leaves[k]] / 127)).astype(np.int32), top[leaves[k]] / 127)
            for k, c in comp.items()}


def _same_codes(got, want, leaves):
    """Two compressions of one gradient summed in another float32 order:
    per tensor, their scales within rel 1e-5, their codes equal but for
    entries that sat on a rounding boundary (at most 0.2%), and never more
    than one step apart → the names whose codes parted."""
    parted, theirs = set(), _codes(want, leaves)
    for k, (cg, sg) in _codes(got, leaves).items():
        cw, sw = theirs[k]
        assert sg == pytest.approx(sw, rel=1e-5), k
        assert np.abs(cg - cw).max() <= 1, k
        assert (cg != cw).mean() <= 2e-3, k
        if (cg != cw).any():
            parted.add(k)
    return parted


def test_compression_on_a_zero_mesh_equals_one_rank(compression):
    """On (data 2, model 1) each rank holds its ZeRO-2 slice of every
    compressed gradient, scaled by the whole reference leaf's absmax (an
    all-reduce of the slices' maxima, then the max over the layers that
    share the leaf), and the error feedback as slices: the two ranks'
    slices together are one rank's compressed gradient, step after step
    (:func:`_same_codes`); losses and grad norms within rel 1e-5 of one
    rank's, and the parameters after two steps within rtol 1e-5, atol 1e-7
    wherever no code of the tensor parted (a parted code moves its entry's
    Adam update by up to the learning rate)."""
    ranks, (one_steps, one_params, _) = compression
    mesh = shd.Mesh(("data", "model"), (2, 1))
    leaves = reference_leaves(dataclasses.replace(tget(COMP_ARCH), dtype="float32"),
                              one_params)
    parted = set()
    for i, (l1, g1, c1) in enumerate(one_steps):
        for steps, _, _ in ranks:
            loss, gnorm, _ = steps[i]
            assert loss == pytest.approx(l1, rel=1e-5) and gnorm == pytest.approx(g1, rel=1e-5)
        wholes = {}
        for k, want in c1.items():
            whole = torch.full_like(want, float("nan"))
            for steps, _, rank in ranks:
                here = dataclasses.replace(mesh, rank=rank)
                mine = shd.local(whole, shd.shard_zero1(want.shape, here), here)
                assert mine.shape == steps[i][2][k].shape, k
                mine.copy_(steps[i][2][k])
            assert not whole.isnan().any(), k
            wholes[k] = whole.numpy()
        parted |= _same_codes(wholes, {k: c.numpy() for k, c in c1.items()}, leaves)
    for _, params, _ in ranks:
        for k, p in params.items():
            if k not in parted:
                torch.testing.assert_close(p, one_params[k], rtol=1e-5, atol=1e-7)


def test_compression_matches_the_reference_step(smoke, compression):
    """The first compressed step on one rank against the reference's
    ``make_train_step(compressor=...)`` over its ``ef_int8_compress``,
    jitted, from zero error feedback, with the scale of each of the
    reference's stacked leaves (``weights.reference_leaves``: a layer's
    tensor shares it with the other layers' rows): the loss and grad norm
    within rel 1e-5, the codes and scales as :func:`_same_codes` states."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.compression import ef_int8_compress as j_compress
    from repro.distributed.compression import ef_int8_init as j_init
    from repro.train.optimizer import OptConfig as JOptConfig
    from repro.train.optimizer import adamw_init as j_adamw_init
    from repro.train.train_step import make_train_step as j_make_train_step

    cfg, tcfg, jm, pn = smoke[COMP_ARCH]
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    seen = []

    def compressor(g):
        comp, _ = j_compress(g, j_init(g))
        jax.debug.callback(seen.append, comp)
        return comp

    step = j_make_train_step(jm, JOptConfig(lr=COMP_OPT.lr, warmup_steps=1, total_steps=10),
                             compressor=compressor)
    _, _, m = jax.jit(step)(jp, j_adamw_init(jp), {"tokens": jnp.asarray(COMP_STEPS[0])})
    want = named_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, seen[0]))
    loss, gnorm, comp = compression[1][0][0]
    assert loss == pytest.approx(float(m["loss"]), rel=1e-5)
    assert gnorm == pytest.approx(float(m["grad_norm"]), rel=1e-5)
    assert set(comp) == set(want)
    _same_codes({k: c.numpy() for k, c in comp.items()}, want, reference_leaves(tcfg, want))
