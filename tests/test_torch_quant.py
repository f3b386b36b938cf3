"""The port's W8A8 / Outstanding-sparse slice against the JAX package.

Inputs and weights are made with numpy from a seed and fed to both
packages.  The integer paths are exact: int8 codes, int32 sums and the
float32 dequant that follows them are bit-identical.  The offline rewrite
(``smooth_factors``, ``make_quantized_linear``) raises float32 values to a
fractional power, where XLA's and torch's ``pow`` may differ by an ulp, so
its float outputs agree to ``rtol=1e-6`` and at most 0.1% of the ``wq``
codes may sit one step apart.  On the CPU each kernel wrapper runs its
plain version; those are held against the Pallas kernels in interpret mode
and against ``kernels/ref.py``.  The model and serving checks run the
LLaMA-3.1 smoke config in float32 with W8A8 on q/k/v/o/gate/up of every
layer (``QuantConfig()``) under ``paper_policy(8, 16, (3,))``.
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers.linear import sparse_linear as jsparse_linear
from repro.models import build_model as jbuild
from repro.serve.api import Engine as JEngine
from repro.serve.api import EngineConfig as JEngineConfig
from repro.serve.continuous import ContinuousConfig as JConfig
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import nm, scoring
from repro_torch.core import policy as tpolicy
from repro_torch.core import quant as tq
from repro_torch.kernels import nm_prune as knp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import osparse_matmul as kos
from repro_torch.kernels import w8a8_matmul as kw8
from repro_torch.layers.linear import QuantLinear, sparse_linear
from repro_torch.models import build_model
from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
from repro_torch.weights import from_jax_params, quantize_linears

# float outputs of the rewrite: an ulp of float32 pow apart
REWRITE = dict(rtol=1e-6, atol=0)
MAX_CODE_FLIPS = 1e-3       # share of wq codes allowed one step apart


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_epilogue_equal(got, want, unbiased):
    """Bit-identical, except that XLA's CPU compiler contracts the Pallas
    kernel's bias epilogue ``acc*scale*w_scale + bias`` (interpret mode)
    into one fused multiply-add: one rounding where the kernel and the jnp
    oracle round twice.  The two then differ by at most half an ulp of the
    product and one of the sum; the limit allows an ulp of each."""
    lim = np.spacing(np.abs(unbiased)) + np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= lim).all()
    assert (got != want).mean() < 0.5


def _absmax(seed, d):
    """Calibration absmax with a few outlier channels, as
    ``examples/deploy_outstanding_sparse.py`` makes them."""
    x = _np(seed, 64, d) * (1 + 10 * (np.arange(d) < 4))
    return np.abs(x).max(axis=0).astype(np.float32)


# ------------------------------------------------------------ quant.py

def test_quantize_functions_bit_identical():
    w = _np(1, 96, 40) * 0.3
    x = _np(2, 7, 5, 96)
    # exact halves force the half-to-even rule; +-200 forces the clip
    x[0, 0, :8] = [0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -200.0, 0.0]
    q, s = tq.quantize_weight_per_channel(_t(w))
    jqw, js = jq.quantize_weight_per_channel(_j(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    one = np.float32(1.0)
    np.testing.assert_array_equal(tq.quantize_act_per_tensor(_t(x), _t(one)).numpy(),
                                  np.asarray(jq.quantize_act_per_tensor(_j(x), _j(one))))
    scale = np.float32(0.037)
    xq = tq.quantize_act_per_tensor(_t(x), _t(scale))
    np.testing.assert_array_equal(xq.numpy(),
                                  np.asarray(jq.quantize_act_per_tensor(_j(x), _j(scale))))
    tq_, ts = tq.quantize_act_per_token(_t(x))
    jq_, js_ = jq.quantize_act_per_token(_j(x))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js_))
    # int8 @ int8 must not wrap: these sums run far past the int8 range
    for xs_t, xs_j in ((_t(scale), _j(scale)), (ts, js_)):
        got = tq.quantized_matmul(tq_ if xs_t is ts else xq, q, xs_t, s).numpy()
        want = np.asarray(jq.quantized_matmul(jq_ if xs_t is ts else _j(xq.numpy()), jqw,
                                              xs_j, js))
        np.testing.assert_array_equal(got, want)
    assert np.abs(tq.int_matmul(tq_, q).numpy()).max() > 127


@pytest.mark.parametrize("alpha,outstanding,per_token", [
    (0.10, True, False), (0.10, True, True), (0.5, False, False)])
def test_smooth_factors_and_make_quantized_linear(alpha, outstanding, per_token):
    w = _np(3, 256, 96) * 256**-0.5
    am = _absmax(4, 256)
    cfg = jq.QuantConfig(alpha=alpha, outstanding=outstanding, per_token_act=per_token)
    tcfg = tq.QuantConfig(alpha=alpha, outstanding=outstanding, per_token_act=per_token)
    np.testing.assert_allclose(
        tq.smooth_factors(_t(am), _t(w), alpha, outstanding).numpy(),
        np.asarray(jq.smooth_factors(_j(am), _j(w), alpha, outstanding)), **REWRITE)
    a = jq.make_quantized_linear(_j(w), _j(am), cfg)
    b = tq.make_quantized_linear(_t(w), _t(am), tcfg)
    for key in ("w_scale", "smooth", "act_scale"):
        np.testing.assert_allclose(getattr(b, key).numpy(), np.asarray(getattr(a, key)),
                                   **REWRITE)
    codes = b.wq.numpy().astype(np.int32) - np.asarray(a.wq).astype(np.int32)
    assert np.abs(codes).max() <= 1 and (codes != 0).mean() <= MAX_CODE_FLIPS
    assert b.wq.dtype == torch.int8 and b.act_scale.dim() == 0 and b.per_token == per_token
    # the rewrite's own forward pass: same function up to those ulps
    x = _np(5, 9, 256)
    np.testing.assert_allclose(b(_t(x)).numpy(), np.asarray(a(_j(x))), rtol=1e-4,
                               atol=1e-4)


def test_quant_config_and_act_calib_match():
    cfg, tcfg = jq.QuantConfig(skip_layers=(0, 2)), tq.QuantConfig(skip_layers=(0, 2))
    for mod in ("q_proj", "down_proj", "gate_proj"):
        for layer in (None, 0, 1, 2):
            assert tcfg.should_quantize(mod, layer) == cfg.should_quantize(mod, layer)
    jc, tc = jq.ActCalib(), tq.ActCalib()
    for seed in (6, 7):
        x = _np(seed, 3, 4, 32)
        jc.observe("h", _j(x))
        tc.observe("h", _t(x))
    np.testing.assert_array_equal(tc.absmax("h").numpy(), np.asarray(jc.absmax("h")))
    assert list(tc.names()) == ["h"]


# ------------------------------------------------ kernel plain versions

def _osparse_inputs(t, d, n_out, amber, bias, seed=10):
    w = _np(seed, d, n_out) * d**-0.5
    wq, w_scale = jq.quantize_weight_per_channel(_j(w))
    return dict(
        x=_np(seed + 1, t, d) * np.where(np.arange(d) % 7 == 0, 5, 1).astype(np.float32),
        wq=np.asarray(wq), w_scale=np.asarray(w_scale),
        smooth=np.abs(_np(seed + 2, d)) + 0.5,
        amber=np.abs(_np(seed + 3, d)) + 0.5 if amber else None,
        bias=_np(seed + 4, n_out) if bias else None,
        act_scale=np.float32(0.021))


def _per_token_codes(c, n, m, prune, xla_rule):
    """The per-token chain's int8 codes and scales, with the scale divided
    by 127 or, ``xla_rule``, multiplied by float32(1/127) as XLA does."""
    xs = _t(c["x"]) / _t(c["smooth"])
    if prune:
        xs = nm.apply_nm(xs, scoring.score_activations(xs, _t(c["amber"])), n, m)
    amax = torch.clamp(xs.abs().amax(-1, keepdim=True), min=1e-8)
    scale = amax * np.float32(1 / 127) if xla_rule else amax / 127.0
    return torch.clamp(torch.round(xs / scale), -127, 127).to(torch.int8), scale


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("amber", [False, True], ids=["noamber", "amber"])
@pytest.mark.parametrize("prune", [False, True], ids=["dense", "prune"])
@pytest.mark.parametrize("per_token", [False, True], ids=["tensor", "token"])
@pytest.mark.parametrize("t,d,n_out,n,m,layout", [
    (37, 64, 48, 8, 16, "n_major"), (16, 128, 40, 4, 8, "n_major"),
    (5, 32, 24, 2, 4, "n_major"), (5, 32, 24, 2, 4, "k_major")],
    ids=["37-64-48-8-16", "16-128-40-4-8", "5-32-24-2-4", "5-32-24-2-4-k_major"])
def test_osparse_matmul_matches_pallas_and_ref(t, d, n_out, n, m, layout, per_token, prune,
                                               amber, bias):
    """Bit-identical to the Pallas kernel (interpret mode) and to the jnp
    oracle, T ragged against the 8-row tile at T = 37 and 5; ``wq`` as the
    JAX package stores it, and as the port does (its K-major view)."""
    c = _osparse_inputs(t, d, n_out, amber, bias)
    if layout == "k_major":
        c["wq"] = np.asarray(tq.k_major(_t(c["wq"])))
        assert c["wq"].strides == (1, d)
    act = None if per_token else c["act_scale"]
    got = kos.osparse_matmul(_t(c["x"]), _t(c["wq"]), _t(c["smooth"]), _t(c["amber"]),
                             _t(c["w_scale"]), n, m, act_scale=_t(act), bias=_t(c["bias"]),
                             prune=prune, per_token=per_token)
    assert got.dtype == torch.float32
    pallas = jops.osparse_matmul(
        _j(c["x"]), _j(c["wq"]), _j(c["smooth"]), _j(c["amber"]), _j(c["w_scale"]), n, m,
        act_scale=_j(act), bias=_j(c["bias"]), prune=prune, per_token=per_token,
        interpret=True)
    want = got
    if per_token:
        # Under jit XLA rewrites the per-token ``absmax / 127`` into
        # ``absmax * (1/127)``, an ulp off on some rows; with that scale the
        # port's chain gives the Pallas result, and its int8 codes are at
        # most one step from the port's on at most 0.1% of them.
        q, scale = _per_token_codes(c, n, m, prune, xla_rule=False)
        q_xla, scale_xla = _per_token_codes(c, n, m, prune, xla_rule=True)
        steps = (q.int() - q_xla.int()).abs()
        assert steps.max() <= 1 and steps.float().mean() <= MAX_CODE_FLIPS
        unbiased = kos.osparse_matmul(
            _t(c["x"]), _t(c["wq"]), _t(c["smooth"]), _t(c["amber"]), _t(c["w_scale"]),
            n, m, prune=prune, per_token=True)
        np.testing.assert_array_equal(
            tq.quantized_matmul(q, _t(c["wq"]), scale, _t(c["w_scale"])).numpy(),
            unbiased.numpy())
        want = tq.quantized_matmul(q_xla, _t(c["wq"]), scale_xla, _t(c["w_scale"]))
        if c["bias"] is not None:
            want = want + _t(c["bias"])
    if c["bias"] is None:
        np.testing.assert_array_equal(want.numpy(), np.asarray(pallas))
    else:
        _assert_epilogue_equal(want.numpy(), np.asarray(pallas), want.numpy() - c["bias"])
    nn_, mm = (n, m) if prune else (1, 1)      # n = m keeps every channel
    ref = np.asarray(jref.osparse_matmul_ref(
        _j(c["x"]), _j(c["wq"]), _j(c["smooth"]), _j(c["amber"]), _j(c["w_scale"]),
        nn_, mm, act_scale=_j(act), per_token=per_token))
    if c["bias"] is not None:
        ref = ref + c["bias"]
    np.testing.assert_array_equal(got.numpy(), ref)
    assert kos.osparse_matmul.launches == 0       # CPU tensors never launch


def test_osparse_ops_flattens_and_checks():
    c = _osparse_inputs(12, 64, 24, True, True)
    x3 = c["x"].reshape(2, 6, 64)
    args = (_t(c["wq"]), _t(c["smooth"]), _t(c["amber"]), _t(c["w_scale"]), 8, 16)
    got = tops.osparse_matmul(_t(x3), *args, act_scale=_t(c["act_scale"]),
                              bias=_t(c["bias"]))
    flat = kos.osparse_matmul(_t(c["x"]), *args, act_scale=_t(c["act_scale"]),
                              bias=_t(c["bias"]))
    assert got.shape == (2, 6, 24)
    np.testing.assert_array_equal(got.reshape(12, 24).numpy(), flat.numpy())
    with pytest.raises(ValueError):
        tops.osparse_matmul(_t(x3), *args, act_scale=None)
    with pytest.raises(ValueError):          # 2:3 groups do not tile D = 64
        tops.osparse_matmul(_t(x3), *args[:4], 2, 3, act_scale=_t(c["act_scale"]))


@pytest.mark.parametrize("t,d,n_out,layout", [
    (37, 80, 130, "n_major"), (4, 64, 16, "n_major"), (37, 80, 130, "k_major"),
    (4, 64, 16, "k_major")],
    ids=["37-80-130", "4-64-16", "37-80-130-k_major", "4-64-16-k_major"])
def test_w8a8_matmul_matches_pallas_and_ref(t, d, n_out, layout):
    """Bit-identical to the Pallas kernel and the jnp oracle, with ``wq`` as
    the JAX package stores it and as the port does (the K-major view)."""
    rng = np.random.default_rng(t)
    xq = rng.integers(-127, 128, (t, d)).astype(np.int8)
    wq = rng.integers(-127, 128, (d, n_out)).astype(np.int8)
    ws = (np.abs(_np(12, n_out)) * 0.01).astype(np.float32)
    xs = np.float32(0.013)
    twq = _t(wq) if layout == "n_major" else tq.k_major(_t(wq))
    assert twq.t().is_contiguous() == (layout == "k_major")
    got = tops.w8a8_matmul(_t(xq), twq, _t(xs), _t(ws))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.w8a8_matmul(_j(xq), _j(wq), _j(xs), _j(ws),
                                                 interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.w8a8_matmul_ref(_j(xq), _j(wq), _j(xs), _j(ws))))
    lead = tops.w8a8_matmul(_t(xq[None]), twq, _t(xs), _t(ws))
    np.testing.assert_array_equal(lead[0].numpy(), got.numpy())
    assert kw8.w8a8_matmul.launches == 0


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("t,d,n,m,scale", [
    (37, 64, 8, 16, True), (16, 128, 2, 4, False), (5, 64, 4, 8, True)])
def test_nm_prune_matches_pallas_and_ref(t, d, n, m, scale, dtype):
    x = _np(20, t, d)
    sc = np.abs(_np(21, d)) + 0.5 if scale else None
    jx = _j(x) if dtype == np.float32 else _j(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32)))
    if dtype != np.float32:
        tx = tx.bfloat16()
    got = tops.nm_prune(tx, _t(sc), n, m)
    assert got.dtype == tx.dtype
    pallas = jops.nm_prune(jx, _j(sc), n, m, interpret=True)
    ref = jref.nm_prune_ref(jx, _j(sc), n, m)
    for want in (pallas, ref):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(knp.nm_prune_plain(tx, _t(sc), n, m).float().numpy(),
                                  got.float().numpy())
    assert knp.nm_prune.launches == 0


# gemm_plan: (case, T, D, N, x dtype, per_token, prune, m, aligned) → (route,
# block, splits, cluster).  LLaMA-3.1-8B's q/k/gate (D = 4096; N 4096, 1024,
# 14336) at decode (T = 4) and at the prefill chunk (T = 256), ragged T on
# either side of the swap route's 16 tokens, D or pointers TMA cannot take,
# per-token scales, float32 x, int8 xq (w8a8_matmul) and a group width the
# fused quantizer does not take.
_BF16, _F32, _I8 = torch.bfloat16, torch.float32, torch.int8
_PLANS = [
    ("q_decode", 4, 4096, 4096, _BF16, False, False, 16, True, ("swap_fused", (64, 8), 2, 8)),
    ("k_decode", 4, 4096, 1024, _BF16, False, False, 16, True, ("swap_fused", (64, 8), 8, 8)),
    ("gate_decode", 4, 4096, 14336, _BF16, False, False, 16, True,
     ("swap_fused", (64, 8), 1, 8)),
    ("q_prefill", 256, 4096, 4096, _BF16, False, True, 16, True, ("wgmma", (256, 128), 2, 2)),
    ("k_prefill", 256, 4096, 1024, _BF16, False, False, 16, True, ("wgmma", (256, 128), 8, 8)),
    ("gate_prefill", 256, 4096, 14336, _BF16, False, True, 16, True,
     ("wgmma", (256, 128), 1, 1)),
    ("ragged_t1", 1, 4096, 4096, _BF16, False, True, 16, True, ("swap_fused", (64, 8), 2, 8)),
    ("ragged_t16", 16, 4096, 4096, _BF16, False, False, 16, True,
     ("swap_fused", (64, 16), 2, 8)),
    ("ragged_t17", 17, 4096, 4096, _BF16, False, False, 16, True, ("wgmma", (256, 128), 2, 2)),
    ("ragged_t300", 300, 4096, 1024, _BF16, False, True, 16, True,
     ("wgmma", (256, 128), 4, 4)),
    ("ragged_t37_gate", 37, 4096, 14336, _BF16, False, True, 16, True,
     ("wgmma", (256, 128), 1, 1)),
    ("unaligned_d", 70, 200, 200, _BF16, False, True, 4, True, ("simple", (32, 64), 1, 1)),
    ("unaligned_d_decode", 4, 200, 200, _BF16, False, False, 4, True,
     ("simple", (32, 64), 1, 1)),
    ("unaligned_ptr", 4, 4096, 4096, _BF16, False, False, 16, False,
     ("simple", (32, 64), 1, 1)),
    ("per_token_decode", 4, 4096, 4096, _BF16, True, False, 16, True,
     ("swap", (64, 8), 2, 8)),
    ("per_token_prefill", 256, 4096, 14336, _BF16, True, True, 16, True,
     ("wgmma", (256, 128), 1, 1)),
    ("f32_decode", 4, 4096, 1024, _F32, False, False, 16, True, ("swap_fused", (64, 8), 8, 8)),
    ("f32_prefill", 137, 4096, 14336, _F32, False, True, 16, True,
     ("wgmma", (256, 128), 1, 1)),
    ("int8_decode", 4, 4096, 1024, _I8, False, False, 16, True, ("swap", (64, 8), 8, 8)),
    ("int8_prefill", 256, 4096, 14336, _I8, False, False, 16, True,
     ("wgmma", (256, 128), 1, 1)),
    ("int8_deep_decode", 16, 14336, 4096, _I8, False, False, 16, True,
     ("swap", (64, 16), 4, 8)),
    ("width_32_decode", 4, 4096, 4096, _BF16, False, True, 32, True, ("swap", (64, 8), 2, 8)),
    ("width_6_decode", 4, 4080, 4096, _BF16, False, True, 6, True, ("swap", (64, 8), 2, 8)),
]


@pytest.mark.parametrize("case,t,d,n_out,dtype,per_token,prune,m,aligned,want", _PLANS,
                         ids=[c[0] for c in _PLANS])
def test_gemm_plan_routes(case, t, d, n_out, dtype, per_token, prune, m, aligned, want):
    """Each case's route, block, k split and cluster size on an H100's 132
    SMs: decode projections in one fused launch, prefill on wgmma, k split
    over a cluster only where the blocks leave the card idle.  An unaligned
    float x leaves the fused route for the quantize pass."""
    plan = kw8.gemm_plan(t, d, n_out, dtype, per_token, prune, m, aligned, sms=132)
    assert tuple(plan) == want
    assert kw8.route_code(plan) in range(4)
    loose = kw8.gemm_plan(t, d, n_out, dtype, per_token, prune, m, aligned, x_aligned=False,
                          sms=132)
    assert loose.route == ("swap" if plan.route == "swap_fused" else plan.route)


@pytest.mark.parametrize("t", [1, 4, 8, 9, 16, 17, 100, 256, 300, 2048])
def test_gemm_plan_fits_the_card(t):
    """Over every projection width of LLaMA-3.1-8B (and a deep D), the plan's
    split is a power of two of at most 8 blocks (one portable cluster) with
    at least two 128-deep k steps each, a split keeps the blocks within half
    the SMs on the wgmma route and within the SMs on the swap route, and a
    swap block's token tile fits 64 KB of shared memory."""
    for d, n_out in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (64, 16)):
        plan = kw8.gemm_plan(t, d, n_out, torch.bfloat16, sms=132)
        k_steps = -(-d // 128)
        s = plan.splits
        assert s & (s - 1) == 0 and 1 <= s <= 8 and plan.cluster % s == 0
        assert plan.cluster == s if plan.route == "wgmma" else plan.cluster <= 8
        assert s == 1 or k_steps >= 2 * s
        if plan.route == "wgmma":
            assert t > 16 and plan.block == (256, 128)
            blocks = -(-t // 256) * -(-n_out // 128)
            assert s == 1 or blocks * s <= 66
        else:
            assert plan.route == "swap_fused" and t <= 16
            assert plan.block == (64, 8 if t <= 8 else 16)
            tile = lambda splits: plan.block[1] * -(-k_steps // splits) * 128
            assert tile(s) <= 64 << 10
            # within the SMs, unless half the split's token tile would not fit
            assert s == 1 or -(-n_out // 64) * s <= 132 or tile(s // 2) > 64 << 10


# ----------------------------------------------------------- sparse_linear

@pytest.mark.parametrize("per_token", [False, True], ids=["tensor", "token"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("module", ["q_proj", "k_proj"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_quantized_sparse_linear_matches_jax_kernels(phase, module, bias, per_token):
    """Port ``use_kernels=True`` (the wrapper's plain version on the CPU) and
    ``False`` vs JAX ``use_pallas_kernels=True`` (the Pallas kernel in
    interpret mode): q_proj is pruned in prefill, k_proj never; decode
    prunes nothing.  Per token, the Pallas kernel's scale carries XLA's
    ``* (1/127)`` rewrite (see the osparse test): each output moves by about
    an ulp of float32, while a code one step off would move it by
    ``scale * w_scale * |wq|`` (~1e-2); so the port is held bit-exact
    against JAX's jnp form and within 1e-6 of the kernel."""
    w = _np(30, 64, 48) * 0.125
    ql = jq.make_quantized_linear(_j(w), _j(_absmax(31, 64)),
                                  jq.QuantConfig(per_token_act=per_token))
    p = {"wq": ql.wq, "w_scale": ql.w_scale, "smooth": ql.smooth,
         "act_scale": ql.act_scale, "amber_scale": _j(np.abs(_np(32, 64)) + 0.5)}
    if per_token:
        p["per_token"] = True
    if bias:
        p["b"] = _j(_np(33, 48))
    x = _np(34, 2, 9, 64)
    jpol = jpolicy.paper_policy(8, 16).with_(use_pallas_kernels=True)
    want = np.asarray(jsparse_linear(_j(x), p, module, jpol, phase))
    if per_token:
        kernel, want = want, np.asarray(jsparse_linear(
            _j(x), p, module, jpol.with_(use_pallas_kernels=False), phase))
        np.testing.assert_allclose(kernel, want, rtol=1e-6, atol=1e-6)
    tl = QuantLinear(tq.QuantizedLinear(
        wq=_t(np.asarray(p["wq"])), w_scale=_t(np.asarray(p["w_scale"])),
        smooth=_t(np.asarray(p["smooth"])), act_scale=_t(np.asarray(p["act_scale"])),
        per_token=per_token), amber_scale=_t(np.asarray(p["amber_scale"])),
        bias=_t(np.asarray(p["b"])) if bias else None)
    tpol = tpolicy.paper_policy(8, 16)
    for uk in (True, False):
        got = sparse_linear(_t(x), tl, module, tpol.with_(use_kernels=uk), phase)
        assert got.dtype == torch.float32 and got.shape == (2, 9, 48)
        if bias and not per_token:
            _assert_epilogue_equal(got.numpy(), want, got.numpy() - np.asarray(p["b"]))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ the model

QPOL = (jpolicy.paper_policy(8, 16, (3,)), tpolicy.paper_policy(8, 16, (3,)))
QUANT = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj")


def _quantize_jax_params(params, cfg):
    """Per-layer ``make_quantized_linear`` on q/k/v/o/gate/up (QuantConfig()
    leaves down_proj float), stacked over the scanned layer axis; the Amber
    scales computed from the float weights stay beside ``wq``."""
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
        q = dict(zip(keys, rewrite(p["w"], _j(am))))
        q.update({k: v for k, v in p.items() if k != "w"})
        owner[name] = q
    blk["mlp"] = mlp
    return {**params, "periods": {**params["periods"], "b0": blk}}


@pytest.fixture(scope="module")
def qsmoke():
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    jm = jbuild(cfg)
    params = jax.jit(lambda key: jprecompute(jm.init(key), QPOL[0]))(jax.random.PRNGKey(0))
    jp = _quantize_jax_params(params, cfg)
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    return (cfg, tcfg, jm, jp, jax.tree_util.tree_map(np.asarray, jp),
            jax.tree_util.tree_map(np.asarray, params))


PROMPT = np.random.default_rng(2).integers(0, 256, size=21)   # 3 chunks of 8
TOKS = np.random.default_rng(1).integers(0, 256, size=(2, 19))
# Float32 logits.  Upstream of each quantizer the two packages differ by
# summation order (~1e-7 relative), which can move an activation across an
# int8 rounding boundary: one code one step off, a change of act_scale *
# w_scale * |w| ~ 1e-3 in that projection's output.  Logits carry such
# rare flips; 1e-3 absolute covers one and the 2e-2 check on the largest
# deviation bounds their count.
QTOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def qreference(qsmoke):
    cfg, tcfg, jm, jp = qsmoke[:4]
    jpol = QPOL[0]
    fwd = np.asarray(jax.jit(lambda p, b: jm.forward(p, b, policy=jpol, phase="prefill"))(
        jp, {"tokens": jnp.asarray(TOKS)}))
    prefill = jax.jit(lambda p, b, c: jm.prefill_chunk(p, b, c, policy=jpol))
    decode = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, policy=jpol))
    cache, chunks, steps = jm.init_cache(1, 48), [], []
    for s in range(0, len(PROMPT), 8):
        part = PROMPT[s:s + 8]
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :len(part)] = part
        jl, cache = prefill(jp, {"tokens": jnp.asarray(chunk),
                                 "chunk_len": jnp.asarray(len(part), jnp.int32)}, cache)
        chunks.append((chunk, len(part), np.asarray(jl)))
    for _ in range(4):
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, cache = decode(jp, jnp.asarray(tok), cache)
        steps.append((tok, np.asarray(jl)))
    return fwd, chunks, steps


def _close(got, want):
    np.testing.assert_allclose(got, want, **QTOL)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_from_jax_params_carries_quantized_dicts(qsmoke):
    _, tcfg, _, _, pn = qsmoke[:5]
    tp = from_jax_params(tcfg, pn, device="cpu")
    src = pn["periods"]["b0"]
    for i, blk in enumerate(tp.blocks):
        for name in QUANT:
            lin = getattr(blk.mlp if name in ("gate_proj", "up_proj") else blk, name)
            p = (src["mlp"] if name in ("gate_proj", "up_proj") else src)[name]
            assert isinstance(lin, QuantLinear) and lin.wq.dtype == torch.int8
            np.testing.assert_array_equal(lin.wq.numpy(), p["wq"][i])
            assert lin.act_scale.dim() == 0 and float(lin.act_scale) == p["act_scale"][i]
            assert (lin.amber_scale is not None) == (name in ("q_proj", "gate_proj"))
        assert not isinstance(blk.mlp.down_proj, QuantLinear)
        assert blk.mlp.down_proj.amber_scale is not None


def _assert_k_major(wq, d_in, d_out):
    """One contiguous (d_out, d_in) int8 buffer behind the (d_in, d_out) view,
    and no second copy of it."""
    assert wq.shape == (d_in, d_out) and wq.dtype == torch.int8
    assert wq.stride() == (1, d_in) and wq.t().is_contiguous()
    assert wq.untyped_storage().nbytes() == d_in * d_out
    assert tq.k_major(wq) is wq


def test_quantized_weights_are_stored_k_major(qsmoke):
    """``from_jax_params`` and ``quantize_linears`` store every ``wq`` K-major
    (the int8 kernels' layout); the values are the JAX package's bit for bit
    through ``from_jax_params``, and the rewrite's own codes through
    ``quantize_linears``."""
    _, tcfg, _, _, pn, float_np = qsmoke
    src = pn["periods"]["b0"]
    carried = from_jax_params(tcfg, pn, device="cpu")
    rewritten = from_jax_params(tcfg, float_np, device="cpu")
    absmax = {(i, name): _absmax(100 * i + len(name), tcfg.d_model if name != "o_proj"
                                 else tcfg.q_dim)
              for i in range(tcfg.n_layers) for name in QUANT}
    floats = {(i, name): getattr(blk.mlp if name in ("gate_proj", "up_proj") else blk,
                                 name).w.clone()
              for i, blk in enumerate(rewritten.blocks) for name in QUANT}
    quantize_linears(rewritten, absmax, tq.QuantConfig())
    for i, (cb, rb) in enumerate(zip(carried.blocks, rewritten.blocks)):
        for name in QUANT:
            mlp = name in ("gate_proj", "up_proj")
            want = (src["mlp"] if mlp else src)[name]["wq"][i]
            lin = getattr(cb.mlp if mlp else cb, name)
            _assert_k_major(lin.wq, *want.shape)
            np.testing.assert_array_equal(lin.wq.numpy(), want)
            lin = getattr(rb.mlp if mlp else rb, name)
            _assert_k_major(lin.wq, *want.shape)
            w = floats[(i, name)].float() * lin.smooth[:, None]
            codes, _ = tq.quantize_weight_per_channel(w)
            assert codes.is_contiguous()              # the rewrite's own (d_in, d_out) codes
            assert torch.equal(lin.wq, codes)
    ql = tq.QuantizedLinear(wq=torch.ones(6, 4, dtype=torch.int8), w_scale=torch.ones(4),
                            smooth=torch.ones(6), act_scale=torch.tensor(1.0))
    _assert_k_major(ql.wq, 6, 4)
    assert QuantLinear(ql).wq is ql.wq


def test_quantize_linears_matches_the_reference_rewrite(qsmoke):
    """The port's own rewrite of the float model (Amber scales first, then
    ``quantize_linears``) against the reference's per-layer
    ``make_quantized_linear``, up to the ulps of the rewrite."""
    _, tcfg, _, _, pn, float_np = qsmoke
    want = from_jax_params(tcfg, pn, device="cpu")
    got = from_jax_params(tcfg, float_np, device="cpu")
    absmax = {(i, name): _absmax(100 * i + len(name), tcfg.d_model if name != "o_proj"
                                 else tcfg.q_dim)
              for i in range(tcfg.n_layers) for name in QUANT}
    quantize_linears(got, absmax, tq.QuantConfig())
    for gb, wb in zip(got.blocks, want.blocks):
        for name in QUANT:
            owner = "mlp" if name in ("gate_proj", "up_proj") else None
            g = getattr(gb.mlp if owner else gb, name)
            w = getattr(wb.mlp if owner else wb, name)
            assert isinstance(g, QuantLinear) and not hasattr(g, "w")
            for key in ("w_scale", "smooth", "act_scale"):
                np.testing.assert_allclose(getattr(g, key).numpy(), getattr(w, key).numpy(),
                                           **REWRITE)
            steps = (g.wq.int() - w.wq.int()).abs()
            assert steps.max() <= 1 and steps.float().mean() <= MAX_CODE_FLIPS
            assert (g.amber_scale is None) == (w.amber_scale is None)
            if g.amber_scale is not None:
                assert torch.equal(g.amber_scale, w.amber_scale)
        assert torch.equal(gb.mlp.down_proj.w, wb.mlp.down_proj.w)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_quantized_model_logits_and_tokens_match(qsmoke, qreference, use_kernels):
    """forward, a 21-token prompt in chunks of 8 (the last padded), then four
    greedy decode steps: logits close, greedy tokens identical."""
    _, tcfg, _, _, pn = qsmoke[:5]
    fwd, chunks, steps = qreference
    tm, tp = build_model(tcfg, device="cpu"), from_jax_params(tcfg, pn, device="cpu")
    tpol = QPOL[1].with_(use_kernels=use_kernels)
    got = tm.forward(tp, {"tokens": torch.from_numpy(TOKS)}, policy=tpol, phase="prefill")
    _close(got.numpy(), fwd)
    assert (got.argmax(-1).numpy() == fwd.argmax(-1)).all()
    cache = tm.init_cache(1, 48, block_size=8)
    for chunk, clen, want in chunks:
        tl, cache = tm.prefill_chunk(
            tp, {"tokens": torch.from_numpy(chunk),
                 "chunk_len": torch.tensor(clen, dtype=torch.int32)}, cache, policy=tpol)
        _close(tl.numpy(), want)
    for tok, want in steps:
        assert int(torch.argmax(tl, dim=-1)[0]) == int(tok[0, 0])
        tl, cache = tm.decode_step(tp, torch.from_numpy(tok), cache, policy=tpol)
        _close(tl.numpy(), want)


# ------------------------------------------------------------- serving

SERVE = dict(max_seq=64, num_slots=2, chunk_size=8, block_size=8, num_blocks=8)


def _traffic():
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 21, 13, 17)]
    return prompts, [0, 0, 2, 5], [8, 12, 6, 10]


@pytest.fixture(scope="module")
def qserved(qsmoke):
    cfg, _, jm, jp = qsmoke[:4]
    eng = JEngine.from_config(jm, JEngineConfig(serving=JConfig(**SERVE)), policy=QPOL[0])
    for p, a, n in zip(*_traffic()):
        eng.submit(p, n, a)
    return eng.run(jp)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_quantized_engine_greedy_tokens_match_reference(qsmoke, qserved, use_kernels):
    """Staggered requests through the port's Engine and the JAX engine under
    the paper's policy plus W8A8: the same greedy tokens."""
    _, tcfg, _, _, pn = qsmoke[:5]
    eng = Engine.from_config(build_model(tcfg, device="cpu"),
                             EngineConfig(serving=ContinuousConfig(validate_pool=True,
                                                                   **SERVE)),
                             policy=QPOL[1].with_(use_kernels=use_kernels), device="cpu")
    for p, a, n in zip(*_traffic()):
        eng.submit(p, n, a)
    res = eng.run(from_jax_params(tcfg, pn, device="cpu"))
    assert res["outputs"] == qserved["outputs"]
    assert all(len(o) == n for o, n in zip(res["outputs"].values(), _traffic()[2]))
