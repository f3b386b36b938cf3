"""The port's layer-skipping tooling, weight-sparsity baselines and synthetic
data stream against the JAX package (``repro.core.sensitivity``,
``repro.core.weight_sparsity``, ``repro.data.pipeline``).

Inputs are seeded numpy arrays fed to both packages; the JAX parameters are
carried into the port with ``from_jax_params``.

* ``relative_perturbation``: within 1e-6 relative of JAX's, up to 2M
  elements (the port accumulates its norms in float64).
* ``targeted_policy``: the same ``should_prune`` table over every (module,
  layer); ``linear_flops`` and ``coverage``: equal to 1e-12 (the same
  float64 Python sums).
* ``sensitivity_scan`` on the LLaMA-3.1 smoke model at depth 2 in float32,
  every projection carrying its Amber scale: e within ``SCAN_RTOL`` of
  JAX's, with the port's plain path and with ``use_kernels`` (the kernels'
  plain versions on the CPU); ``select_qgate_skips`` identical.
* ``magnitude_nm`` / ``wanda_nm`` / ``sparsegpt_nm``: the N:M masks bit for
  bit, ties included, in float32 and bfloat16 at 2:4, 4:8 and 8:16.
* ``lm_batch``: deterministic, the reference's inverse-CDF Zipf tokens on the
  same uniforms, and the same marginal and copy statistics.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.coverage import PUBLISHED as PAPER
from benchmarks.coverage import _dims
from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core import sensitivity as jsens
from repro.core import weight_sparsity as jws
from repro.core.pruner import precompute_scales as jprecompute
from repro.data import pipeline as jdata
from repro.models import build_model as jbuild
from repro_torch import core as tcore
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.core import sensitivity as tsens
from repro_torch.core import weight_sparsity as tws
from repro_torch.data import pipeline as tdata
from repro_torch.models import build_model
from repro_torch.weights import from_jax_params

# e of one probe: float32 throughout, both packages summing in their own
# order (~1e-7 relative in each projection).  e is a difference of two
# nearly equal logit tensors over the norm of one, so those roundings reach
# it magnified by ~1/e (e is 0.05-0.4 here; measured: 7e-8 relative).
# 1e-5 keeps a margin and lies far below the gaps between the probes that
# the selection ranks.
SCAN_RTOL = 1e-5


# ------------------------------------------------- relative_perturbation

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8), (2, 24, 256), (2, 256, 4096)])
def test_relative_perturbation_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    y = rng.standard_normal(shape).astype(np.float32)
    yp = y + 0.05 * rng.standard_normal(shape).astype(np.float32)
    jy, jyp = jnp.asarray(y, dtype), jnp.asarray(yp, dtype)
    ty = torch.from_numpy(np.array(jy.astype(jnp.float32))).to(getattr(torch, dtype))
    typ = torch.from_numpy(np.array(jyp.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tsens.relative_perturbation(ty, typ)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(float(jsens.relative_perturbation(jy, jyp)), rel=1e-6)
    assert float(tsens.relative_perturbation(ty, ty)) == 0.0
    assert float(tsens.relative_perturbation(ty, -ty)) == pytest.approx(2.0, rel=1e-6)


# ------------------------------------------------------ targeted_policy

_BASES = {
    "paper_8_16": (jpolicy.paper_policy(8, 16), tpolicy.paper_policy(8, 16)),
    "paper_2_4_skips": (jpolicy.paper_policy(2, 4, (1, 3)), tpolicy.paper_policy(2, 4, (1, 3))),
    "naive_2_4": (jpolicy.naive_policy(2, 4), tpolicy.naive_policy(2, 4)),
}


@pytest.mark.parametrize("base", list(_BASES))
@pytest.mark.parametrize("module", tpolicy.ALL_PROJS)
def test_targeted_policy_table_matches_jax(module, base):
    jbase, tbase = _BASES[base]
    n_layers = 5
    for layer in range(n_layers):
        jp = jsens.targeted_policy(module, layer, n_layers, jbase)
        tp = tsens.targeted_policy(module, layer, n_layers, tbase.with_(use_kernels=True))
        table = [(mod, i) for mod in tpolicy.ALL_PROJS for i in list(range(n_layers)) + [None]]
        assert ([tp.should_prune(*k) for k in table] == [jp.should_prune(*k) for k in table])
        # layer None (the routed experts) passes every skip list
        assert [k for k in table if tp.should_prune(*k)] == [(module, layer), (module, None)]
        assert (tp.n, tp.m, tp.score_mode, tp.phases) == (jp.n, jp.m, jp.score_mode, jp.phases)
        assert tp.use_kernels and tp.enabled


# ------------------------------------------------- FLOPs and coverage

@pytest.mark.parametrize("arch", list(PAPER))
def test_linear_flops_and_coverage_match_jax(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    assert _dims(jcfg) == _dims(tcfg)
    for tokens in (1, 256):
        jf = jsens.linear_flops(_dims(jcfg), tokens)
        tf = tsens.linear_flops(_dims(tcfg), tokens)
        assert tf == jf
    rng = np.random.default_rng(len(arch))
    skip_lists = [tcfg.qgate_skip_layers, (),
                  tuple(sorted(rng.choice(tcfg.n_layers, 7, replace=False).tolist()))]
    for skips in skip_lists:
        for n, m in ((8, 16), (2, 4)):
            cov = tsens.coverage(tf, tpolicy.paper_policy(n, m, skips), tcfg.n_layers)
            want = jsens.coverage(jf, jpolicy.paper_policy(n, m, skips), jcfg.n_layers)
            assert abs(cov - want) <= 1e-12
    cov = tsens.coverage(tf, tpolicy.paper_policy(8, 16, tcfg.qgate_skip_layers),
                         tcfg.n_layers)
    assert abs(cov - PAPER[arch]) < 0.02 and cov > 0.55       # benchmarks/coverage.py's claim
    assert tsens.coverage(tf, tpolicy.DENSE, tcfg.n_layers) == 0.0
    assert tsens.coverage({}, tpolicy.DENSE, 3) == 0.0        # max(total, 1.0)


@pytest.mark.parametrize("target", [0.55, 0.5, 0.3])
@pytest.mark.parametrize("case", ["random", "ties", "one_layer"])
def test_select_qgate_skips_matches_jax_on_full_widths(case, target):
    """Synthetic sensitivities over LLaMA-3.1-8B's 32 layers and widths:
    ties between layers' sums go to the higher layer first (the reference's
    descending tuple sort), and the walk stops at the first candidate that
    drops coverage under the target."""
    cfg = tget_config("llama31_8b")
    flops = tsens.linear_flops(_dims(cfg))
    rng = np.random.default_rng(11)
    sens = {(mod, i): float(rng.random()) for mod in tpolicy.ALL_PROJS
            for i in range(cfg.n_layers)}
    if case == "ties":
        for i in range(cfg.n_layers):
            sens[("q_proj", i)], sens[("gate_proj", i)] = 0.25 * (i % 3), 0.5
    if case == "one_layer":
        sens = {("q_proj", 4): 1.0}
    got = tsens.select_qgate_skips(sens, flops, cfg.n_layers, tpolicy.paper_policy(8, 16),
                                   target)
    want = jsens.select_qgate_skips(sens, flops, cfg.n_layers, jpolicy.paper_policy(8, 16),
                                    target)
    assert got == want
    pol = tpolicy.paper_policy(8, 16, got)
    assert tsens.coverage(flops, pol, cfg.n_layers) >= target
    if case == "one_layer" and got:
        assert 4 in got


def test_core_exports_the_six_functions():
    for name in ("relative_perturbation", "targeted_policy", "sensitivity_scan",
                 "select_qgate_skips", "linear_flops", "coverage"):
        assert getattr(tcore, name) is getattr(tsens, name)
        assert name in tcore.__all__


# ------------------------------------------------------ the scan itself

SCAN_MODULES = ["q_proj", "o_proj", "gate_proj", "down_proj"]


@pytest.fixture(scope="module")
def scan():
    """The JAX scan on the LLaMA-3.1 smoke model at depth 2, float32, every
    projection with its Amber scale, over q/o/gate/down and one k probe;
    and the port's model on the same parameters and tokens."""
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32", n_layers=2)
    jm = jbuild(cfg)
    base = jpolicy.paper_policy(8, 16)
    params = jprecompute(jm.init(jax.random.PRNGKey(0)), base.with_(skip_modules=()))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)

    def fwd(p, b, policy, phase):
        return jm.forward(p, b, policy=policy, phase=phase)

    batch = {"tokens": jnp.asarray(toks)}
    sens = jsens.sensitivity_scan(fwd, params, batch, SCAN_MODULES, cfg.n_layers, base)
    y0 = fwd(params, batch, jpolicy.DENSE, "prefill")
    k_pol = jsens.targeted_policy("k_proj", 1, cfg.n_layers, base)
    sens["k_proj", 1] = float(jsens.relative_perturbation(y0, fwd(params, batch, k_pol,
                                                                 "prefill")))
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32", n_layers=2)
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return tcfg, build_model(tcfg, device="cpu"), tp, torch.from_numpy(toks), sens


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_sensitivity_scan_matches_jax(scan, use_kernels):
    tcfg, tm, tp, toks, want = scan
    base = tpolicy.paper_policy(8, 16, use_kernels=use_kernels)
    got = tsens.sensitivity_scan(tm.forward, tp, {"tokens": toks}, SCAN_MODULES,
                                 tcfg.n_layers, base)
    got["k_proj", 1] = float(tsens.relative_perturbation(
        tm.forward(tp, {"tokens": toks}, policy=tpolicy.DENSE, phase="prefill"),
        tm.forward(tp, {"tokens": toks},
                   policy=tsens.targeted_policy("k_proj", 1, tcfg.n_layers, base),
                   phase="prefill")))
    assert set(got) == set(want) and all(isinstance(v, float) for v in got.values())
    for key, e in want.items():
        assert got[key] == pytest.approx(e, rel=SCAN_RTOL), key
        assert got[key] > 0
    flops = tsens.linear_flops(_dims(tcfg))
    for target in (0.55, 0.35, 0.2):
        skips = tsens.select_qgate_skips(got, flops, tcfg.n_layers, base, target)
        assert skips == jsens.select_qgate_skips(want, flops, tcfg.n_layers,
                                                 jpolicy.paper_policy(8, 16), target)
    assert tsens.select_qgate_skips(got, flops, tcfg.n_layers, base, 0.35) == (0,)


# ------------------------------------------------ weight-sparsity baselines

def _weights_with_ties(d_in, d_out, dtype):
    """Seeded (d_in, d_out) weights, a calibration norm and a Hessian
    diagonal, with exact ties inside groups: channel 1 mirrors channel 0's
    magnitudes, channels 8..15 of column 0 are one value, and the norms of
    channels 2 and 3 are equal."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    w[1] = -w[0]
    w[8:16, 0] = 0.75
    am = (np.abs(rng.standard_normal(d_in)) + 0.1).astype(np.float32)
    am[3] = am[2]
    am[8:16] = 1.5
    jw = jnp.asarray(w, dtype)
    return jw, torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype)), am


@pytest.mark.parametrize("method", ["magnitude", "wanda", "sparsegpt"])
@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (8, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_sparsity_masks_match_jax(dtype, n, m, method):
    jw, tw, am = _weights_with_ties(64, 24, dtype)
    hd = am**2
    if method == "magnitude":
        want, got = jws.magnitude_nm(jw, n, m), tws.magnitude_nm(tw, n, m)
    elif method == "wanda":
        want = jws.wanda_nm(jw, jnp.asarray(am), n, m)
        got = tws.wanda_nm(tw, torch.from_numpy(am), n, m)
    else:
        want = jws.sparsegpt_nm(jw, jnp.asarray(hd), n, m)
        got = tws.sparsegpt_nm(tw, torch.from_numpy(hd), n, m)
    assert got.dtype == tw.dtype and got.shape == tw.shape and got.is_contiguous()
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    groups = (got != 0).T.reshape(24, 64 // m, m).sum(-1)
    assert (groups == n).all()                       # no weight here is exactly 0
    if method == "sparsegpt":
        np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == "float32" else 2**-8)
    else:
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- the data stream

def test_lm_batch_deterministic():
    cfg = tdata.DataConfig(vocab_size=1000, seq_len=32, global_batch=4, seed=7)
    a = tdata.lm_batch(cfg, 12, "cpu")["tokens"]
    assert torch.equal(a, tdata.lm_batch(cfg, 12, "cpu")["tokens"])
    assert not torch.equal(a, tdata.lm_batch(cfg, 13, "cpu")["tokens"])
    assert not torch.equal(a, tdata.lm_batch(dataclasses.replace(cfg, seed=8), 12,
                                             "cpu")["tokens"])
    assert a.shape == (4, 33) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    batches = list(tdata.calibration_stream(cfg, 3, "cpu"))
    assert len(batches) == 3 and not torch.equal(batches[0]["tokens"], batches[1]["tokens"])
    assert torch.equal(batches[2]["tokens"], tdata.lm_batch(cfg, 10_000_002, "cpu")["tokens"])


@pytest.mark.parametrize("vocab,alpha", [(5000, 1.1), (128256, 1.1), (256, 1.3)])
def test_zipf_inverse_cdf_matches_jax(vocab, alpha):
    key = jax.random.PRNGKey(3)
    shape = (16, 513)
    want = np.asarray(jdata._zipf_tokens(key, shape, vocab, alpha))
    u = np.array(jax.random.uniform(key, shape, minval=1e-6, maxval=1.0))
    np.testing.assert_array_equal(tdata._zipf_tokens(torch.from_numpy(u), vocab, alpha)
                                  .numpy(), want)


def test_lm_batch_zipf_marginal_and_copy_rate():
    """The reference's statistics on a 16 x 1025 batch: low ids dominate, and
    a token equals the one ``copy_back`` earlier about as often as in JAX's
    stream (copy_prob * (1 - copy_prob) of positions by the copy, plus
    chance)."""
    cfg = tdata.DataConfig(vocab_size=5000, seq_len=1024, global_batch=16)
    got = tdata.lm_batch(cfg, 0, "cpu")["tokens"].numpy()
    want = np.asarray(jdata.lm_batch(jdata.DataConfig(vocab_size=5000, seq_len=1024,
                                                      global_batch=16), 0)["tokens"])
    for toks in (got, want):
        assert (toks < 50).mean() > 0.3 and (toks > 2500).mean() < 0.1
    assert abs((got < 50).mean() - (want < 50).mean()) < 0.02
    back = cfg.copy_back
    rate = (got[:, back:] == got[:, :-back]).mean()
    assert rate > cfg.copy_prob * (1 - cfg.copy_prob)
    assert abs(rate - (want[:, back:] == want[:, :-back]).mean()) < 0.02


def test_chip_smoke_scan_helpers(scan):
    """``chip_smoke.py``'s phase-9 helpers on the CPU: its FLOP map is
    ``benchmarks/coverage.py``'s, its projection spy sees every projection
    call of a forward with its layer, and ``nm_flips`` pairs the two paths'
    pruned inputs (here both plain: no flip) with one group count per
    M channels of each pruned row."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for arch in PAPER:
        assert cs.coverage_dims(tget_config(arch)) == _dims(jget_config(arch))
    assert cs.PUBLISHED_COVERAGE == PAPER
    tcfg, tm, tp, toks, _ = scan
    seen = []
    with cs.spy_projections(lambda x, p, module, policy, phase, layer:
                            seen.append((module, layer, x.shape[-1]))):
        tm.forward(tp, {"tokens": toks}, policy=tpolicy.DENSE, phase="prefill")
    assert sorted((m, i) for m, i, _ in seen) == sorted(
        (m, i) for m in tpolicy.ALL_PROJS for i in range(tcfg.n_layers))
    assert {(m, d) for m, _, d in seen} == {(m, dims[0]) for m, dims in _dims(tcfg).items()}
    pol = tpolicy.paper_policy(8, 16)
    table = cs.nm_flips(torch, lambda uk: tm.forward(tp, {"tokens": toks},
                                                     policy=pol.with_(use_kernels=uk),
                                                     phase="prefill"))
    rows = toks.numel()
    assert table == {(m, i): [0, rows * _dims(tcfg)[m][0] // 16]
                     for m in ("q_proj", "gate_proj", "down_proj") for i in range(tcfg.n_layers)}
