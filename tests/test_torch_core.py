"""Parity of the PyTorch port's core numerics with the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  N:M masks
must be bit-identical (ties to the lower channel index); scores, scales and
pruned products agree to float32 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nm as jnm
from repro.core import policy as jpolicy
from repro.core import pruner as jpruner
from repro.core import scoring as jscoring
from repro_torch.core import nm, policy, pruner, scoring

# float32 reductions run in another order in XLA and in torch
F32 = dict(rtol=1e-5, atol=1e-6)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ N:M

@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (8, 16), (3, 8), (1, 4), (4, 4)])
def test_nm_topk_mask_bit_identical(n, m):
    s = np.abs(_np(n * 31 + m, 5, 7, 4 * m))
    got = nm.nm_topk_mask(torch.from_numpy(s), n, m).numpy()
    want = np.asarray(jnm.nm_topk_mask(jnp.asarray(s), n, m))
    np.testing.assert_array_equal(got, want)
    assert (got.reshape(5, 7, 4, m).sum(-1) == n).all()


@pytest.mark.parametrize("n,m", [(2, 4), (8, 16)])
def test_nm_topk_mask_forced_ties_go_to_lower_index(n, m):
    """Scores drawn from three levels force many ties inside a group; the
    first occurrence must win in both packages."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, 3, size=(64, 4 * m)).astype(np.float32)
    s[0] = 1.0                                   # a fully tied row
    got = nm.nm_topk_mask(torch.from_numpy(s), n, m).numpy()
    want = np.asarray(jnm.nm_topk_mask(jnp.asarray(s), n, m))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0].reshape(-1, m)[:, :n], True)
    np.testing.assert_array_equal(got[0].reshape(-1, m)[:, n:], False)


def test_nm_group_view_rejects_ragged_width():
    with pytest.raises(ValueError):
        nm.nm_group_view(torch.zeros(3, 10), 4)


# -------------------------------------------------------------- scoring

@pytest.mark.parametrize("with_scale", [False, True])
def test_score_and_prune_input_match(with_scale):
    x = _np(1, 6, 64)
    sc = np.abs(_np(2, 64)) + 0.5 if with_scale else None
    pol, jpol = policy.paper_policy(8, 16), jpolicy.paper_policy(8, 16)
    ts = None if sc is None else torch.from_numpy(sc)
    js = None if sc is None else jnp.asarray(sc)
    np.testing.assert_array_equal(
        scoring.score_activations(torch.from_numpy(x), ts).numpy(),
        np.asarray(jscoring.score_activations(jnp.asarray(x), js)))
    np.testing.assert_array_equal(
        pruner.prune_input(torch.from_numpy(x), ts, pol).numpy(),
        np.asarray(jpruner.prune_input(jnp.asarray(x), js, jpol)))


@pytest.mark.parametrize("mode", ["wanda", "robust"])
def test_channel_scales_match(mode):
    w = _np(3, 96, 40) * 0.05
    w[5, 7] = 3.0                                # an outlier the band clips
    got = scoring.precompute_scale(torch.from_numpy(w), mode).numpy()
    want = np.asarray(jscoring.precompute_scale(jnp.asarray(w), mode))
    np.testing.assert_allclose(got, want, **F32)
    assert scoring.precompute_scale(torch.from_numpy(w), "naive") is None


def test_robust_scale_above_torch_quantile_limit():
    """LLaMA-3.1-8B's gate/down weights hold 58.7M elements; torch.quantile
    refuses more than 2**24.  The port's sort-based quantile must match
    numpy's, and the Robust-Norm scale the JAX package's."""
    w = _np(11, 4096, 4100) * 0.02
    assert w.size > 2**24
    wt = torch.from_numpy(w)
    lo, hi = scoring.quantiles_linear(wt, (0.005, 0.995))
    np.testing.assert_allclose([float(lo), float(hi)],
                               np.quantile(w, [0.005, 0.995]), rtol=1e-5)
    np.testing.assert_allclose(scoring.robust_norm_scale(wt).numpy(),
                               np.asarray(jscoring.robust_norm_scale(jnp.asarray(w))),
                               rtol=1e-4)


def test_sparse_matmul_plain_matches_reference():
    x, w, b = _np(4, 3, 5, 64), _np(5, 64, 24), _np(6, 24)
    sc = np.abs(_np(7, 64)) + 0.5
    got = pruner.sparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(sc), policy.paper_policy(8, 16),
                               bias=torch.from_numpy(b)).numpy()
    want = np.asarray(jpruner.sparse_matmul(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(sc),
                                            jpolicy.paper_policy(8, 16),
                                            bias=jnp.asarray(b)))
    np.testing.assert_allclose(got, want, **F32)
    # tile consensus: one shared channel set for the 15 tokens of (3, 5)
    for sc_ in (sc, None):
        got = pruner.sparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   None if sc_ is None else torch.from_numpy(sc_),
                                   policy.paper_policy(8, 16, tile_consensus=True),
                                   bias=torch.from_numpy(b)).numpy()
        want = np.asarray(jpruner.sparse_matmul(
            jnp.asarray(x), jnp.asarray(w), None if sc_ is None else jnp.asarray(sc_),
            jpolicy.paper_policy(8, 16, tile_consensus=True), bias=jnp.asarray(b)))
        np.testing.assert_allclose(got, want, **F32)


def test_precompute_scales_walk_matches_reference():
    from repro.configs.base import get_smoke_config
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_smoke_config as tget
    from repro_torch.weights import from_jax_params

    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    jpol = jpolicy.paper_policy(8, 16, (3,))
    jscaled = jax.tree_util.tree_map(np.asarray, jpruner.precompute_scales(params, jpol))
    model = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params),
                            device="cpu")
    pruner.precompute_scales(model, policy.paper_policy(8, 16, (3,)))
    for i, blk in enumerate(model.blocks):
        per = jscaled["periods"]["b0"]
        for name, lin in (("q_proj", blk.q_proj), ("down_proj", blk.mlp.down_proj),
                          ("gate_proj", blk.mlp.gate_proj)):
            src = per[name] if name == "q_proj" else per["mlp"][name]
            np.testing.assert_allclose(lin.amber_scale.numpy(), src["amber_scale"][i], **F32)
        for lin in (blk.k_proj, blk.v_proj, blk.o_proj, blk.mlp.up_proj):
            assert lin.amber_scale is None


# --------------------------------------------------------------- policy

def test_policy_mirrors_reference_fields():
    """Every field of the JAX SparsityPolicy, same order and defaults, with
    ``use_pallas_kernels`` renamed ``use_kernels``."""
    rename = {"use_pallas_kernels": "use_kernels"}
    jf = [(rename.get(f.name, f.name), f.default) for f in
          dataclasses.fields(jpolicy.SparsityPolicy)]
    tf = [(f.name, f.default) for f in dataclasses.fields(policy.SparsityPolicy)]
    assert jf == tf
    assert policy.DENSE.enabled is False and jpolicy.DENSE.enabled is False
    assert scoring.SCORE_MODES == jscoring.SCORE_MODES


@pytest.mark.parametrize("kw", [dict(n=0, m=4), dict(n=5, m=4), dict(n=2.0, m=4),
                                dict(score_mode="nope"), dict(tile_size=0)])
def test_policy_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        jpolicy.SparsityPolicy(**kw)
    with pytest.raises(ValueError):
        policy.SparsityPolicy(**kw)


def test_paper_policy_decisions_match_reference():
    skip = (19, 21, 28, 30, 31)
    jp, tp = jpolicy.paper_policy(8, 16, skip), policy.paper_policy(8, 16, skip)
    for mod in jpolicy.ALL_PROJS:
        for layer in (None, *range(32)):
            assert tp.should_prune(mod, layer) == jp.should_prune(mod, layer), (mod, layer)
    assert tp.skip_layers == jp.skip_layers
    assert tp.with_(use_kernels=True).use_kernels is True
    assert tp.with_(n=2, m=4).skip_layers == tp.skip_layers
    assert all(tp.active(ph) == jp.active(ph) for ph in ("prefill", "decode", "train"))
