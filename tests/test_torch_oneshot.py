"""The port's one-shot slice against the JAX package: the ``flash_attention``
and ``nm_spmm`` kernels' plain versions, the tile-consensus helpers, and the
Qwen2-7B smoke model through ``forward`` and ``ServingEngine.generate``.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.
Channel selections are bit-identical (ties to the lower channel); float32
products and attention agree to summation order, bfloat16 outputs to one
bfloat16 rounding.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import nm as jnm
from repro.core import policy as jpolicy
from repro.core import pruner as jpruner
from repro.core import scoring as jscoring
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import nm, policy
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import nm_spmm as kns
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.weights import from_jax_params

# float32: summation order only
F32 = dict(rtol=1e-5, atol=1e-5)
# bfloat16 outputs: both sides round a float32 result once; one bf16 ulp
BF16 = dict(rtol=2.0**-7, atol=2.0**-7)
# float32 model logits: summation order through four layers
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(a, dtype):
    """The same values in both packages (bf16 rounding is round-to-nearest-
    even in both)."""
    if dtype == "bfloat16":
        return torch.from_numpy(a).bfloat16(), jnp.asarray(a, jnp.bfloat16)
    return torch.from_numpy(a), jnp.asarray(a)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------- flash_attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5], ids=["full", "window5"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("hq,hkv,t", [(4, 2, 24), (8, 2, 128)], ids=["g2", "g4"])
def test_flash_attention_matches_pallas_and_ref(hq, hkv, t, causal, window, dtype):
    """GQA over 2 and 4 query heads per KV head, causal and not, with and
    without a window band; T ≤ 128 or a multiple of it, so the JAX side
    really takes its kernel."""
    b, hd = 2, 16
    q, jq = _both(_np(1, b, t, hq, hd), dtype)
    k, jk = _both(_np(2, b, t, hkv, hd), dtype)
    v, jv = _both(_np(3, b, t, hkv, hd), dtype)
    got = kfa.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    tr = lambda a: a.transpose(0, 2, 1, 3)
    bq = min(128, t)
    pallas = tr(flash_attention_pallas(tr(jq), tr(jk), tr(jv), causal=causal, window=window,
                                       block_q=bq, block_k=bq, interpret=True))
    g = hq // hkv
    ref = tr(jref.flash_attention_ref(tr(jq), tr(jnp.repeat(jk, g, axis=2)),
                                      tr(jnp.repeat(jv, g, axis=2)), causal=causal,
                                      window=window))
    tol = F32 if dtype == "float32" else BF16
    for want in (pallas, ref):
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    assert kfa.flash_attention.launches == 0          # CPU tensors never launch


def test_flash_attention_ragged_t_matches_ref():
    """T = 200 is not a multiple of 128: the JAX ``attention`` would leave
    its kernel for the scan; the port serves it (the kernel masks its own
    edge), and equals the oracle and the JAX chunked attention."""
    b, t, hq, hkv, hd = 1, 200, 4, 2, 16
    q, k, v = _np(4, b, t, hq, hd), _np(5, b, t, hkv, hd), _np(6, b, t, hkv, hd)
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          impl="flash").numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tr = lambda a: a.transpose(0, 2, 1, 3)
    ref = tr(jref.flash_attention_ref(tr(jq), tr(jnp.repeat(jk, 2, axis=2)),
                                      tr(jnp.repeat(jv, 2, axis=2))))
    np.testing.assert_allclose(got, np.asarray(ref), **F32)
    np.testing.assert_allclose(got, np.asarray(jattn.attention(jq, jk, jv, impl="flash")),
                               **F32)


@pytest.mark.parametrize("kw", [dict(q_offset=3), dict(kv_len=20), dict(t_q=1)],
                         ids=["offset", "kv_len", "decode"])
def test_attention_flash_route_only_for_whole_sequence(kw, monkeypatch):
    """``impl="flash"`` reaches the kernel only for self-attention from
    position 0; the other calls take the online-softmax loop and agree with
    the JAX package's."""
    b, s, hq, hkv, hd = 2, 24, 4, 2, 16
    t = kw.get("t_q", s)
    q, k, v = _np(7, b, t, hq, hd), _np(8, b, s, hkv, hd), _np(9, b, s, hkv, hd)
    args = dict(q_offset=kw.get("q_offset", 0 if t == s else s - 1), kv_len=kw.get("kv_len"))
    calls = []
    monkeypatch.setattr(kfa, "flash_attention", lambda *a, **k_: calls.append(1))
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          impl="flash", chunk=8, **args).numpy()
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="flash",
                           chunk=8, **args)
    assert not calls
    np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_chunked_attention_with_window_raises():
    """The two windowed cases outside the flash kernel's that raised until
    sliding windows were ported (the causal band of the plain path, and a
    non-causal band, which ``impl="flash"`` leaves to the plain loop) now
    match the JAX package's ``attention`` (float32)."""
    x = _np(10, 1, 8, 2, 16)
    for kw in (dict(window=4), dict(window=4, causal=False, impl="flash")):
        got = tattn.attention(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(x),
                              **kw).numpy()
        want = jattn.attention(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), **kw)
        np.testing.assert_allclose(got, np.asarray(want), **F32)


# ------------------------------------------------------------ nm_spmm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [True, False], ids=["scale", "noscale"])
@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (8, 16)])
def test_nm_spmm_matches_pallas_and_ref(n, m, scale, dtype):
    """t = 37 is not a multiple of the 16-token tile (the last tile holds 5
    tokens), and d = 192 spans three 64-channel ``block_k`` steps of the
    Pallas kernel."""
    t, d, n_out, tile = 37, 192, 40, 16
    x, jx = _both(_np(10 + m, t, d), dtype)
    w, jw = _both(_np(11, d, n_out) * d**-0.5, dtype)
    sc = np.abs(_np(12, d)) + 0.5 if scale else None
    ts, js = (torch.from_numpy(sc), jnp.asarray(sc)) if scale else (None, None)
    got = kns.nm_spmm(x, w, ts, n, m, tile)
    assert got.dtype == x.dtype and got.shape == (t, n_out)
    pallas = jops.nm_spmm(jx, jw, js, n, m, tile=tile, block_o=16, block_k=64,
                          interpret=True)
    pad = (-t) % tile
    ref = jref.nm_spmm_ref(jnp.pad(jx, ((0, pad), (0, 0))), jw, js, n, m, tile)[:t]
    tol = F32 if dtype == "float32" else BF16
    for want in (pallas, ref):
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    assert kns.nm_spmm.launches == 0


@pytest.mark.parametrize("case,args,route", [
    # (dtype, T, D, N_out, n, m, tile, w 16-byte aligned) -> (route, row block, k slices)
    ("gate_2048", (torch.bfloat16, 2048, 3584, 18944, 8, 16, 256, True), ("wgmma", 256, 1)),
    ("q_2048", (torch.bfloat16, 2048, 3584, 3584, 8, 16, 256, True), ("wgmma", 256, 1)),
    ("down_2048", (torch.bfloat16, 2048, 18944, 3584, 8, 16, 256, True), ("wgmma", 256, 1)),
    ("q_300", (torch.bfloat16, 300, 3584, 3584, 8, 16, 256, True), ("wgmma", 256, 2)),
    ("down_300", (torch.bfloat16, 300, 18944, 3584, 8, 16, 256, True), ("wgmma", 256, 2)),
    ("down_256_narrow", (torch.bfloat16, 256, 18944, 512, 8, 16, 256, True), ("wgmma", 256, 8)),
    ("tile100", (torch.bfloat16, 300, 640, 264, 8, 16, 100, True), ("wgmma", 128, 1)),
    ("t37", (torch.bfloat16, 37, 256, 200, 8, 16, 256, True), ("wgmma", 128, 1)),
    ("tile5_kc48", (torch.bfloat16, 37, 96, 72, 2, 4, 5, True), ("wgmma", 128, 1)),
    ("kc45", (torch.bfloat16, 130, 120, 48, 3, 8, 40, True), ("wmma", 64, 1)),
    ("n_out_odd", (torch.bfloat16, 300, 512, 130, 8, 16, 256, True), ("wmma", 64, 1)),
    ("w_misaligned", (torch.bfloat16, 2048, 3584, 3584, 8, 16, 256, False), ("wmma", 64, 1)),
    ("float32", (torch.float32, 2048, 3584, 3584, 8, 16, 256, True), ("f32", 64, 1)),
])
def test_nm_spmm_gemm_plan_routes(case, args, route):
    """Which shapes take the wgmma GEMM (bf16, a 16-byte-aligned w, N_out
    and the kept width G*n multiples of 8), with which row block (a whole
    consensus tile of up to 256 tokens; 128 for tiles of at most 128) and
    how many k slices (only where the blocks fill under half of 132 SMs,
    with at least 8 k steps a slice and no empty slice); WMMA and the
    float32 kernel take the rest."""
    plan = kns.gemm_plan(*args, sms=132)
    assert plan == route
    dtype, t, d, n_out, n, m, tile, _ = args
    if plan[0] == "wgmma" and plan[2] > 1:
        k_steps = -(-(d // m * n) // 64)
        per = -(-k_steps // plan[2])
        assert (plan[2] - 1) * per < k_steps <= plan[2] * per and per >= 8


def test_nm_spmm_tied_scores_pick_the_lower_channels():
    """Integer activations from three levels tie inside most groups; every
    tile must keep the JAX package's channels bit for bit, and a fully tied
    tile keeps the first N of every group."""
    n, m, tile = 2, 4, 8
    x = np.random.default_rng(13).integers(0, 3, size=(24, 32)).astype(np.float32)
    x[16:] = 1.0                                  # the third tile: all tied
    w = _np(14, 32, 8)
    idx, xc = kns.consensus_select_plain(torch.from_numpy(x), None, n, m, tile)
    for i in range(3):
        xt = jnp.asarray(x[i * tile:(i + 1) * tile])
        want = jnm.tile_consensus_channels(jscoring.score_activations(xt, None), n, m)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want).reshape(-1))
        np.testing.assert_array_equal(xc[i * tile:(i + 1) * tile].numpy(),
                                      np.asarray(jnm.compact_columns(xt, want)))
    np.testing.assert_array_equal(idx[2].numpy().reshape(-1, n) % m, [[0, 1]] * 8)
    got = kns.nm_spmm(torch.from_numpy(x), torch.from_numpy(w), None, n, m, tile).numpy()
    want = jref.nm_spmm_ref(jnp.asarray(x), jnp.asarray(w), None, n, m, tile)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


# ------------------------------------------------ tile-consensus helpers

@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (8, 16), (3, 8)])
@pytest.mark.parametrize("kind", ["random", "tied", "leading_axes"])
def test_tile_consensus_helpers_bit_identical(n, m, kind):
    rng = np.random.default_rng(n * 7 + m)
    if kind == "tied":
        s = rng.integers(0, 3, size=(16, 4 * m)).astype(np.float32)
    elif kind == "leading_axes":                   # (B, T, D): every axis pooled
        s = np.abs(_np(n + m, 3, 5, 4 * m))
    else:
        s = np.abs(_np(n + m, 16, 4 * m))
    got = nm.tile_consensus_channels(torch.from_numpy(s), n, m)
    want = np.asarray(jnm.tile_consensus_channels(jnp.asarray(s), n, m))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (4, n) and bool((got.diff(dim=-1) > 0).all())
    x = _np(21, 6, 4 * m)
    np.testing.assert_array_equal(nm.compact_columns(torch.from_numpy(x), got).numpy(),
                                  np.asarray(jnm.compact_columns(jnp.asarray(x), want)))


@pytest.mark.parametrize("n,m", [(2, 4), (8, 16)])
def test_validate_nm_matches_reference(n, m):
    s = np.abs(_np(22, 6, 4 * m))
    mask = np.array(jnm.nm_topk_mask(jnp.asarray(s), n, m))
    loose = mask.copy()
    loose[2, :m] = True                            # one group over budget
    for mk, ok in ((mask, True), (loose, False), (np.zeros_like(mask), True)):
        got = nm.validate_nm(torch.from_numpy(mk), n, m)
        assert bool(got) is ok is bool(jnm.validate_nm(jnp.asarray(mk), n, m))
    assert bool(nm.validate_nm(nm.nm_topk_mask(torch.from_numpy(s), n, m), n, m))


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("tile", [256, 5])
def test_sparse_matmul_tile_consensus_flattens_leading_axes(tile, use_kernels):
    """(B, T, D) input: all leading axes form the token axis, so a 5-token
    tile spans batch rows, as in the JAX package; the bias is added after
    the product."""
    from repro_torch.core import pruner

    x, w, b = _np(23, 3, 7, 64), _np(24, 64, 24), _np(25, 24)
    sc = np.abs(_np(26, 64)) + 0.5
    pol = policy.paper_policy(8, 16, tile_consensus=True).with_(tile_size=tile,
                                                                use_kernels=use_kernels)
    jpol = jpolicy.paper_policy(8, 16, tile_consensus=True).with_(tile_size=tile)
    got = pruner.sparse_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sc),
                               pol, bias=torch.from_numpy(b)).numpy()
    want = jpruner.sparse_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc), jpol,
                                 bias=jnp.asarray(b))
    np.testing.assert_allclose(got, np.asarray(want), **F32)


# ----------------------------------------------- Qwen2-7B smoke, one shot

SKIP = get_smoke_config("qwen2_7b").qgate_skip_layers
POLICIES = {
    "dense": (jpolicy.DENSE, policy.DENSE),
    "paper_8_16": (jpolicy.paper_policy(8, 16, SKIP), policy.paper_policy(8, 16, SKIP)),
    "tile_consensus": (jpolicy.paper_policy(8, 16, SKIP, tile_consensus=True),
                       policy.paper_policy(8, 16, SKIP, tile_consensus=True)),
    # 12-token tiles over 2 x 16 prompt tokens: tiles span the two rows
    "tile_consensus_12": (
        jpolicy.paper_policy(8, 16, SKIP, tile_consensus=True).with_(tile_size=12),
        policy.paper_policy(8, 16, SKIP, tile_consensus=True).with_(tile_size=12)),
}
TOKS = np.random.default_rng(1).integers(0, 256, size=(2, 16)).astype(np.int32)
MAX_SEQ, NEW = 32, 8


@pytest.fixture(scope="module")
def qwen():
    """The Qwen2-7B smoke config in float32 and its JAX weights, with the
    q/k/v biases (zero at init) set to seeded values."""
    cfg = dataclasses.replace(get_smoke_config("qwen2_7b"), dtype="float32")
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    blk = dict(params["periods"]["b0"])
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        b = blk[name]["b"]
        blk[name] = {**blk[name], "b": jnp.asarray(_np(30 + i, *b.shape) * 0.1)}
    params = {**params, "periods": {**params["periods"], "b0": blk}}
    return cfg, params


def _jax_generate(jm, jp, jpol, toks, **serve):
    with warnings.catch_warnings():                # the reference's own deprecation
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = JServingEngine(jm, jpol, JServeConfig(max_seq=MAX_SEQ, **serve))
    return np.asarray(eng.generate(jp, {"tokens": jnp.asarray(toks)}, NEW)["tokens"])


@pytest.fixture(scope="module")
def qwen_reference(qwen):
    """Per (policy, attn_impl): the JAX weights with Amber scales, forward
    logits and greedy tokens of the JAX one-shot engine."""
    cfg, params = qwen
    out = {}
    for impl in ("chunked", "flash"):
        jm = jbuild(dataclasses.replace(cfg, attn_impl=impl))
        for name, (jpol, _) in POLICIES.items():
            jp = jpruner.precompute_scales(params, jpol)
            fwd = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(TOKS)}, policy=jpol,
                                        phase="prefill"))
            out[name, impl] = (jax.tree_util.tree_map(np.asarray, jp), fwd,
                               _jax_generate(jm, jp, jpol, TOKS))
    return out


def _port(impl, params_np, name, use_kernels):
    tcfg = dataclasses.replace(tget("qwen2_7b"), dtype="float32", attn_impl=impl)
    return (build_model(tcfg, device="cpu"), from_jax_params(tcfg, params_np, device="cpu"),
            POLICIES[name][1].with_(use_kernels=use_kernels))


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_qwen_forward_logits_match(qwen_reference, name, impl, use_kernels):
    params_np, fwd, _ = qwen_reference[name, impl]
    tm, tp, tpol = _port(impl, params_np, name, use_kernels)
    got = tm.forward(tp, {"tokens": torch.from_numpy(TOKS)}, policy=tpol, phase="prefill").numpy()
    np.testing.assert_allclose(got, fwd, **TOL)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_qwen_one_shot_generate_matches_reference(qwen_reference, name, impl, use_kernels):
    params_np, _, jtoks = qwen_reference[name, impl]
    tm, tp, tpol = _port(impl, params_np, name, use_kernels)
    out = ServingEngine(tm, tpol, ServeConfig(max_seq=MAX_SEQ)).generate(
        tp, {"tokens": torch.from_numpy(TOKS)}, max_new_tokens=NEW)
    assert out["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(out["tokens"].numpy(), jtoks)
    assert int(out["cache"]["pos"]) == TOKS.shape[1] + NEW - 1


@pytest.mark.parametrize("name", ["dense", "tile_consensus"])
def test_qwen_one_shot_trace_counts_over_repeated_calls(qwen_reference, name):
    """Two ``generate`` calls of one shape on one engine: both give the JAX
    engine's tokens, and each program (the prefill of the (B, T) shape, the
    decode step of B) was built once; a third call at another prompt length
    adds its own prefill program and reuses the decode step's."""
    params_np, _, jtoks = qwen_reference[name, "flash"]
    tm, tp, tpol = _port("flash", params_np, name, True)
    eng = ServingEngine(tm, tpol, ServeConfig(max_seq=MAX_SEQ))
    b, t = TOKS.shape
    for _ in range(2):
        out = eng.generate(tp, {"tokens": torch.from_numpy(TOKS)}, max_new_tokens=NEW)
        np.testing.assert_array_equal(out["tokens"].numpy(), jtoks)
        assert int(out["cache"]["pos"]) == t + NEW - 1
    assert eng.trace_counts == {f"prefill_{b}x{t}": 1, f"decode_{b}": 1}
    eng.generate(tp, {"tokens": torch.from_numpy(TOKS[:, :9])}, max_new_tokens=3)
    assert eng.trace_counts == {f"prefill_{b}x{t}": 1, f"prefill_{b}x9": 1, f"decode_{b}": 1}


def test_qwen_one_shot_eos_mask_matches_reference(qwen, qwen_reference):
    """With an EOS token that row 0 emits mid-stream, the row repeats it to
    the end, as the JAX engine's ``done`` mask does."""
    cfg, _ = qwen
    params_np, _, jtoks = qwen_reference["tile_consensus", "flash"]
    eos = int(jtoks[0, 2])
    jm = jbuild(dataclasses.replace(cfg, attn_impl="flash"))
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    want = _jax_generate(jm, jp, POLICIES["tile_consensus"][0], TOKS, eos_token=eos)
    tm, tp, tpol = _port("flash", params_np, "tile_consensus", True)
    got = ServingEngine(tm, tpol, ServeConfig(max_seq=MAX_SEQ, eos_token=eos)).generate(
        tp, {"tokens": torch.from_numpy(TOKS)}, max_new_tokens=NEW)["tokens"].numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()


def test_qwen_prefill_cache_matches_chunked_prefill(qwen_reference):
    """The one-shot prefill writes every row's K/V at position 0: the cache
    it leaves equals the one the paged chunked prefill leaves, row by row."""
    params_np = qwen_reference["dense", "flash"][0]
    tm, tp, tpol = _port("flash", params_np, "dense", True)
    cache = tm.init_cache(2, MAX_SEQ, block_size=8)
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(TOKS)}, cache, policy=tpol)
    assert int(cache["pos"]) == TOKS.shape[1]
    for r in range(2):
        c1 = tm.init_cache(1, MAX_SEQ, block_size=8)
        l1, c1 = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(TOKS[r:r + 1])}, c1,
                                  policy=tpol)
        np.testing.assert_allclose(logits[r:r + 1].numpy(), l1.numpy(), **TOL)
        mb = c1["block_table"].shape[1]
        for lay, lay1 in zip(cache["layers"], c1["layers"]):
            rows = cache["block_table"][r].long()
            np.testing.assert_allclose(lay["k"][rows].numpy(), lay1["k"][:mb].numpy(), **TOL)
            np.testing.assert_allclose(lay["v"][rows].numpy(), lay1["v"][:mb].numpy(), **TOL)


def test_qwen_biases_carried_from_jax(qwen):
    cfg, params = qwen
    tcfg = dataclasses.replace(tget("qwen2_7b"), dtype="float32")
    pn = jax.tree_util.tree_map(np.asarray, params)
    tp = from_jax_params(tcfg, pn, device="cpu")
    per = pn["periods"]["b0"]
    for i, blk in enumerate(tp.blocks):
        for name in ("q_proj", "k_proj", "v_proj"):
            want = per[name]["b"][i]
            assert np.abs(want).max() > 0
            np.testing.assert_array_equal(getattr(blk, name).b.numpy(), want)
        assert blk.o_proj.b is None and blk.mlp.gate_proj.b is None


def test_one_shot_temperature_sampling_is_seeded(qwen_reference):
    params_np = qwen_reference["dense", "chunked"][0]
    tm, tp, tpol = _port("chunked", params_np, "dense", False)

    def run(seed):
        eng = ServingEngine(tm, tpol, ServeConfig(max_seq=MAX_SEQ, temperature=0.8, seed=seed))
        return eng.generate(tp, {"tokens": torch.from_numpy(TOKS)}, NEW)["tokens"]

    a, b = run(3), run(3)
    assert torch.equal(a, b) and a.shape == (2, NEW)
    assert bool(((a >= 0) & (a < 256)).all())
    with pytest.raises(ValueError):
        ServingEngine(tm, tpol, ServeConfig(max_seq=20)).generate(
            tp, {"tokens": torch.from_numpy(TOKS)}, NEW)


# --------------------------------------------------------- device rule

def test_entry_points_default_to_the_gpu(monkeypatch):
    """Without a ``device`` the four builders mean the GPU and raise when
    there is none; they never fall back to the CPU."""
    from repro_torch.models import transformer
    from repro_torch.serve.paged import init_paged_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tget("qwen2_7b")
    for call in (lambda: transformer.init_params(tcfg, 0),
                 lambda: transformer.init_cache(tcfg, 1, 16),
                 lambda: init_paged_cache(tcfg, 1, 16, 8, 4),
                 lambda: from_jax_params(tcfg, {})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert transformer.init_cache(tcfg, 1, 16, device="cpu")["pos"].device.type == "cpu"
