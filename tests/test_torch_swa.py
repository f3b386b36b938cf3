"""Sliding-window attention of the port against the JAX package's.

* ``models.attention``: the plain online softmax with a ``window`` band and
  explicit ``kv_positions`` (``-1``: never written), ragged per-row
  ``kv_len`` and per-row decode offsets; ``_banded_attention``, the
  whole-sequence prefill over ``window + chunk`` key slabs, at ``T`` above
  the window; against ``repro.models.attention``'s functions of the same
  names.  float32, ``allclose`` at 2e-5 (summation order only).
* ``paged_attention``'s window band: the plain version against
  ``paged_attention_pallas(..., window=w, interpret=True)`` on
  ``tests/test_kernels.py``'s window case and on a chunk and a decode whose
  window lies more than a block inside ``kv_len`` (2e-5); the model
  dispatch hands the window to the wrapper; ``attention_plan`` splits the
  band's walk, not the table's.
* The Mixtral-8x7B smoke model (window 16, float32, the JAX weights through
  ``from_jax_params``): a 40-token prompt through the ring cache of
  ``tests/test_decode_agreement.py``, chunked prefill into the ring with the
  last chunk padded, and decode, each step's logits within 1e-4 of the JAX
  model's and the same greedy tokens; the ring holds ``window`` rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core.pruner import precompute_scales as jprecompute
from repro.kernels.paged_attention import paged_attention_pallas
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import paged_attention as kpa
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import transformer as ttransformer
from repro_torch.weights import from_jax_params

ATOL = dict(rtol=2e-5, atol=2e-5)     # float32 attention: summation order only
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------------------ models.attention

# (T, S, window, q_offset, kv_len, kv_positions, causal, chunk)
RING = np.array([32, 33, 34, 35, 36, 37, 38, 39, 24, 25, 26, 27, 28, 29, 30, 31], np.int32)
CASES = {
    # a ring chunk: [old ring (positions wrapped) ∥ fresh chunk, pad rows -1]
    "ring_chunk": (8, 24, 16, 40, None,
                   np.concatenate([RING, [40, 41, 42, 43, 44, 45, -1, -1]]), True, 8),
    # a ring that was never filled: -1 rows
    "ring_cold": (8, 24, 16, 6, None,
                  np.concatenate([[0, 1, 2, 3, 4, 5], [-1] * 10, [6, 7, 8, 9, 10, 11, 12, 13]]),
                  True, 16),
    # windowed chunk over a full cache at an offset, ragged kv_len
    "offset_window": (8, 48, 12, 30, np.array([38, 35], np.int32), None, True, 16),
    # decode: each row at its own position, window inside kv_len
    "decode_rows": (1, 48, 10, np.array([40, 17], np.int32), np.array([41, 18], np.int32),
                    None, False, 16),
    # T > window from position 0 through the KV-chunk loop (kv_len given)
    "long_window": (40, 40, 16, 0, np.array([40, 33], np.int32), None, True, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_attention_matches_jax(case):
    t, s, window, qoff, kvl, kvpos, causal, chunk = CASES[case]
    q, k, v = _normal(1, 2, t, 4, 16), _normal(2, 2, s, 2, 16), _normal(3, 2, s, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)

    def args(arr, to):
        return None if arr is None else to(arr)

    want = jattn.attention(jq, jk, jv, causal=causal, window=window,
                           q_offset=jnp.asarray(qoff, jnp.int32), kv_len=args(kvl, jnp.asarray),
                           kv_positions=args(kvpos, jnp.asarray), chunk=chunk)
    got = tattn.attention(tq, tk, tv, causal=causal, window=window,
                          q_offset=torch.as_tensor(np.asarray(qoff, np.int32)),
                          kv_len=args(kvl, torch.from_numpy),
                          kv_positions=args(kvpos, torch.from_numpy), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


@pytest.mark.parametrize("t,window,chunk", [(40, 16, 8), (37, 16, 8), (64, 24, 16),
                                            (20, 32, 8), (33, 7, 10)])
def test_banded_attention_matches_jax(t, window, chunk):
    """The Q-chunk slab scan alone (pre-scaled grouped q), and through
    ``attention``'s whole-sequence sliding-window case."""
    q, k, v = _normal(4, 2, t, 4, 16), _normal(5, 2, t, 2, 16), _normal(6, 2, t, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    qg = q.reshape(2, t, 2, 2, 16) * 16**-0.5
    want = jattn._banded_attention(jnp.asarray(qg), jk, jv, min(window, t), chunk)
    got = tattn._banded_attention(torch.from_numpy(qg), tk, tv, min(window, t), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    want = jattn.attention(jq, jk, jv, causal=True, window=window, chunk=chunk)
    got = tattn.attention(tq, tk, tv, causal=True, window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


def test_flash_window_on_the_cpu_matches_the_banded_loop():
    """``impl="flash"`` (the kernel's plain version on the CPU) and the
    banded loop agree at T > window, as the JAX package's pair do."""
    q, k, v = _normal(7, 2, 48, 4, 16), _normal(8, 2, 48, 2, 16), _normal(9, 2, 48, 2, 16)
    _, (tq, tk, tv) = _both(q, k, v)
    flash = tattn.attention(tq, tk, tv, causal=True, window=16, impl="flash")
    banded = tattn.attention(tq, tk, tv, causal=True, window=16, chunk=8)
    np.testing.assert_allclose(flash.numpy(), banded.numpy(), **ATOL)


# -------------------------------------------------------- the paged window band

def _paged_inputs(nb=10, bs=8, mb=6, b=3, hkv=2, hd=16, seed=0):
    """``tests/test_kernels.py:_paged_inputs``'s layout: permuted tables with
    -1 tails, physical block 0 unreferenced."""
    kp, vp = _normal(seed, nb, bs, hkv, hd), _normal(seed + 1, nb, bs, hkv, hd)
    tab = np.full((b, mb), -1, np.int32)
    perm = np.random.default_rng(7).permutation(np.arange(1, nb))
    tab[0, :3] = perm[:3]
    tab[1, :5] = perm[3:8]
    tab[2, :2] = perm[8:10][:2] if len(perm) > 9 else perm[-2:]
    return kp, vp, tab


def _paged_pair(q, kp, vp, tab, qoff, kvl, causal, window, block_q):
    want = paged_attention_pallas(*[jnp.asarray(a) for a in (q, kp, vp, tab, qoff, kvl)],
                                  causal=causal, window=window, block_q=block_q,
                                  interpret=True)
    got = kpa.paged_attention_plain(*[torch.from_numpy(a) for a in (q, kp, vp, tab, qoff, kvl)],
                                    causal=causal, window=window)
    return got.numpy(), np.asarray(want)


def test_paged_window_matches_pallas_on_the_kernel_tests_case():
    """``tests/test_kernels.py::test_paged_attention_kernel_window_parity``:
    q (3, 8, 4, 16), offsets (13, 30, 5), kv_len (21, 38, 13), window 6."""
    kp, vp, tab = _paged_inputs()
    q = _normal(3, 3, 8, 4, 16)
    got, want = _paged_pair(q, kp, vp, tab, np.array([13, 30, 5], np.int32),
                            np.array([21, 38, 13], np.int32), True, 6, 4)
    np.testing.assert_allclose(got, want, **ATOL)


@pytest.mark.parametrize("name", ["chunk", "decode"])
def test_paged_window_more_than_a_block_inside_kv_len(name):
    """A chunk and a decode step whose band starts blocks past the table's
    first entries (window 10 against kv_len up to 44, block 8): the blocks
    below it contribute nothing."""
    kp, vp, _ = _paged_inputs(nb=14)
    tab = np.array([[3, 7, 1, 12, 5, 9], [2, 11, 6, 13, 4, -1]], np.int32)
    if name == "chunk":
        q, qoff, kvl, causal, bq = (_normal(11, 2, 8, 4, 16), np.array([36, 24], np.int32),
                                    np.array([44, 32], np.int32), True, 8)
    else:
        q, qoff, kvl, causal, bq = (_normal(12, 2, 1, 4, 16), np.array([43, 30], np.int32),
                                    np.array([44, 31], np.int32), False, 1)
    got, want = _paged_pair(q, kp, vp, tab, qoff, kvl, causal, 10, bq)
    np.testing.assert_allclose(got, want, **ATOL)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["gather", "kernel"])
def test_paged_attention_dispatch_takes_the_window(use_kernel):
    """``models.attention.paged_attention`` hands its window to the kernel
    wrapper (the plain version on the CPU) instead of raising; both routes
    equal the JAX gather oracle with the same window."""
    kp, vp, tab = _paged_inputs()
    q = _normal(3, 3, 8, 4, 16)
    qoff, kvl = np.array([13, 30, 5], np.int32), np.array([21, 38, 13], np.int32)
    want = jattn.paged_attention(*[jnp.asarray(a) for a in (q, kp, vp, tab)], causal=True,
                                 window=6, q_offset=jnp.asarray(qoff), kv_len=jnp.asarray(kvl),
                                 chunk=32, use_kernel=False)
    got = tattn.paged_attention(*[torch.from_numpy(a) for a in (q, kp, vp, tab)], causal=True,
                                window=6, q_offset=torch.from_numpy(qoff),
                                kv_len=torch.from_numpy(kvl), chunk=32, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


def test_attention_plan_splits_the_band():
    """Mixtral's decode over a 6144-row table with window 4096: the wgmma
    walk counts the band's 65 key tiles, not the table's 96, and its splits
    cover them; the chunk stays unsplit; no window leaves every plan as
    it was."""
    args = (torch.bfloat16, 4, 1, 32, 8, 128, 16, 384, True)
    full = kpa.attention_plan(*args, sms=132)
    band = kpa.attention_plan(*args, sms=132, window=4096)
    assert full == kpa.attention_plan(*args, sms=132, window=0)
    assert band[0] == "wgmma" and band[2] * band[3] >= 65 > (band[2] - 1) * band[3]
    assert full[2] * full[3] >= 96
    assert kpa.attention_plan(torch.bfloat16, 1, 256, 32, 8, 128, 16, 384, True, sms=132,
                              window=4096)[2] == 1
    rows = kpa.attention_plan(torch.float32, 4, 1, 32, 8, 128, 16, 384, True, sms=132,
                              window=4096)
    assert rows[0] == "rows" and rows[2] * rows[3] >= 4096 // 16 + 1


# ------------------------------------------------------------------ the model

def test_mixtral_configs_copy_the_jax_ones():
    from repro.configs.base import get_config as jget_config
    assert dataclasses.asdict(tget("mixtral_8x7b")) == dataclasses.asdict(
        get_smoke_config("mixtral_8x7b"))
    assert dataclasses.asdict(tget_config("mixtral_8x7b")) == dataclasses.asdict(
        jget_config("mixtral_8x7b"))


@pytest.fixture(scope="module")
def mixtral():
    """(JAX cfg, port cfg, JAX model, JAX params), float32."""
    cfg = dataclasses.replace(get_smoke_config("mixtral_8x7b"), dtype="float32")
    jm = jbuild(cfg)
    return cfg, dataclasses.replace(tget("mixtral_8x7b"), dtype="float32"), jm, \
        jm.init(jax.random.PRNGKey(0))


TOKS = np.random.default_rng(1).integers(0, 256, size=(2, 44)).astype(np.int32)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", ["dense", "paper_8_16"])
def test_ring_prefill_and_decode_match_jax(mixtral, name, use_kernels):
    """A 40-token prompt (window 16) through one-shot prefill into the ring,
    then 4 greedy decode steps: every logit row within 1e-4 of the JAX
    model's, the same greedy tokens, and 16-row rings."""
    cfg, tcfg, jm, params = mixtral
    jpol = jpolicy.DENSE if name == "dense" else jpolicy.paper_policy(8, 16)
    tpol = (tpolicy.DENSE if name == "dense" else tpolicy.paper_policy(8, 16)).with_(
        use_kernels=use_kernels)
    jp = jprecompute(params, jpol)
    tm = build_model(tcfg, device="cpu")
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jcache, tcache = jm.init_cache(2, 48), tm.init_cache(2, 48)
    assert "block_table" not in tcache
    assert all(leaf.shape == (2, cfg.window, 2, 16) for layer in tcache["layers"]
               for leaf in layer.values())
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(TOKS[:, :40])}, jcache, policy=jpol)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(TOKS[:, :40])}, tcache,
                            policy=tpol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for _ in range(4):
        jtok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(tl, dim=-1).numpy(), jtok[:, 0])
        jl, jcache = jm.decode_step(jp, jnp.asarray(jtok), jcache, policy=jpol)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(jtok), tcache, policy=tpol)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert int(tcache["pos"]) == 44


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_ring_chunked_prefill_matches_jax(mixtral, use_kernels):
    """A 37-token prompt in chunks of 8 (the last padded to 8) into a
    16-row ring, then decode: the JAX model's logits at every step."""
    cfg, tcfg, jm, params = mixtral
    jpol = jpolicy.paper_policy(8, 16)
    jp = jprecompute(params, jpol)
    tm = build_model(tcfg, device="cpu")
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tpol = tpolicy.paper_policy(8, 16).with_(use_kernels=use_kernels)
    jcache, tcache = jm.init_cache(1, 48), tm.init_cache(1, 48)
    prompt = TOKS[0, :37]
    for s in range(0, 37, 8):
        part = prompt[s:s + 8]
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :len(part)] = part
        jl, jcache = jm.prefill_chunk(jp, {"tokens": jnp.asarray(chunk),
                                           "chunk_len": jnp.asarray(len(part), jnp.int32)},
                                      jcache, policy=jpol)
        tl, tcache = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(chunk),
                                           "chunk_len": torch.tensor(len(part),
                                                                     dtype=torch.int32)},
                                      tcache, policy=tpol)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for _ in range(3):
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        assert int(torch.argmax(tl, dim=-1)[0]) == int(tok[0, 0])
        jl, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache, policy=jpolicy.DENSE)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache, policy=tpolicy.DENSE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    # the rings hold the same rows as the JAX model's (positions 24..39)
    jk = np.asarray(jax.tree_util.tree_leaves(jcache["periods"])[0])
    np.testing.assert_allclose(tcache["layers"][0]["k"].numpy(), jk[0], **MODEL_TOL)


def test_forward_matches_jax_and_the_ring(mixtral):
    """The full-sequence pass (banded prefill at T = 44 > 16) against the
    JAX model's; prefill + decode reproduce it
    (``tests/test_decode_agreement.py:50`` on the port)."""
    cfg, tcfg, jm, params = mixtral
    tm = build_model(tcfg, device="cpu")
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    want = np.asarray(jm.forward(params, {"tokens": jnp.asarray(TOKS)}, policy=jpolicy.DENSE,
                                 phase="prefill"))
    got = tm.forward(tp, {"tokens": torch.from_numpy(TOKS)}, phase="prefill").numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    cache = tm.init_cache(1, 48)
    tl, cache = tm.prefill(tp, {"tokens": torch.from_numpy(TOKS[:1, :40])}, cache)
    errs = [float(np.abs(tl.numpy() - got[:1, 39]).max())]
    for i in range(2):
        tl, cache = tm.decode_step(tp, torch.from_numpy(TOKS[:1, 40 + i:41 + i]), cache)
        errs.append(float(np.abs(tl.numpy() - got[:1, 40 + i]).max()))
    assert max(errs) < 5e-3, errs


def test_swa_is_never_paged():
    """``paged_kv_spec`` marks sliding-window K/V leaves False; ``init_cache``
    takes the dense layout for them and refuses a paged one, and a
    full-attention model takes the dense layout only when asked."""
    cfg = tget("mixtral_8x7b")
    assert not ttransformer.pools_anything(cfg)
    assert ttransformer.paged_kv_spec(cfg)["layers"][0] == {"k": False, "v": False}
    with pytest.raises(ValueError):
        ttransformer.init_cache(cfg, 1, 32, device="cpu", paged=True)
    llama = tget("llama31_8b")
    assert "block_table" in ttransformer.init_cache(llama, 1, 32, device="cpu")
    dense = ttransformer.init_cache(llama, 2, 32, device="cpu", paged=False)
    assert "block_table" not in dense and dense["layers"][0]["k"].shape == (2, 32, 2, 16)
