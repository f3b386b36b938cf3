"""The port's kernel wrappers against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels run in interpret mode (as the JAX package's own
tests run them) and against their jnp oracles.  The CUDA kernels themselves
run only on a GPU: ``tests/test_torch_cuda.py`` compares each with its plain
version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas, paged_kv_scatter_pallas
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import nm_prune_matmul as knm
from repro_torch.kernels import paged_attention as kpa
from repro_torch.models import attention as tattn

# float32: the products agree up to summation order
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# ------------------------------------------------------- nm_prune_matmul

@pytest.mark.parametrize("t,d,n_out,n,m,scale,bias", [
    (37, 64, 48, 8, 16, True, True),
    (16, 128, 40, 2, 4, False, False),
    (5, 64, 24, 4, 8, True, False),
])
def test_nm_prune_matmul_matches_pallas_and_ref(t, d, n_out, n, m, scale, bias):
    x, w = _np(1, t, d), _np(2, d, n_out) * d**-0.5
    sc = np.abs(_np(3, d)) + 0.5 if scale else None
    b = _np(4, n_out) if bias else None
    got = knm.nm_prune_matmul(_t(x), _t(w), _t(sc), n, m, bias=_t(b)).numpy()
    pallas = np.asarray(jops.nm_prune_matmul(
        jnp.asarray(x), jnp.asarray(w), None if sc is None else jnp.asarray(sc), n, m,
        bias=None if b is None else jnp.asarray(b), interpret=True))
    ref = np.asarray(jref.nm_prune_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), None if sc is None else jnp.asarray(sc), n, m))
    if b is not None:
        ref = ref + b
    np.testing.assert_allclose(got, pallas, **F32)
    np.testing.assert_allclose(got, ref, **F32)
    assert knm.nm_prune_matmul.launches == 0      # CPU tensors never launch


# -------------------------------------------------------------- scatter

def _pools(seed, nb, bs, hkv, hd):
    rows = nb + 1                                  # + the sentinel row
    return _np(seed, rows, bs, hkv, hd), _np(seed + 1, rows, bs, hkv, hd)


SCATTER_CASES = {
    # chunk at an unaligned offset, partial chunk_len, a -1 block, and rows
    # running past the table width (mb * bs = 24)
    "prefill": dict(b=1, t=12, pos=[14], clen=[9],
                    tab=[[4, 2, -1]]),
    "decode": dict(b=3, t=1, pos=[5, 9, 23], clen=[1, 1, 1],
                   tab=[[0, 3, -1], [-1, -1, -1], [1, 5, 6]]),
    "past_table": dict(b=1, t=8, pos=[20], clen=[8], tab=[[0, 1, 2]]),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_paged_kv_scatter_bit_exact(case):
    c = SCATTER_CASES[case]
    nb, bs, hkv, hd = 7, 8, 2, 16
    kp, vp = _pools(10, nb, bs, hkv, hd)
    kn, vn = _np(12, c["b"], c["t"], hkv, hd), _np(13, c["b"], c["t"], hkv, hd)
    tab = np.asarray(c["tab"], np.int32)
    pos, clen = np.asarray(c["pos"], np.int32), np.asarray(c["clen"], np.int32)

    k_t, v_t = _t(kp.copy()), _t(vp.copy())
    kpa.paged_kv_scatter(_t(kn), _t(vn), k_t, v_t, _t(tab), _t(pos), _t(clen))
    k_o, v_o = tattn.paged_kv_update(_t(kp.copy()), _t(vp.copy()), _t(kn), _t(vn),
                                     _t(tab), _t(pos), _t(clen))
    jk, jv = jattn.paged_kv_update(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn),
                                   jnp.asarray(vn), jnp.asarray(tab), jnp.asarray(pos),
                                   jnp.asarray(clen), use_kernel=False)
    pk, pv = paged_kv_scatter_pallas(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(tab), jnp.asarray(pos),
                                     jnp.asarray(clen), interpret=True)
    for got in ((k_t, v_t), (k_o, v_o)):
        for a, want in zip(got, (jk, jv)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(pk))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(pv))


# ------------------------------------------------------------ attention

def _attn_inputs(seed=3):
    nb, bs, mb, B, Hq, Hkv, hd = 12, 8, 6, 3, 4, 2, 16
    kp, vp = _np(seed, nb, bs, Hkv, hd), _np(seed + 1, nb, bs, Hkv, hd)
    tab = np.full((B, mb), -1, np.int32)
    tab[0, :3] = [5, 1, 8]
    tab[1, :5] = [3, 9, 2, 7, 4]
    tab[2, :2] = [6, 10]
    return kp, vp, tab, B, Hq, hd


ATTN_CASES = {
    "prefill": dict(t=8, causal=True, q_offset=[13, 13, 13], kv_len=[21, 38, 15]),
    "decode": dict(t=1, causal=False, q_offset=[20, 37, 10], kv_len=[21, 38, 11]),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan-block0"])
def test_paged_attention_matches_pallas_and_oracle(case, poison):
    """GQA (Hq=4 over Hkv=2), chunked prefill at an offset and vector-position
    decode; ``nan-block0`` poisons the block every -1 entry clips to, as
    ``tests/test_paged_kv.py`` does for the JAX package: the outputs must stay
    finite and unchanged."""
    c = ATTN_CASES[case]
    kp, vp, tab, B, Hq, hd = _attn_inputs()
    q = _np(7, B, c["t"], Hq, hd)
    clean = kpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tab),
                                _t(np.int32(c["q_offset"])), _t(np.int32(c["kv_len"])),
                                causal=c["causal"]).numpy()
    if poison:
        kp, vp = kp.copy(), vp.copy()
        kp[0], vp[0] = np.nan, np.nan
    qo, kvl = np.asarray(c["q_offset"], np.int32), np.asarray(c["kv_len"], np.int32)
    got = kpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tab), _t(qo), _t(kvl),
                              causal=c["causal"]).numpy()
    oracle = tattn.paged_attention(_t(q), _t(kp), _t(vp), _t(tab), causal=c["causal"],
                                   q_offset=_t(qo), kv_len=_t(kvl), chunk=16).numpy()
    jq, jk, jv, jt = (jnp.asarray(a) for a in (q, kp, vp, tab))
    joracle = np.asarray(jattn.paged_attention(
        jq, jk, jv, jt, causal=c["causal"], q_offset=jnp.asarray(qo),
        kv_len=jnp.asarray(kvl), chunk=16, use_kernel=False))
    pallas = np.asarray(paged_attention_pallas(
        jq, jk, jv, jt, jnp.asarray(qo), jnp.asarray(kvl), causal=c["causal"],
        block_q=c["t"], interpret=True))
    assert np.isfinite(got).all() and np.isfinite(oracle).all()
    np.testing.assert_array_equal(got, clean)
    for want in (oracle, joracle, pallas):
        np.testing.assert_allclose(got, want, **F32)


def test_fully_masked_rows_are_zero():
    kp, vp, tab, B, Hq, hd = _attn_inputs()
    q = _np(8, B, 4, Hq, hd)
    z = np.zeros(B, np.int32)
    out = kpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tab), _t(z), _t(z)).numpy()
    np.testing.assert_array_equal(out, 0.0)


def test_gather_kv_blocks_matches_reference():
    kp, _, tab, *_ = _attn_inputs()
    kp = kp.copy()
    kp[0] = np.nan
    got = tattn.gather_kv_blocks(_t(kp), _t(tab)).numpy()
    want = np.asarray(jattn.gather_kv_blocks(jnp.asarray(kp), jnp.asarray(tab)))
    np.testing.assert_array_equal(got, want)


def test_wrappers_reject_other_devices(monkeypatch):
    """A tensor on neither the CPU nor CUDA gets no silent plain-path
    answer: on ``meta`` (the dry-run) the wrapper is one unit, a ``meta``
    result of its shape with no plain version run and no launch counted,
    and the launch path refuses any tensor off CUDA."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(knm, "nm_prune_matmul_plain", boom)
    monkeypatch.setattr(knm, "_plain", boom)
    x = torch.zeros(4, 16, device="meta")
    w = torch.zeros(16, 8, device="meta")
    launches = knm.nm_prune_matmul.launches
    y = knm.nm_prune_matmul(x, w, None, 2, 4)
    assert y.is_meta and y.shape == (4, 8) and knm.nm_prune_matmul.launches == launches
    with pytest.raises(ValueError):
        knm._launch(x, w, None, 2, 4, None, with_keep=False)


# ------------------------------------------------- the attention plan

@pytest.mark.parametrize("case,args,route", [
    # (dtype, B, Tq, Hq, Hkv, hd, bs, mb, aligned) -> (route, nt, n_split, per)
    ("llama_chunk", (torch.bfloat16, 1, 256, 32, 8, 128, 16, 46, True), ("wgmma", 16, 1, 12)),
    ("llama_decode", (torch.bfloat16, 4, 1, 32, 8, 128, 16, 46, True), ("wgmma", 1, 4, 3)),
    ("qwen_decode", (torch.bfloat16, 4, 1, 28, 4, 128, 16, 34, True), ("wgmma", 1, 5, 2)),
    ("qwen_chunk", (torch.bfloat16, 1, 256, 28, 4, 128, 16, 34, True), ("wgmma", 9, 1, 9)),
    ("hd64_bs8", (torch.bfloat16, 2, 40, 8, 2, 64, 8, 12, True), ("wgmma", 16, 2, 1)),
    ("bs32", (torch.bfloat16, 1, 1, 8, 8, 128, 32, 4, True), ("wgmma", 1, 2, 1)),
    ("bs128", (torch.bfloat16, 1, 1, 8, 8, 128, 128, 4, True), ("wgmma", 1, 8, 1)),
    ("mha_g1", (torch.bfloat16, 1, 100, 8, 8, 128, 16, 8, True), ("wgmma", 64, 2, 1)),
    ("short_chunk_long_kv", (torch.bfloat16, 1, 16, 32, 8, 128, 16, 128, True),
     ("wgmma", 16, 4, 8)),
    ("decode_long_kv", (torch.bfloat16, 1, 1, 32, 8, 128, 16, 512, True), ("wgmma", 1, 16, 8)),
    ("float32", (torch.float32, 4, 1, 28, 4, 128, 16, 34, True), ("rows", 0, 9, 4)),
    ("float32_chunk", (torch.float32, 1, 256, 32, 8, 128, 16, 46, True), ("rows", 0, 1, 46)),
    ("hd32", (torch.bfloat16, 1, 40, 8, 2, 32, 16, 12, True), ("wgmma", 16, 3, 1)),
    ("hd256", (torch.bfloat16, 4, 1, 8, 2, 256, 16, 12, True), ("rows", 0, 3, 4)),
    ("bs12", (torch.bfloat16, 1, 40, 8, 2, 128, 12, 12, True), ("rows", 0, 1, 12)),
    ("bs48", (torch.bfloat16, 4, 1, 8, 2, 128, 48, 12, True), ("rows", 0, 3, 4)),
    ("bs4", (torch.bfloat16, 4, 1, 8, 2, 128, 4, 12, True), ("rows", 0, 3, 4)),
    ("misaligned", (torch.bfloat16, 1, 256, 32, 8, 128, 16, 46, False), ("rows", 0, 1, 46)),
    ("g128", (torch.bfloat16, 1, 4, 128, 1, 64, 16, 4, True), ("rows", 0, 1, 4)),
    ("hd96", (torch.bfloat16, 1, 256, 32, 8, 96, 16, 46, True), ("wgmma", 16, 1, 12)),
    ("hd8", (torch.bfloat16, 4, 1, 8, 2, 8, 16, 12, True), ("wgmma", 1, 3, 1)),
    ("hd36", (torch.bfloat16, 1, 40, 8, 2, 36, 16, 12, True), ("rows", 0, 1, 12)),
    ("float32_hd80", (torch.float32, 4, 1, 32, 32, 80, 16, 46, True), ("rows", 0, 12, 4)),
    ("hd256_chunk", (torch.bfloat16, 1, 256, 16, 16, 256, 16, 46, True), ("rows", 0, 1, 46)),
    ("hd136", (torch.bfloat16, 4, 1, 8, 2, 136, 16, 12, True), ("rows", 0, 3, 4)),
])
def test_attention_plan_routes(case, args, route):
    """Which shapes take the wgmma kernel (bf16, head_dim a multiple of 8 up
    to 128, a block size the TMA can box, 16-byte-aligned tensors, a GQA
    group that fits the 64 rows), on which head_dim tile (64 up to hd 64,
    else 128), and how it tiles and splits them (a split only where blocks
    are fewer than SMs, at most 16 and 256 / rows); the CUDA-core kernel
    takes the rest (float32, head_dim not a multiple of 8 or above 128),
    splitting a decode walk over a wide table."""
    plan = kpa.attention_plan(*args, sms=132)
    assert plan == route
    kind, nt, n_split, per = plan
    dtype, b, tq, hq, hkv, hd, bs, mb, _ = args
    assert plan.tile_hd == ((64 if hd <= 64 else 128) if kind == "wgmma" else 0)
    if kind == "wgmma":
        tiles = -(-mb * bs // 64)
        assert 1 <= nt <= tq and nt * (hq // hkv) <= 64
        assert n_split <= 16 and n_split * nt * (hq // hkv) <= max(256, nt * (hq // hkv))
        assert n_split * per >= tiles > (n_split - 1) * per        # no empty split
    else:
        assert n_split * per >= mb > (n_split - 1) * per


@pytest.mark.parametrize("case,args,plan", [
    # (dtype, hd, aligned) -> (route, tile width, consumer warpgroups)
    ("hd64", (torch.bfloat16, 64, True), ("wgmma", 64, 3)),
    ("hd32", (torch.bfloat16, 32, True), ("wgmma", 64, 3)),
    ("hd8", (torch.bfloat16, 8, True), ("wgmma", 64, 3)),
    ("hd128", (torch.bfloat16, 128, True), ("wgmma", 128, 2)),
    ("hd80", (torch.bfloat16, 80, True), ("wgmma", 128, 2)),
    ("hd72", (torch.bfloat16, 72, True), ("wgmma", 128, 2)),
    ("hd256", (torch.bfloat16, 256, True), ("wgmma", 256, 1)),
    ("hd136", (torch.bfloat16, 136, True), ("wgmma", 256, 1)),
    ("hd36", (torch.bfloat16, 36, True), ("rows", 0, 0)),
    ("hd250", (torch.bfloat16, 250, True), ("rows", 0, 0)),
    ("float32_hd80", (torch.float32, 80, True), ("rows", 0, 0)),
    ("float32_hd128", (torch.float32, 128, True), ("rows", 0, 0)),
    ("misaligned_hd80", (torch.bfloat16, 80, False), ("rows", 0, 0)),
])
def test_flash_plan_routes(case, args, plan):
    """``flash_attention``'s kernel: bf16 at a head_dim that is a multiple of
    8 with aligned tensors takes the wgmma kernel on the narrowest tile of
    64, 128 or 256 columns that holds it; float32, other head dims and
    misaligned tensors take the CUDA-core rows kernel."""
    got = kfa.flash_plan(*args)
    assert got == plan
    dtype, hd, _ = args
    if got[0] == "wgmma":
        assert hd <= got[1] and (got[1] == 64 or hd > got[1] // 2)


@pytest.mark.parametrize("window", [0, 5], ids=["full", "window5"])
@pytest.mark.parametrize("hq,hkv,hd", [(4, 4, 80), (10, 1, 256)], ids=["hd80", "hd256"])
def test_plain_attention_at_padded_head_dims_matches_pallas(hq, hkv, hd, window):
    """The plain versions the card holds the padded wgmma tiles against, at
    StableLM-3B's head_dim 80 (4 / 4 heads) and RecurrentGemma-2B's 256 (10
    query heads on one KV head), causal with and without a window band:
    ``flash_attention_plain`` against ``flash_attention_pallas`` and
    ``paged_attention_plain`` (a chunk at an offset with a -1 page, and
    decode) against ``paged_attention_pallas``, both in interpret mode."""
    b, t = 2, 64
    q, k, v = _np(11, b, t, hq, hd), _np(12, b, t, hkv, hd), _np(13, b, t, hkv, hd)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True, window=window)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    want = tr(flash_attention_pallas(tr(q), tr(k), tr(v), causal=True, window=window,
                                     block_q=32, block_k=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    nb, bs, mb = 12, 8, 6
    kp, vp = _np(14, nb, bs, hkv, hd), _np(15, nb, bs, hkv, hd)
    tab = np.full((b, mb), -1, np.int32)
    tab[0, :5] = [5, 1, -1, 8, 3]
    tab[1, :3] = [9, 2, 7]
    for tq, causal, qo, kvl in ((8, True, [30, 13], [38, 21]), (1, False, [36, 20], [37, 21])):
        qq = _np(16 + tq, b, tq, hq, hd)
        args = (qq, kp, vp, tab, np.int32(qo), np.int32(kvl))
        got = kpa.paged_attention_plain(*(_t(a) for a in args), causal=causal, window=window)
        want = paged_attention_pallas(*(jnp.asarray(a) for a in args), causal=causal,
                                      window=window, block_q=tq, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ------------------------- paged attention semantics of the wgmma route

def _paged_inputs(seed, b, hq, hkv, hd, bs, mb, tables, kv_len):
    """Pools whose rows no table row may read are NaN (unused blocks, rows at
    or past a row's kv_len, pages of -1 entries)."""
    nb = b * mb + 1
    kp, vp = _np(seed, nb, bs, hkv, hd), _np(seed + 1, nb, bs, hkv, hd)
    tab = np.asarray(tables, np.int32)
    live = np.zeros((nb, bs), bool)
    for r, n in enumerate(kv_len):
        for i in range(n):
            if tab[r, i // bs] >= 0:
                live[tab[r, i // bs], i % bs] = True
    kp[~live], vp[~live] = np.nan, np.nan
    return kp, vp, tab


WGMMA_SEMANTICS_CASES = {
    # G = 7 (Qwen2-7B's group), bs 16, a -1 hole in the middle of row 0,
    # row 1's kv_len on a page boundary (32), row 2 empty (kv_len 0)
    "g7_prefill": dict(hq=7, hkv=1, t=4, causal=True, q_offset=[40, 28, 0],
                       kv_len=[44, 32, 0],
                       tables=[[0, -1, 2, -1], [4, 5, -1, -1], [-1, -1, -1, -1]]),
    "g7_decode": dict(hq=7, hkv=1, t=1, causal=False, q_offset=[43, 31, 0],
                      kv_len=[44, 32, 0],
                      tables=[[0, -1, 2, -1], [4, 5, -1, -1], [-1, -1, -1, -1]]),
    # G = 4 over two KV heads, a hole at the first page: the first query
    # rows see no key at all
    "g4_hole_first": dict(hq=8, hkv=2, t=4, causal=True, q_offset=[0, 16, 5],
                          kv_len=[20, 48, 9],
                          tables=[[-1, 1, -1, -1], [4, 6, 5, -1], [8, -1, -1, -1]]),
}


@pytest.mark.parametrize("case", sorted(WGMMA_SEMANTICS_CASES))
def test_paged_attention_wgmma_cases_match_pallas(case):
    """The cases the wgmma route adds to the semantics, held against the
    Pallas kernel in interpret mode: a GQA group of 7, block size 16, a -1
    page in the middle of a table row, kv_len on a page boundary and kv_len
    = 0, over pools whose unreadable rows are NaN.  (The gather oracle is no
    reference here: it reads a -1 page below kv_len as zero keys, where both
    kernels skip it.)"""
    c = WGMMA_SEMANTICS_CASES[case]
    b, bs, mb, hd = 3, 16, 4, 16
    kp, vp, tab = _paged_inputs(11, b, c["hq"], c["hkv"], hd, bs, mb, c["tables"],
                                c["kv_len"])
    q = _np(13, b, c["t"], c["hq"], hd)
    qo, kvl = np.asarray(c["q_offset"], np.int32), np.asarray(c["kv_len"], np.int32)
    got = kpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tab), _t(qo), _t(kvl),
                              causal=c["causal"]).numpy()
    jq, jk, jv, jt = (jnp.asarray(a) for a in (q, kp, vp, tab))
    pallas = np.asarray(paged_attention_pallas(
        jq, jk, jv, jt, jnp.asarray(qo), jnp.asarray(kvl), causal=c["causal"],
        block_q=c["t"], interpret=True))
    assert np.isfinite(got).all() and np.isfinite(pallas).all()
    np.testing.assert_allclose(got, pallas, **F32)
    for r in range(b):      # kv_len = 0, or every visible key in a -1 page: zeros
        if c["kv_len"][r] == 0 or (case == "g4_hole_first" and r == 0):
            np.testing.assert_array_equal(got[r], 0.0)
