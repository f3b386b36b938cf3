"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU.  Every test here is marked ``cuda`` and skips without a card
(the kernels have no CPU form).  The file imports torch only, so it also
runs where JAX is not installed::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import nm_prune as knp
from repro_torch.kernels import nm_prune_matmul as knm
from repro_torch.kernels import nm_spmm as kns
from repro_torch.kernels import osparse_matmul as kos
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import w8a8_matmul as kw8

pytestmark = pytest.mark.cuda
# bf16 outputs: one bf16 ulp of the largest output; float32: summation order
TOL = {torch.bfloat16: 2.0**-7, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU form")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    assert bool(got.isfinite().all())
    assert float((got - want).abs().max()) <= TOL[dtype] * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,n_out,n,m", [(37, 128, 72, 8, 16), (256, 192, 200, 2, 4)])
def test_nm_prune_matmul(gen, dtype, t, d, n_out, n, m):
    x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(d, n_out, generator=gen, device="cuda") * d**-0.5).to(dtype)
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5
    b = torch.randn(n_out, generator=gen, device="cuda").to(dtype)
    _close(knm.nm_prune_matmul(x, w, sc, n, m, bias=b),
           knm.nm_prune_matmul_plain(x, w, sc, n, m, bias=b), dtype)


def _paged(gen, dtype, b, hkv, hd, bs, mb, kv_len):
    """Pools whose rows outside every row's kv_len are NaN, and a table
    giving each row its own blocks (-1 past what it needs)."""
    nb = b * mb
    kp = torch.randn(nb + 1, bs, hkv, hd, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb + 1, bs, hkv, hd, generator=gen, device="cuda").to(dtype)
    tab = torch.full((b, mb), -1, dtype=torch.int32)
    live = torch.zeros(nb + 1, bs, dtype=torch.bool)
    for r, n in enumerate(kv_len):
        need = -(-n // bs)
        tab[r, :need] = torch.arange(r * mb, r * mb + need, dtype=torch.int32)
        for i in range(n):
            live[int(tab[r, i // bs]), i % bs] = True
    live = live.cuda()
    kp[~live], vp[~live] = float("nan"), float("nan")
    return kp, vp, tab.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["decode_split", "prefill_flash", "prefill_small_head"])
def test_paged_attention(gen, dtype, case):
    """Decode over a wide table (the split walk + combine), a bf16 prefill
    chunk at an offset with head_dim 64 (the tensor-core path), and a
    head_dim the tensor-core path does not take — each against the plain
    version over NaN-poisoned pools."""
    hq, hkv, bs = 8, 2, 16
    hd = 32 if case == "prefill_small_head" else 64
    if case == "decode_split":
        b, tq, mb, kv_len, causal = 3, 1, 20, [300, 17, 1], False
        qoff = [k - 1 for k in kv_len]
    else:
        b, tq, mb, kv_len, causal = 1, 40, 12, [150], True
        qoff = [110]
    kp, vp, tab = _paged(gen, dtype, b, hkv, hd, bs, mb, kv_len)
    q = torch.randn(b, tq, hq, hd, generator=gen, device="cuda").to(dtype)
    qo = torch.tensor(qoff, dtype=torch.int32, device="cuda")
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    _close(kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=causal),
           kpa.paged_attention_plain(q, kp, vp, tab, qo, kvl, causal=causal), dtype)


def test_paged_kv_scatter_bit_exact(gen):
    kp, vp, tab = _paged(gen, torch.bfloat16, 3, 2, 64, 16, 6, [90, 20, 33])
    kp, vp = kp.nan_to_num(), vp.nan_to_num()
    tab[1, 2] = -1
    kn = torch.randn(3, 24, 2, 64, generator=gen, device="cuda").bfloat16()
    pos = torch.tensor([70, 20, 9], dtype=torch.int32, device="cuda")
    clen = torch.tensor([24, 13, 5], dtype=torch.int32, device="cuda")
    k_a, v_a, k_b, v_b = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    kpa.paged_kv_scatter(kn, kn, k_a, v_a, tab, pos, clen)
    kpa.paged_kv_scatter_plain(kn, kn, k_b, v_b, tab, pos, clen)
    assert torch.equal(k_a, k_b) and torch.equal(v_a, v_b)


# The int8 paths are exact: kernel and plain version agree bit for bit.

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_token", [False, True], ids=["tensor", "token"])
@pytest.mark.parametrize("prune", [False, True], ids=["dense", "prune"])
@pytest.mark.parametrize("t,d,n_out,n,m", [
    (37, 128, 72, 8, 16),        # ragged T, one column tile
    (4, 2048, 1024, 8, 16),      # decode: split-k with int32 atomics
    (70, 200, 200, 2, 4),        # D and N not multiples of 16: byte staging
])
def test_osparse_matmul_bit_exact(gen, dtype, per_token, prune, t, d, n_out, n, m):
    x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    w = torch.randn(d, n_out, generator=gen, device="cuda") * d**-0.5
    absmax = torch.rand(d, generator=gen, device="cuda") * 3 + 0.5
    absmax[:4] *= 11
    ql = quant.make_quantized_linear(w, absmax, quant.QuantConfig())
    amber = torch.rand(d, generator=gen, device="cuda") + 0.5
    bias = torch.randn(n_out, generator=gen, device="cuda").to(dtype)
    args = (ql.wq, ql.smooth, amber, ql.w_scale, n, m)
    kw = dict(act_scale=ql.act_scale, bias=bias, prune=prune, per_token=per_token)
    got = kos.osparse_matmul(x, *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, kos.osparse_matmul_plain(x, *args, **kw))
    q, s = kos.osparse_quantize(x, ql.smooth, amber, n, m, ql.act_scale, prune, per_token)
    q0, s0 = kos.osparse_quantize_plain(x, ql.smooth, amber, n, m, ql.act_scale, prune,
                                        per_token)
    assert torch.equal(q, q0) and torch.equal(s, s0)


@pytest.mark.parametrize("t,d,n_out", [(256, 512, 384), (3, 4096, 512), (33, 80, 130)])
def test_w8a8_matmul_bit_exact(gen, t, d, n_out):
    xq = torch.randint(-127, 128, (t, d), generator=gen, device="cuda").to(torch.int8)
    wq = torch.randint(-127, 128, (d, n_out), generator=gen, device="cuda").to(torch.int8)
    ws = torch.rand(n_out, generator=gen, device="cuda") * 0.01
    xs = torch.tensor(0.013, device="cuda")
    got = kw8.w8a8_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, kw8.w8a8_matmul_plain(xq, wq, xs, ws))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,n,m", [(37, 128, 8, 16), (256, 192, 2, 4)])
def test_nm_prune_bit_exact(gen, dtype, t, d, n, m):
    x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5
    for scale in (sc, None):
        got = knp.nm_prune(x, scale, n, m)
        torch.cuda.synchronize()
        assert torch.equal(got, knp.nm_prune_plain(x, scale, n, m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["causal", "ragged", "window", "noncausal", "head_dim_32"])
def test_flash_attention(gen, dtype, case):
    """GQA 7:1 as in Qwen2-7B; a ragged T the 64-row tiles do not divide; a
    causal window band (key blocks below it skipped); non-causal; a head
    size the tensor-core path does not take."""
    b, hq, hkv, t, hd = 2, 14, 2, 200, 64
    causal, window = case != "noncausal", 48 if case == "window" else 0
    if case == "ragged":
        t = 77
    if case == "head_dim_32":
        hd = 32
    q = torch.randn(b, t, hq, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").to(dtype)
    _close(kfa.flash_attention(q, k, v, causal=causal, window=window),
           kfa.flash_attention_plain(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,n_out,n,m,tile", [
    (600, 256, 200, 8, 16, 256),      # ragged last tile, N not a multiple of 128
    (37, 96, 72, 2, 4, 256),          # one tile shorter than 64 rows
    (130, 120, 48, 3, 8, 40),         # a tile that is not a multiple of 64 rows
])
def test_nm_spmm(gen, dtype, t, d, n_out, n, m, tile):
    """The consensus selection bit-exact against the plain version's (kept
    channel ids and compacted x), the product within rounding."""
    x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(d, n_out, generator=gen, device="cuda") * d**-0.5).to(dtype)
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5
    for scale in (sc, None):
        idx, xc = kns.consensus_select(x, scale, n, m, tile)
        idx0, xc0 = kns.consensus_select_plain(x, scale, n, m, tile)
        torch.cuda.synchronize()
        assert torch.equal(idx, idx0) and torch.equal(xc, xc0)
        _close(kns.nm_spmm(x, w, scale, n, m, tile),
               kns.nm_spmm_plain(x, w, scale, n, m, tile), dtype)
