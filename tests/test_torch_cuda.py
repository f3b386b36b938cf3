"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU.  Every test here is marked ``cuda`` and skips without a card
(the kernels have no CPU form).  The file imports torch only, so it also
runs where JAX is not installed::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import ctypes

import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import _build
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


# The wgmma building blocks (csrc/hopper.cuh) against torch.matmul, through
# the test-only entry point of csrc/nm_prune_matmul.cu.

def _probe(a, b, mode):
    fn = _build.load("nm_prune_matmul.cu").wgmma_probe_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.full((a.shape[0], b.shape[1]), float("nan"), device="cuda")
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), mode, a.shape[0], a.shape[1],
            b.shape[1], torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    return out


def test_wgmma_single_product(gen):
    """One m64n128k16 wgmma: A K-major and B MN-major in the 128-byte swizzle,
    the accumulator's fragment map.  Products of bf16 are exact in float32,
    so only the order of a 16-term sum differs."""
    a = torch.randn(64, 16, generator=gen, device="cuda").bfloat16()
    b = torch.randn(16, 128, generator=gen, device="cuda").bfloat16()
    _close(_probe(a, b, 0), a.float() @ b.float(), torch.float32)


@pytest.mark.parametrize("m,k,n", [(64, 64, 128), (300, 1000, 264)])
def test_wgmma_pipelined_k_loop(gen, m, k, n):
    """The wgmma GEMM's TMA ring and k loop in one slice: ragged M, a K that
    is not a multiple of the 64-wide k step, an N past the last 128 tile."""
    a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    b = (torch.randn(k, n, generator=gen, device="cuda") * k**-0.5).bfloat16()
    _close(_probe(a, b, 1), a.float() @ b.float(), torch.float32)


def _misaligned(t):
    """A contiguous copy of ``t`` whose storage starts 2 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case,t,d,n_out,route", [
    ("q", 256, 4096, 4096, "split"),
    ("gate", 256, 4096, 14336, "wgmma"),
    ("down", 256, 14336, 4096, "split"),
    ("q_ragged", 137, 4096, 4096, "split"),
    ("gate_ragged", 137, 4096, 14336, "wgmma"),
    ("n_edge", 200, 512, 200, "wgmma"),
    ("n_edge_split", 137, 2048, 200, "split"),
    ("w_misaligned", 137, 512, 256, "wmma"),
    ("n_odd", 70, 256, 130, "wmma"),
])
def test_nm_prune_matmul_routes(gen, case, t, d, n_out, route):
    """Every route of the bf16 dispatcher against the plain version: the
    wgmma kernel in one slice or split along k (float32 partials, ordered
    reduce), and the WMMA kernel for a w the TMA cannot take."""
    n, m = 8, 16
    x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(d, n_out, generator=gen, device="cuda") * d**-0.5).bfloat16()
    if case == "w_misaligned":
        w = _misaligned(w)
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5
    b = torch.randn(n_out, generator=gen, device="cuda").bfloat16()
    plan = knm.gemm_plan(w, t)
    assert {"wmma": plan == 0, "wgmma": plan == 1, "split": plan > 1}[route], plan
    for bias in (None, b):
        _close(knm.nm_prune_matmul(x, w, sc, n, m, bias=bias),
               knm.nm_prune_matmul_plain(x, w, sc, n, m, bias=bias), torch.bfloat16)


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
# Every route of gemm_plan (swap_fused / swap at T <= 16, wgmma above, the
# simple dp4a route where D is not a multiple of 16): T on both sides of 16
# and past a 256-row block, LLaMA-3.1-8B's widths and one that is not a
# multiple of the 128-column block, D = 4096 (k split 1-8 over a cluster).

_INT8_T = [1, 4, 16, 17, 37, 256, 300]
_INT8_N = [1024, 4096, 14336, 1000]


def _int8_linear(gen, d, n_out):
    w = torch.randn(d, n_out, generator=gen, device="cuda") * d**-0.5
    absmax = torch.rand(d, generator=gen, device="cuda") * 3 + 0.5
    absmax[:4] *= 11
    return quant.make_quantized_linear(w, absmax, quant.QuantConfig())


def _check_osparse(gen, ql, t, d, n_out, n, m):
    """All four per_token x prune modes, bf16 and float32 x, with and
    without bias: output, int8 codes and scales bit-identical to the plain
    versions, on the plan's route."""
    amber = torch.rand(d, generator=gen, device="cuda") + 0.5
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
        bias = torch.randn(n_out, generator=gen, device="cuda").to(dtype)
        for per_token in (False, True):
            for prune in (False, True):
                for b in (None, bias):
                    args = (ql.wq, ql.smooth, amber, ql.w_scale, n, m)
                    kw = dict(act_scale=ql.act_scale, bias=b, prune=prune,
                              per_token=per_token)
                    plan = kw8.gemm_plan(t, d, n_out, dtype, per_token, prune, m)
                    before = kos.osparse_matmul.route_launches[plan.route]
                    got = kos.osparse_matmul(x, *args, **kw)
                    torch.cuda.synchronize()
                    assert kos.osparse_matmul.route_launches[plan.route] == before + 1
                    case = (dtype, per_token, prune, b is not None, plan)
                    assert torch.equal(got, kos.osparse_matmul_plain(x, *args, **kw)), case
                q, s = kos.osparse_quantize(x, ql.smooth, amber, n, m, ql.act_scale, prune,
                                            per_token)
                q0, s0 = kos.osparse_quantize_plain(x, ql.smooth, amber, n, m,
                                                    ql.act_scale, prune, per_token)
                assert torch.equal(q, q0) and torch.equal(s, s0), (dtype, per_token, prune)


@pytest.mark.parametrize("n_out", _INT8_N)
@pytest.mark.parametrize("t", _INT8_T)
def test_osparse_matmul_bit_exact(gen, t, n_out):
    _check_osparse(gen, _int8_linear(gen, 4096, n_out), t, 4096, n_out, 8, 16)


@pytest.mark.parametrize("t,d,n_out,n,m,route", [
    (70, 200, 200, 2, 4, "simple"),        # D not a multiple of 16: the dp4a route
    (4, 200, 200, 2, 4, "simple"),
    (37, 128, 72, 8, 16, "wgmma"),         # one k step, one ragged column block
    (5, 4080, 512, 3, 6, "swap"),          # a group width the fused quantizer leaves
    (4, 96, 72, 2, 4, "swap_fused"),       # D short of one 128-byte k step
])
def test_osparse_matmul_routes_bit_exact(gen, t, d, n_out, n, m, route):
    assert kw8.gemm_plan(t, d, n_out, torch.bfloat16, False, True, m).route == route
    _check_osparse(gen, _int8_linear(gen, d, n_out), t, d, n_out, n, m)


@pytest.mark.parametrize("n_out", _INT8_N)
@pytest.mark.parametrize("t", _INT8_T)
def test_w8a8_matmul_bit_exact(gen, t, n_out):
    d = 4096
    xq = torch.randint(-127, 128, (t, d), generator=gen, device="cuda").to(torch.int8)
    wq = torch.randint(-127, 128, (n_out, d), generator=gen, device="cuda").to(torch.int8).t()
    ws = torch.rand(n_out, generator=gen, device="cuda") * 0.01
    xs = torch.tensor(0.013, device="cuda")
    plan = kw8.gemm_plan(t, d, n_out, torch.int8)
    assert plan.route == ("swap" if t <= 16 else "wgmma")
    got = kw8.w8a8_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, kw8.w8a8_matmul_plain(xq, wq, xs, ws))


@pytest.mark.parametrize("t,d,n_out", [(33, 80, 130), (33, 200, 130), (3, 14336, 512),
                                       (3, 80, 130)])
def test_w8a8_matmul_routes_bit_exact(gen, t, d, n_out):
    xq = torch.randint(-127, 128, (t, d), generator=gen, device="cuda").to(torch.int8)
    wq = torch.randint(-127, 128, (n_out, d), generator=gen, device="cuda").to(torch.int8).t()
    ws = torch.rand(n_out, generator=gen, device="cuda") * 0.01
    xs = torch.tensor(0.013, device="cuda")
    got = kw8.w8a8_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, kw8.w8a8_matmul_plain(xq, wq, xs, ws))


def test_int8_gemms_raise_on_n_major_wq(gen):
    """wq stored N-major (the JAX package's layout) is refused on the card:
    the wrappers never transpose the weights at each call."""
    xq = torch.zeros((4, 256), dtype=torch.int8, device="cuda")
    wq = torch.zeros((256, 512), dtype=torch.int8, device="cuda")
    ws = torch.ones(512, device="cuda")
    with pytest.raises(ValueError, match="K-major"):
        kw8.w8a8_matmul(xq, wq, torch.tensor(1.0, device="cuda"), ws)
    ql = _int8_linear(gen, 256, 512)
    with pytest.raises(ValueError, match="K-major"):
        kos.osparse_matmul(torch.randn(4, 256, device="cuda"), ql.wq.contiguous(), ql.smooth,
                           None, ql.w_scale, 8, 16, act_scale=ql.act_scale)
    assert quant.k_major(ql.wq) is ql.wq


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
@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (8, 16), (3, 8), (5, 32), (2, 6)])
@pytest.mark.parametrize("aligned", [True, False], ids=["vector", "offset"])
def test_nm_prune_bit_exact_group_widths(gen, dtype, n, m, aligned):
    """The vectorised selection at each group width it takes (and m = 6,
    which it does not), and an x 2 bytes off a 16-byte boundary, which takes
    the one-thread-per-group kernel: both bit-exact."""
    x = torch.randn(64, 96 * m, generator=gen, device="cuda").to(dtype)
    if not aligned:
        x = _misaligned(x)
    sc = torch.rand(96 * m, generator=gen, device="cuda") + 0.5
    for scale in (sc, None):
        got = knp.nm_prune(x, scale, n, m)
        torch.cuda.synchronize()
        assert torch.equal(got, knp.nm_prune_plain(x, scale, n, m))


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("case,t,causal,window", [
    ("causal", 300, True, 0),
    ("one_tile", 40, True, 0),
    ("noncausal", 300, False, 0),
    ("window", 300, True, 100),
    ("noncausal_window", 200, False, 64),
    ("long", 512, True, 0),
])
def test_flash_attention_wgmma(gen, hd, case, t, causal, window):
    """The bf16 wgmma kernel at both head sizes it takes, GQA 7:1: T not a
    multiple of the 128-row block, a T shorter than one key tile, causal,
    non-causal and windowed bands."""
    b, hq, hkv = 2, 14, 2
    q = torch.randn(b, t, hq, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").bfloat16()
    _close(kfa.flash_attention(q, k, v, causal=causal, window=window),
           kfa.flash_attention_plain(q, k, v, causal=causal, window=window), torch.bfloat16)


def test_flash_attention_misaligned_takes_rows_path(gen):
    q = _misaligned(torch.randn(1, 70, 14, 64, generator=gen, device="cuda").bfloat16())
    k = torch.randn(1, 70, 2, 64, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, 70, 2, 64, generator=gen, device="cuda").bfloat16()
    _close(kfa.flash_attention(q, k, v), kfa.flash_attention_plain(q, k, v), torch.bfloat16)


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


# The wgmma routes of nm_spmm and paged_attention (their plans, the kernels
# against the plain versions).

@pytest.mark.parametrize("case,t,d,n_out,n,m,tile,route", [
    ("q_2048", 2048, 3584, 3584, 8, 16, 256, ("wgmma", 256, 1)),
    ("q_300_split", 300, 3584, 3584, 8, 16, 256, ("wgmma", 256, 2)),
    ("t37_short_tile", 37, 256, 200, 8, 16, 256, ("wgmma", 128, 1)),
    ("tile100", 300, 640, 264, 8, 16, 100, ("wgmma", 128, 1)),
    ("tile5_kc48", 37, 96, 72, 2, 4, 5, ("wgmma", 128, 1)),
    ("down_like_long_k", 2048, 18944, 2048, 8, 16, 256, ("wgmma", 256, 1)),
    ("down_like_split", 256, 18944, 512, 8, 16, 256, ("wgmma", 256, 8)),
    ("kc45_wmma", 130, 120, 48, 3, 8, 40, ("wmma", 64, 1)),
])
def test_nm_spmm_routes(gen, case, t, d, n_out, n, m, tile, route):
    """Each route of the bf16 GEMM as the plan gives it: the wgmma kernel
    with 256- and 128-row blocks (tiles of 256, 100 and 5 tokens, a tile
    shorter than its block, a kept width G*n that is not a multiple of the
    64-wide k step, a down-like K of 9472 kept channels), split along k
    into float32 partials, and the WMMA kernel for a kept width that is not
    a multiple of 8.  The selection is bit-exact, the product within one
    bf16 ulp."""
    x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(d, n_out, generator=gen, device="cuda") * (d * n / m)**-0.5).bfloat16()
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5
    assert kns.gemm_plan(x.dtype, t, d, n_out, n, m, tile, True,
                         torch.cuda.get_device_properties(0).multi_processor_count) == route
    idx, xc = kns.consensus_select(x, sc, n, m, tile)
    idx0, xc0 = kns.consensus_select_plain(x, sc, n, m, tile)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx0) and torch.equal(xc, xc0)
    _close(kns.nm_spmm(x, w, sc, n, m, tile), kns.nm_spmm_plain(x, w, sc, n, m, tile),
           torch.bfloat16)


def test_nm_spmm_misaligned_w_takes_wmma(gen):
    x = torch.randn(300, 512, generator=gen, device="cuda").bfloat16()
    w = _misaligned((torch.randn(512, 256, generator=gen, device="cuda") * 0.06).bfloat16())
    assert kns.gemm_plan(x.dtype, 300, 512, 256, 8, 16, 256, w.data_ptr() % 16 == 0)[0] == "wmma"
    _close(kns.nm_spmm(x, w, None, 8, 16), kns.nm_spmm_plain(x, w, None, 8, 16), torch.bfloat16)


def _paged_case(gen, b, tq, hq, hkv, hd, bs, kv_len, q_offset, holes=()):
    """Pools, table and queries where every pool row no table row may read is
    NaN; ``holes`` are (row, logical block) entries set to -1."""
    mb = max(-(-max(kv_len) // bs), 1) + 1
    kp, vp, tab = _paged(gen, torch.bfloat16, b, hkv, hd, bs, mb, kv_len)
    tab = tab.cpu()
    for r, i in holes:
        tab[r, i] = -1
    live = torch.zeros(kp.shape[:2], dtype=torch.bool)
    for r, n in enumerate(kv_len):
        for i in range(n):
            if int(tab[r, i // bs]) >= 0:
                live[int(tab[r, i // bs]), i % bs] = True
    live = live.cuda()
    kp[~live], vp[~live] = float("nan"), float("nan")
    q = torch.randn(b, tq, hq, hd, generator=gen, device="cuda").bfloat16()
    i32 = dict(dtype=torch.int32, device="cuda")
    return (q, kp, vp, tab.cuda(), torch.tensor(q_offset, **i32),
            torch.tensor(kv_len, **i32))


@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("hq,hkv,hd", [(32, 8, 128), (28, 4, 128), (14, 2, 64)],
                         ids=["g4", "g7", "g7_hd64"])
@pytest.mark.parametrize("case", ["chunk", "chunk_hole", "chunk_masked_tile", "decode",
                                  "decode_edges"])
def test_paged_attention_wgmma(gen, case, hq, hkv, hd, bs):
    """The wgmma route over NaN-poisoned pools at block sizes 8, 16 and 32,
    GQA groups of 4 and 7: a prefill chunk at an offset; a -1 page in the
    middle of a row; a query tile that sees only a -1 page (wholly masked,
    so zeros); decode rows with kv_len on a page boundary, 0 and 1."""
    if case == "chunk":
        args = (1, 100, [230], [130], ())
    elif case == "chunk_hole":
        args = (2, 70, [200, 150], [130, 80], ((0, 1), (1, 2)))
    elif case == "chunk_masked_tile":
        args = (1, 40, [40], [0], ((0, 0),))
    elif case == "decode":
        args = (4, 1, [701, 514, 65, 2], [700, 513, 64, 1], ())
    else:
        args = (3, 1, [4 * bs, 0, 1], [4 * bs - 1, 0, 0], ((0, 1),))
    b, tq, kv_len, qoff, holes = args
    q, kp, vp, tab, qo, kvl = _paged_case(gen, b, tq, hq, hkv, hd, bs, kv_len, qoff, holes)
    plan = kpa.attention_plan(q.dtype, b, tq, hq, hkv, hd, bs, tab.shape[1], True)
    assert plan[0] == "wgmma", plan
    causal = tq > 1
    got = kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=causal)
    want = kpa.paged_attention_plain(q, kp, vp, tab, qo, kvl, causal=causal)
    _close(got, want, torch.bfloat16)
    if case == "chunk_masked_tile":        # tokens 0..bs-1 see only the -1 page
        assert bool((got[0, :bs] == 0).all())
    if case == "decode_edges":             # kv_len = 0 gives zeros
        assert bool((got[1] == 0).all())


def test_paged_attention_wgmma_repeat_resets_tickets(gen):
    """The split walk's ticket counters end each launch at 0: the same call
    twice gives the same bits."""
    q, kp, vp, tab, qo, kvl = _paged_case(gen, 4, 1, 32, 8, 128, 16, [701, 514, 65, 2],
                                          [700, 513, 64, 1])
    assert kpa.attention_plan(q.dtype, 4, 1, 32, 8, 128, 16, tab.shape[1], True)[2] > 1
    a = kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=False)
    b = kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_paged_attention_wgmma_two_streams(gen):
    """Split walks in flight on two streams at once keep their own ticket
    counters: each stream's repeated result equals the one-stream result."""
    q, kp, vp, tab, qo, kvl = _paged_case(gen, 4, 1, 32, 8, 128, 16, [701, 514, 65, 2],
                                          [700, 513, 64, 1])
    assert kpa.attention_plan(q.dtype, 4, 1, 32, 8, 128, 16, tab.shape[1], True)[2] > 1
    want = kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=False)
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = ([], [])
    for _ in range(20):
        for s, o in zip(streams, outs):
            with torch.cuda.stream(s):
                o.append(kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=False))
    torch.cuda.synchronize()
    assert all(torch.equal(got, want) for o in outs for got in o)


@pytest.mark.parametrize("n,m", [(8, 16), (2, 4), (4, 8)])
def test_consensus_select_nan_keeps_n_per_group(gen, n, m):
    """A NaN activation makes its channel's pooled score NaN.  The kernel
    ranks it as torch.argmax does (above every number, the lower channel
    first among NaNs), so each group still keeps exactly n channels, the
    plain version's, and nothing is written past the tiles' id lists (the
    last group of the last tile holds more than n NaN channels)."""
    t, d, tile = 300, 64 * m, 256
    kc, n_tiles = d // m * n, 2
    x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
    nan = float("nan")
    x[3, 2 * m:3 * m] = nan                          # a whole group, tile 0
    x[5, 5 * m + m - 1] = nan                        # one channel, the group's last
    x[290, d - m:d - m + min(n + 1, m)] = nan        # n + 1 of the last group, tile 1
    idx0, xc0 = kns.consensus_select_plain(x, None, n, m, tile)
    guard = 4096
    idx = torch.full((n_tiles * kc + guard,), -7, dtype=torch.int32, device="cuda")
    xc = torch.empty((t, kc), dtype=x.dtype, device="cuda")
    rc = kns._fn("nm_spmm_select", x.dtype, 4, 5)(
        x.data_ptr(), None, idx.data_ptr(), xc.data_ptr(), t, d, n, m, tile,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(idx[:n_tiles * kc].view(n_tiles, kc), idx0)
    assert bool((idx[n_tiles * kc:] == -7).all())
    assert torch.equal(xc.view(torch.int16), xc0.view(torch.int16))
    assert torch.equal(kns.consensus_select(x, None, n, m, tile)[0], idx0)


@pytest.mark.parametrize("n,m", [(8, 16), (2, 4), (3, 8), (2, 6)])
def test_consensus_select_ties_bit_exact(gen, n, m):
    """Activations of three levels make pooled scores tie inside most
    groups: the channel-parallel ranking must keep the plain version's
    channels (a tie to the lower channel), including a fully tied tile."""
    t, d, tile = 300, 96 * m, 256
    x = torch.randint(0, 3, (t, d), generator=gen, device="cuda").bfloat16()
    x[:tile] = 1.0                                   # the first tile: every score tied
    idx, xc = kns.consensus_select(x, None, n, m, tile)
    idx0, xc0 = kns.consensus_select_plain(x, None, n, m, tile)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx0) and torch.equal(xc, xc0)
    first = idx[0].view(-1, n) - torch.arange(0, d, m, device="cuda")[:, None]
    assert bool((first == torch.arange(n, device="cuda")).all())


# ------------------------------------------------------- graphs (PR 17)
# paged_kv_scatter is launched as a programmatic dependent (PDL) of the
# kernel before it: eager, and replayed from a CUDA graph right after a
# producer kernel that writes its k_new / v_new (the graph records the
# programmatic edge).  Every case is bit-exact against the plain version.

def _scatter_case(gen, case):
    """(k_new, v_new, k_pool, v_pool, table, pos, chunk_len) of one case."""
    i32 = dict(dtype=torch.int32, device="cuda")
    dtype, b, t, hkv, hd, bs, mb = {
        "chunk": (torch.bfloat16, 1, 40, 8, 128, 16, 4),
        "decode": (torch.bfloat16, 4, 1, 8, 128, 16, 4),
        "float32": (torch.float32, 3, 24, 2, 64, 16, 6),
        "byte_route": (torch.bfloat16, 2, 9, 1, 7, 4, 5),
        "misaligned": (torch.bfloat16, 2, 9, 2, 64, 8, 4),
    }[case]
    rows = b * mb + 1
    off = 1 if case == "misaligned" else 0       # one element off a 16-byte boundary

    def buf(*shape):
        n = int(torch.tensor(shape).prod())
        flat = torch.randn(n + off, generator=gen, device="cuda").to(dtype)
        return flat[off:].view(*shape)

    kn, vn = buf(b, t, hkv, hd), buf(b, t, hkv, hd)
    kp, vp = buf(rows, bs, hkv, hd), buf(rows, bs, hkv, hd)
    tab = torch.randperm(b * mb, generator=gen, device="cuda").to(torch.int32).reshape(b, mb)
    if case == "chunk":        # a -1 block mid-chunk; rows 64.. past the table width
        tab[0, 2] = -1
        pos, clen = torch.tensor([30], **i32), torch.tensor([37], **i32)
    elif case == "decode":     # an empty slot, an unallocated current block, a row
        tab[1] = -1            # past the table width
        tab[2, 1] = -1
        pos, clen = torch.tensor([5, 40, 17, 64], **i32), torch.ones(4, **i32)
    else:                      # chunk_len < T, a -1 entry, a negative position
        tab[0, 1] = -1
        pos = torch.tensor([2, -3, 9][:b], **i32)
        clen = torch.tensor([t, t - 4, 5][:b], **i32)
    return kn, vn, kp, vp, tab, pos, clen


@pytest.mark.parametrize("launch", ["eager", "graph"])
@pytest.mark.parametrize("case", ["chunk", "decode", "float32", "byte_route", "misaligned"])
def test_paged_kv_scatter_kernel_bit_exact(gen, case, launch):
    from repro_torch.kernels import _capture

    kn, vn, kp, vp, tab, pos, clen = _scatter_case(gen, case)
    row_bytes = kp[0, 0].numel() * kp.element_size()
    vec = row_bytes % 16 == 0 and all(a.data_ptr() % 16 == 0 for a in (kn, vn, kp, vp))
    assert vec == (case not in ("byte_route", "misaligned"))
    want_k, want_v = kp.clone(), vp.clone()
    if launch == "eager":
        kpa.paged_kv_scatter_plain(kn, vn, want_k, want_v, tab, pos, clen)
        kpa.paged_kv_scatter(kn, vn, kp, vp, tab, pos, clen)
    else:
        src_k, src_v = kn.clone(), vn.clone()

        def producer_then_scatter():
            kn.copy_(src_k)          # the kernels that write k_new / v_new
            vn.copy_(src_v)
            kpa.paged_kv_scatter(kn, vn, kp, vp, tab, pos, clen)

        graph = _capture.Graph(kp.device, None)
        graph.capture(producer_then_scatter)
        for _ in range(3):           # fresh rows each replay
            src_k.copy_(torch.randn(src_k.shape, generator=gen, device="cuda"))
            src_v.copy_(torch.randn(src_v.shape, generator=gen, device="cuda"))
            kpa.paged_kv_scatter_plain(src_k, src_v, want_k, want_v, tab, pos, clen)
            graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)


def _graph_model(dtype):
    """A two-layer model of the dense family at head_dim 64 (the wgmma
    routes), the paper's policy with the kernels on, random weights."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), n_layers=2, d_model=256,
                              head_dim=64, d_ff=512, vocab_size=512, qgate_skip_layers=(1,),
                              dtype=dtype)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(use_kernels=True)
    precompute_scales(params, policy)
    return model, params, policy


def _cache_state(cache):
    return [cache["pos"].clone()] + [t.clone() for lay in cache["layers"]
                                      for t in (lay["k"], lay["v"])]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bucket", ["step_prefill", "step_prefill_decode", "step_decode",
                                    "step_replay", "step_replay_decode"])
def test_step_graph_matches_eager_body(gen, bucket, dtype):
    """A bucket's first step runs its program eagerly and captures it; the
    replay of the same step from the same cache gives bit-identical logits,
    finite flag, ``pos`` and pools, and adds to the launch counters what the
    eager step added."""
    from repro_torch import kernels
    from repro_torch.serve import ContinuousConfig
    from repro_torch.serve.executor import STEP_BUCKETS, Executor

    key = {v: k for k, v in STEP_BUCKETS.items()}[bucket]
    model, params, policy = _graph_model(dtype)
    ex = Executor(model, policy, ContinuousConfig(max_seq=64, num_slots=3, chunk_size=16,
                                                  block_size=16))
    ex.init_cache(12)
    ex.cache["block_table"].copy_(torch.arange(12, dtype=torch.int32).reshape(3, 4))
    ex.cache["pos"].copy_(torch.tensor([20, 33, 0], dtype=torch.int32))
    ops = torch.randint(0, 512, (2 + 16 + 6,), generator=gen, device="cuda").to(torch.int32)
    ops[0], ops[1] = 2, 11                                   # slot 2, chunk_len 11
    ops[-3:] = torch.tensor([1, 0, 1], dtype=torch.int32)    # slot 1 inactive
    ex._operands.copy_(ops)
    before = _cache_state(ex.cache)
    prog = ex.step_program(key)

    def run():
        return ex._graphs.run(bucket, lambda: prog(params, ex.cache, *ex._views()), params)

    kernels.reset_launch_counts()
    eager = [None if x is None else x.clone() for x in run()]
    eager_state = _cache_state(ex.cache)
    eager_counts = kernels.counters()
    assert ex.trace_counts == {bucket: 1}
    ex.cache["pos"].copy_(before[0])
    for lay, (k, v) in zip(ex.cache["layers"], zip(before[1::2], before[2::2])):
        lay["k"].copy_(k)
        lay["v"].copy_(v)
    graphed = run()
    torch.cuda.synchronize()
    assert ex.trace_counts == {bucket: 1}
    for a, b in zip(eager, graphed):
        assert (a is None and b is None) or torch.equal(a, b)
    assert bool(graphed[2])
    for a, b in zip(eager_state, _cache_state(ex.cache)):
        assert torch.equal(a, b)
    assert kernels.counters() == {k: 2 * n for k, n in eager_counts.items()}
    assert eager_counts["paged_kv_scatter"] == 2 * (key[1] + key[2])


def test_split_walk_graphs_keep_their_own_tickets(gen):
    """Two graphs of split paged_attention walks (ticket counters), replayed
    at once on two streams beside eager calls of the same walk on a third:
    each keeps its own counters, so every result is the eager one."""
    from repro_torch.kernels import _capture

    q, kp, vp, tab, qo, kvl = _paged_case(gen, 4, 1, 32, 8, 128, 16, [701, 514, 65, 2],
                                          [700, 513, 64, 1])
    assert kpa.attention_plan(q.dtype, 4, 1, 32, 8, 128, 16, tab.shape[1], True)[2] > 1
    q2 = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    want = [kpa.paged_attention(x, kp, vp, tab, qo, kvl, causal=False) for x in (q, q2)]
    pool = torch.cuda.graph_pool_handle()
    graphs, outs = [], []
    for x in (q, q2):
        g = _capture.Graph(q.device, pool)
        outs.append(g.capture(lambda x=x: kpa.paged_attention(x, kp, vp, tab, qo, kvl,
                                                               causal=False)))
        graphs.append(g)
    assert graphs[0].tickets.data_ptr() != graphs[1].tickets.data_ptr()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    seen, eager = [], []
    for _ in range(20):
        for g, s, o in zip(graphs, streams, outs):
            with torch.cuda.stream(s):
                g.replay()
                seen.append(o.clone())
        eager.append(kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=False))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want[i % 2]) for i, o in enumerate(seen))
    assert all(torch.equal(e, want[0]) for e in eager)


def test_launch_counts_count_replays(gen):
    """Three calls of a program through ``Programs`` (one eager, a capture,
    two replays) leave the launch counters where three eager calls leave
    them."""
    from repro_torch import kernels
    from repro_torch.kernels import _capture

    q, kp, vp, tab, qo, kvl = _paged_case(gen, 4, 1, 32, 8, 128, 16, [701, 514, 65, 2],
                                          [700, 513, 64, 1])
    kn = torch.randn(4, 1, 8, 128, generator=gen, device="cuda").bfloat16()
    ones = torch.ones(4, dtype=torch.int32, device="cuda")

    def step():
        kpa.paged_kv_scatter(kn, kn, kp, vp, tab, qo, ones)
        return kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=False)

    kernels.reset_launch_counts()
    for _ in range(3):
        step()
    eager = kernels.counters()
    assert eager["paged_kv_scatter"] == eager["paged_attention"] == 3
    kernels.reset_launch_counts()
    progs, params = _capture.Programs(q.device), object()
    for _ in range(3):
        progs.run("step", step, params)
    torch.cuda.synchronize()
    assert kernels.counters() == eager
    assert progs.trace_counts == {"step": 1}
