"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU.  Every test here is marked ``cuda`` and skips without a card
(the kernels have no CPU form).  The file imports torch only, so it also
runs where JAX is not installed::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import ctypes

import pytest
import torch

from repro_torch.core import nm, quant, scoring
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


# The dense variants' projection widths (K, N_out): StableLM-3B, ChatGLM3-6B,
# Qwen2.5-32B and Granite-34B q, gate and down, at a 256-token chunk and a
# ragged 137 rows, with a bias where the model has one.
_VARIANT_WIDTHS = [(2560, 2560), (2560, 6912), (6912, 2560), (4096, 4096), (4096, 13696),
                   (13696, 4096), (5120, 5120), (5120, 27648), (27648, 5120), (6144, 24576),
                   (24576, 6144)]


@pytest.mark.parametrize("t", [256, 137])
@pytest.mark.parametrize("d,n_out", _VARIANT_WIDTHS, ids=[f"{d}x{n}" for d, n in _VARIANT_WIDTHS])
def test_nm_prune_matmul_variant_widths(gen, d, n_out, t):
    x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(d, n_out, generator=gen, device="cuda") * d**-0.5).bfloat16()
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5
    b = (torch.randn(n_out, generator=gen, device="cuda") * 0.1).bfloat16() if d == n_out else None
    assert knm.gemm_plan(w, t) >= 1                  # the wgmma route
    _close(knm.nm_prune_matmul(x, w, sc, 8, 16, bias=b),
           knm.nm_prune_matmul_plain(x, w, sc, 8, 16, bias=b), torch.bfloat16)


# The modality families' pruned widths (K, N_out): Whisper-medium q, fc1,
# fc2 and Qwen2-VL-2B q, gate, down, at Whisper's 1500 encoder rows and a
# 256-token chunk, with a bias where the model has one (all of Whisper's,
# Qwen2-VL's q).
_MODALITY_WIDTHS = [(1024, 1024), (1024, 4096), (4096, 1024), (1536, 1536), (1536, 8960),
                    (8960, 1536)]


@pytest.mark.parametrize("t", [1500, 256])
@pytest.mark.parametrize("d,n_out", _MODALITY_WIDTHS,
                         ids=[f"{d}x{n}" for d, n in _MODALITY_WIDTHS])
def test_nm_prune_matmul_modality_widths(gen, d, n_out, t):
    x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(d, n_out, generator=gen, device="cuda") * d**-0.5).bfloat16()
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5
    biased = d in (1024, 4096) or d == n_out
    b = (torch.randn(n_out, generator=gen, device="cuda") * 0.1).bfloat16() if biased else None
    assert knm.gemm_plan(w, t) >= 1                  # the wgmma route
    _close(knm.nm_prune_matmul(x, w, sc, 8, 16, bias=b),
           knm.nm_prune_matmul_plain(x, w, sc, 8, 16, bias=b), torch.bfloat16)


# LLaMA-3.1-8B's projections at the sensitivity scan's 512 rows and a
# ragged 137: k/v (4096 -> 1024, split k), q/o (4096 -> 4096), gate/up
# (4096 -> 14336) and down (14336 -> 4096), at 8:16 (the scan's probes) and
# 2:4 (the Naive run of the weight-sparsity comparison), each with an Amber
# scale and with none.
_SCAN_WIDTHS = [(4096, 1024), (4096, 4096), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("n,m", [(8, 16), (2, 4)])
@pytest.mark.parametrize("t", [512, 137])
@pytest.mark.parametrize("d,n_out", _SCAN_WIDTHS, ids=[f"{d}x{n}" for d, n in _SCAN_WIDTHS])
def test_nm_prune_matmul_scan_widths(gen, d, n_out, t, n, m):
    x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(d, n_out, generator=gen, device="cuda") * d**-0.5).bfloat16()
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5
    assert knm.gemm_plan(w, t) >= 1                  # the wgmma route
    for scale in (sc, None):
        _close(knm.nm_prune_matmul(x, w, scale, n, m),
               knm.nm_prune_matmul_plain(x, w, scale, n, m), torch.bfloat16)


@pytest.mark.parametrize("layout", ["heads_transposed", "column_slice"])
def test_nm_prune_matmul_non_contiguous_o_proj_input(gen, layout):
    """o_proj's input as attention may hand it over: heads moved after the
    tokens (a copy on reshape), or a column slice of a wider buffer (a
    strided view that survives the reshape); ``ops`` makes it contiguous."""
    from repro_torch.kernels import ops

    if layout == "heads_transposed":
        x = torch.randn(2, 32, 256, 128, generator=gen, device="cuda").bfloat16().transpose(1, 2)
    else:
        x = torch.randn(2, 256, 8192, generator=gen, device="cuda").bfloat16()[..., 1024:5120]
    assert not x.is_contiguous()
    w = (torch.randn(4096, 4096, generator=gen, device="cuda") * 4096**-0.5).bfloat16()
    sc = torch.rand(4096, generator=gen, device="cuda") + 0.5
    got = ops.nm_prune_matmul(x.reshape(2, 256, 4096), w, sc, 8, 16)
    want = knm.nm_prune_matmul_plain(x.reshape(512, 4096).contiguous(), w, sc, 8, 16)
    assert got.shape == (2, 256, 4096)
    _close(got.reshape(512, 4096), want, torch.bfloat16)


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


# Qwen2.5-32B's q/k/o (5120 -> 5120, 1024) and gate (5120 -> 27648), down's
# K of 27648, ChatGLM3-6B's k/v (4096 -> 256) and Granite-34B's (6144 -> 128):
# every mode, with and without the q/k/v bias, at a chunk and a decode step.
_INT8_VARIANTS = [(5120, 5120), (5120, 1024), (5120, 27648), (27648, 5120), (4096, 256),
                  (6144, 128)]


@pytest.mark.parametrize("t", [4, 256])
@pytest.mark.parametrize("d,n_out", _INT8_VARIANTS, ids=[f"{d}x{n}" for d, n in _INT8_VARIANTS])
def test_osparse_matmul_variant_widths_bit_exact(gen, d, n_out, t):
    _check_osparse(gen, _int8_linear(gen, d, n_out), t, d, n_out, 8, 16)



# Qwen3-30B-A3B's attention under W8A8: q 2048 -> 4096, k/v 2048 -> 512 and
# o 4096 -> 2048, static and per-token, pruned and dense, at a chunk and a
# decode step.
_INT8_QWEN3 = [(2048, 4096), (2048, 512), (4096, 2048)]


@pytest.mark.parametrize("t", [4, 256])
@pytest.mark.parametrize("d,n_out", _INT8_QWEN3, ids=[f"{d}x{n}" for d, n in _INT8_QWEN3])
def test_osparse_matmul_moe_attention_bit_exact(gen, d, n_out, t):
    _check_osparse(gen, _int8_linear(gen, d, n_out), t, d, n_out, 8, 16)

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


@pytest.mark.parametrize("hq,hkv,hd", [(8, 8, 80), (16, 1, 128)], ids=["hd80_g1", "g16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_flash_attention_variant_heads(gen, hq, hkv, hd, causal):
    """StableLM-3B's head_dim 80 (the wgmma kernel's 128-column tile, 48
    columns of zeros) and a GQA group of 16 at head_dim 128, T ragged
    against the tiles."""
    b, t = 2, 300
    q = torch.randn(b, t, hq, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").bfloat16()
    assert kfa.flash_plan(q.dtype, hd, True) == ("wgmma", 128, 2)
    _close(kfa.flash_attention(q, k, v, causal=causal),
           kfa.flash_attention_plain(q, k, v, causal=causal), torch.bfloat16)


@pytest.mark.parametrize("case,t,causal,window", [
    ("causal", 300, True, 0),
    ("window", 700, True, 200),
    ("noncausal", 130, False, 0),
    ("one_tile", 40, True, 0),
])
@pytest.mark.parametrize("hq,hkv,hd", [(10, 1, 256), (4, 2, 160), (4, 4, 136)],
                         ids=["hd256_g10", "hd160", "hd136"])
def test_flash_attention_tile256(gen, hq, hkv, hd, case, t, causal, window):
    """The wgmma kernel's 256-column tile: RecurrentGemma-2B's heads (10
    query heads on one KV head, head_dim 256) and head dims it pads (160:
    one 64-column chunk of zeros, another half; 136: 120 columns of zeros),
    causal, windowed, non-causal and one short tile, T ragged."""
    b = 2
    q = torch.randn(b, t, hq, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").bfloat16()
    assert kfa.flash_plan(q.dtype, hd, True)[:2] == ("wgmma", 256)
    _close(kfa.flash_attention(q, k, v, causal=causal, window=window),
           kfa.flash_attention_plain(q, k, v, causal=causal, window=window), torch.bfloat16)


@pytest.mark.parametrize("hd", [8, 32, 48, 96, 120])
def test_flash_attention_padded_tiles(gen, hd):
    """Head dims below the 64- and 128-column tiles they pad to, GQA 7:1,
    causal over a ragged T."""
    b, t, hq, hkv = 2, 200, 14, 2
    q = torch.randn(b, t, hq, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, t, hkv, hd, generator=gen, device="cuda").bfloat16()
    assert kfa.flash_plan(q.dtype, hd, True)[0] == "wgmma"
    _close(kfa.flash_attention(q, k, v), kfa.flash_attention_plain(q, k, v), torch.bfloat16)


@pytest.mark.parametrize("dtype,hd,aligned,route", [
    (torch.bfloat16, 80, True, "wgmma"), (torch.bfloat16, 256, True, "wgmma"),
    (torch.bfloat16, 36, True, "rows"), (torch.float32, 80, True, "rows"),
    (torch.bfloat16, 80, False, "rows")], ids=["hd80", "hd256", "hd36", "f32_hd80", "offset"])
def test_flash_attention_counts_its_route(gen, dtype, hd, aligned, route):
    """Each call adds one to the route its plan names, and to no other."""
    q = torch.randn(1, 70, 4, hd, generator=gen, device="cuda").to(dtype)
    if not aligned:
        q = _misaligned(q)
    k = torch.randn(1, 70, 2, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(1, 70, 2, hd, generator=gen, device="cuda").to(dtype)
    before = dict(kfa.flash_attention.route_launches)
    got = kfa.flash_attention(q, k, v)
    after = kfa.flash_attention.route_launches
    assert {r: after[r] - before[r] for r in after} == {r: int(r == route) for r in after}
    _close(got, kfa.flash_attention_plain(q, k, v), dtype)


def test_flash_attention_misaligned_takes_rows_path(gen):
    q = _misaligned(torch.randn(1, 70, 14, 64, generator=gen, device="cuda").bfloat16())
    k = torch.randn(1, 70, 2, 64, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, 70, 2, 64, generator=gen, device="cuda").bfloat16()
    _close(kfa.flash_attention(q, k, v), kfa.flash_attention_plain(q, k, v), torch.bfloat16)


@pytest.mark.parametrize("dtype,aligned,route", [
    (torch.bfloat16, True, "wgmma"), (torch.bfloat16, False, "rows"),
    (torch.float32, True, "rows")], ids=["bf16_wgmma", "bf16_rows", "f32_rows"])
@pytest.mark.parametrize("b,t,s,hq,hkv,hd", [
    (1, 256, 1500, 16, 16, 64), (4, 1, 1500, 16, 16, 64), (2, 64, 128, 2, 2, 32),
    (2, 100, 37, 14, 2, 128)], ids=["whisper_cross_chunk", "whisper_cross_decode",
                                    "jax_test_case", "gqa_short_keys"])
def test_flash_attention_keys_of_another_length(gen, dtype, aligned, route, b, t, s, hq, hkv,
                                                hd):
    """Non-causal attention over S != T keys on both routes: Whisper-medium's
    cross-attention (16 / 16 heads of 64 over 1500 encoder rows, an edge key
    tile) for a chunk and a decode batch, the JAX kernel test's (2, 2, 64,
    128) case, and fewer keys than queries at GQA 7:1; each call on the
    route its plan names."""
    q = torch.randn(b, t, hq, hd, generator=gen, device="cuda").to(dtype)
    if not aligned:
        q = _misaligned(q)
    k = torch.randn(b, s, hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, hd, generator=gen, device="cuda").to(dtype)
    before = dict(kfa.flash_attention.route_launches)
    got = kfa.flash_attention(q, k, v, causal=False)
    assert kfa.flash_attention.route_launches[route] == before[route] + 1
    _close(got, kfa.flash_attention_plain(q, k, v, causal=False), dtype)


def test_flash_attention_keys_of_another_length_raise_when_masked(gen):
    q = torch.randn(1, 64, 4, 64, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, 128, 4, 64, generator=gen, device="cuda").bfloat16()
    for causal, window in ((True, 0), (False, 32), (True, 32)):
        with pytest.raises(ValueError, match="S != T"):
            kfa.flash_attention(q, k, k, causal=causal, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["causal", "ragged", "window", "noncausal", "head_dim_32"])
def test_flash_attention(gen, dtype, case):
    """GQA 7:1 as in Qwen2-7B; a ragged T the 64-row tiles do not divide; a
    causal window band (key blocks below it skipped); non-causal; head_dim
    32, which bf16 pads to the wgmma kernel's 64-column tile and float32
    runs on the rows kernel."""
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


_PAGED_CASES = ["chunk", "chunk_hole", "chunk_masked_tile", "decode", "decode_edges"]


def _check_paged_case(gen, case, hq, hkv, hd, bs, route, dtype=torch.bfloat16):
    """One case of the NaN-poisoned pools on ``route`` against the plain
    version: a prefill chunk at an offset; a -1 page in the middle of a row;
    a query tile that sees only a -1 page (wholly masked, so zeros); decode
    rows with kv_len on a page boundary, 0 and 1."""
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
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    plan = kpa.attention_plan(q.dtype, b, tq, hq, hkv, hd, bs, tab.shape[1], True)
    assert plan[0] == route, plan
    causal = tq > 1
    before = dict(kpa.paged_attention.route_launches)
    got = kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=causal)
    after = kpa.paged_attention.route_launches
    assert {r: after[r] - before[r] for r in after} == {r: int(r == route) for r in after}
    want = kpa.paged_attention_plain(q, kp, vp, tab, qo, kvl, causal=causal)
    _close(got, want, dtype)
    if case == "chunk_masked_tile":        # tokens 0..bs-1 see only the -1 page
        assert bool((got[0, :bs] == 0).all())
    if case == "decode_edges":             # kv_len = 0 gives zeros
        assert bool((got[1] == 0).all())


@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("hq,hkv,hd", [(32, 8, 128), (28, 4, 128), (14, 2, 64), (40, 8, 128),
                                       (32, 2, 128), (48, 1, 128)],
                         ids=["g4", "g7", "g7_hd64", "g5", "g16", "g48"])
@pytest.mark.parametrize("case", _PAGED_CASES)
def test_paged_attention_wgmma(gen, case, hq, hkv, hd, bs):
    """The wgmma route at block sizes 8, 16 and 32, GQA groups of 4, 7 and 8
    (LLaMA-3.1, Qwen2), 5 (Qwen2.5-32B: 12 tokens fill 60 of the 64 rows,
    4 pad rows a tile), 16 (ChatGLM3-6B) and 48 (Granite-34B's MQA: one
    token a tile, 48 rows, one KV head in the pool)."""
    _check_paged_case(gen, case, hq, hkv, hd, bs, "wgmma")


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("case", _PAGED_CASES)
def test_paged_attention_rows_hd80(gen, case, bs):
    """StableLM-3B's heads (32 / 32, head_dim 80) in float32 keep the
    CUDA-core rows kernel: chunks walk one row at a time, decode splits the
    walk."""
    _check_paged_case(gen, case, 32, 32, 80, bs, "rows", torch.float32)


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("case", _PAGED_CASES)
def test_paged_attention_wgmma_hd80(gen, case, bs):
    """StableLM-3B's heads (32 / 32, head_dim 80) in bf16 take the wgmma
    kernel's 128-column tile (48 columns of zeros loaded, never stored):
    64 tokens a chunk tile, decode's walk split where blocks leave SMs."""
    _check_paged_case(gen, case, 32, 32, 80, bs, "wgmma")


@pytest.mark.parametrize("hq,hkv,hd,route", [(8, 2, 32, "wgmma"), (14, 2, 48, "wgmma"),
                                             (32, 8, 96, "wgmma"), (8, 8, 120, "wgmma"),
                                             (8, 2, 256, "rows"), (8, 2, 36, "rows")],
                         ids=["hd32", "hd48_g7", "hd96_g4", "hd120", "hd256", "hd36"])
@pytest.mark.parametrize("case", _PAGED_CASES)
def test_paged_attention_padded_heads(gen, case, hq, hkv, hd, route):
    """Head dims below the wgmma kernel's 64- and 128-column tiles, on it
    (the split decode's merge writes only the real columns); head_dim 256
    and a head_dim that is not a multiple of 8 keep the rows kernel."""
    _check_paged_case(gen, case, hq, hkv, hd, 16, route)


# (b, tq, kv_len, q_offset) of the window cases: a chunk at an offset whose
# band starts tiles into the row; decode rows far past the band, at it and
# short of it (kv_len 2 sees every key)
_WINDOW_CASES = {"chunk": (1, 100, [1230], [1130]), "chunk_short": (2, 40, [60, 300], [20, 260]),
                 "decode": (4, 1, [1701, 514, 65, 2], [1700, 513, 64, 1])}


@pytest.mark.parametrize("window", [1, 37, 100, 300])
@pytest.mark.parametrize("case", list(_WINDOW_CASES))
@pytest.mark.parametrize("route,hq,hkv,hd,dtype", [
    ("wgmma", 32, 8, 128, torch.bfloat16), ("wgmma", 14, 2, 64, torch.bfloat16),
    ("rows", 32, 32, 80, torch.float32), ("wgmma", 32, 32, 80, torch.bfloat16)],
    ids=["wgmma_g4", "wgmma_g7_hd64", "rows_hd80", "wgmma_hd80"])
def test_paged_attention_window(gen, route, hq, hkv, hd, dtype, case, window):
    """The sliding-window band (keys at k > q - window) on both routes
    against the plain version over NaN-poisoned pools: key tiles and blocks
    below the band are skipped, edge tiles masked per score; decode splits
    the band's walk (window 1: one split holds no key).  Head_dim 80 runs
    on the rows kernel in float32 and on wgmma's padded tile in bf16."""
    b, tq, kv_len, qoff = _WINDOW_CASES[case]
    q, kp, vp, tab, qo, kvl = _paged_case(gen, b, tq, hq, hkv, hd, 16, kv_len, qoff)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    assert kpa.attention_plan(q.dtype, b, tq, hq, hkv, hd, 16, tab.shape[1], True,
                              window=window)[0] == route
    causal = tq > 1
    _close(kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=causal, window=window),
           kpa.paged_attention_plain(q, kp, vp, tab, qo, kvl, causal=causal, window=window),
           dtype)


@pytest.mark.parametrize("route,hq,hkv,hd,dtype", [("wgmma", 32, 8, 128, torch.bfloat16),
                                                   ("rows", 32, 8, 128, torch.float32)])
def test_paged_attention_window_off_band_splits(gen, monkeypatch, route, hq, hkv, hd, dtype):
    """A decode walk split as if it had no window (the whole table's 27 key
    tiles in 4 wgmma splits, or its 108 blocks in 27 rows-kernel ranges)
    under a window of 40: the band's walk starts at its first tile, so the
    first split holds it all and the others find no key, write an empty
    partial state, and the merge still gives the plain version's output."""
    plan = kpa.attention_plan

    def no_window(*args, **kw):            # the wrapper passes it after sms
        kw.pop("window", None)
        return plan(*args[:10], **kw, window=0)

    monkeypatch.setattr(kpa, "attention_plan", no_window)
    b, tq, kv_len, qoff = _WINDOW_CASES["decode"]
    q, kp, vp, tab, qo, kvl = _paged_case(gen, b, tq, hq, hkv, hd, 16, kv_len, qoff)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    route_, _, n_split, _ = kpa.attention_plan(dtype, b, tq, hq, hkv, hd, 16, tab.shape[1],
                                              True, window=40)
    assert route_ == route and n_split > 1
    _close(kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=False, window=40),
           kpa.paged_attention_plain(q, kp, vp, tab, qo, kvl, causal=False, window=40), dtype)


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
        "hd80": (torch.bfloat16, 2, 24, 32, 80, 16, 4),      # StableLM-3B: 5120-byte rows
        "one_kv_head": (torch.bfloat16, 3, 24, 1, 128, 16, 6),   # Granite-34B's MQA
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
@pytest.mark.parametrize("case", ["chunk", "decode", "float32", "byte_route", "misaligned",
                                  "hd80", "one_kv_head"])
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
    ex._operands[:-1].copy_(ops)                             # the last slot: fault 0.0
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


# The serving lifecycle under graphs: fault operands in replays, the legacy
# split's graphs, and crashed engines freed.

def _lifecycle_engine(model, policy, **kw):
    from repro_torch.serve import ContinuousConfig, ContinuousServingEngine

    faults = kw.pop("faults", None)
    return ContinuousServingEngine(model, policy, ContinuousConfig(
        max_seq=96, num_slots=3, chunk_size=16, block_size=16, **kw), faults=faults)


def _lifecycle_requests(eng):
    g = torch.Generator().manual_seed(5)
    for n, a in zip((21, 40, 9, 33), (0, 0, 2, 4)):
        eng.submit(torch.randint(0, 512, (n,), generator=g).numpy(), max_new_tokens=12,
                   arrival=a)


def test_nonfinite_fault_poisons_a_replayed_step(gen):
    """A ``nonfinite`` decode fault aimed at an iteration whose bucket was
    captured earlier reaches the replay through the fault operand, and the
    step raises ``FloatingPointError``."""
    from repro_torch.serve.faults import FaultInjector, FaultSpec

    model, params, policy = _graph_model("bfloat16")
    inj = FaultInjector(seed=0, schedule=[FaultSpec("decode", "nonfinite", iters=(9,))])
    eng = _lifecycle_engine(model, policy, faults=inj)
    _lifecycle_requests(eng)
    seen = {}
    eng.iteration_hook = lambda e, it: seen.__setitem__(it, dict(e.trace_counts))
    with pytest.raises(FloatingPointError, match="non-finite") as err:
        eng.run(params)
    name = str(err.value).split(":")[0]
    assert inj.fired_kinds("decode") == ["nonfinite"] and inj.fired[0]["it"] == 9
    assert seen[9].get(name) == 1 == eng.trace_counts[name], (name, seen[9])


def test_legacy_graphs_replay_token_identical(gen):
    """``fused_step=False`` on the card: the ``prefill`` and ``decode``
    programs are captured once each and their replays emit the tokens of
    the same steps run eagerly, which are the fused path's."""
    model, params, policy = _graph_model("bfloat16")
    outs = {}
    for mode in ("legacy", "legacy-eager", "fused"):
        eng = _lifecycle_engine(model, policy, fused_step=mode == "fused")
        if mode == "legacy-eager":
            eng.exec._graphs.run = lambda name, fn, params, shape=None: fn()
        _lifecycle_requests(eng)
        outs[mode] = eng.run(params)["outputs"]
        if mode == "legacy":
            assert eng.trace_counts == {"prefill": 1, "decode": 1}
            assert eng.metrics["dispatches_per_iteration"] > 1.0
    assert outs["legacy"] == outs["legacy-eager"] == outs["fused"]


def test_crashed_and_restored_engines_are_freed(gen):
    """A crash mid-decode restored into a new engine: the crashed engine and,
    once it has finished and is dropped, its successor are freed at once
    (no reference cycle), their caches and graph pools with them."""
    import gc
    import weakref

    from repro_torch.serve.faults import EngineCrash, FaultInjector, FaultSpec

    model, params, policy = _graph_model("bfloat16")
    warm = _lifecycle_engine(model, policy)     # library workspaces, kernel scratch
    _lifecycle_requests(warm)
    warm.run(params)
    del warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    inj = FaultInjector(seed=0, schedule=[FaultSpec("decode", "crash", iters=(7,))])
    gc.disable()
    try:
        eng = _lifecycle_engine(model, policy, faults=inj, snapshot_every=1)
        _lifecycle_requests(eng)
        with pytest.raises(EngineCrash):
            eng.run(params)
        snap, crashed = eng.last_snapshot, weakref.ref(eng.exec)
        del eng
        assert crashed() is None
        eng = _lifecycle_engine(model, policy, faults=inj, snapshot_every=1)
        eng.restore(snap)
        res = eng.run(params)
        assert eng.restores == 1 and set(eng.trace_counts.values()) == {1}
        assert all(len(o) == 12 for o in res["outputs"].values())
        restored = weakref.ref(eng.exec)
        del eng
        assert restored() is None
    finally:
        gc.enable()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


# The MoE layer (models/moe.py) at Qwen3-30B-A3B's widths: its grouped
# product is one torch._grouped_mm call, its expert prunes nm_prune launches.

def _moe_layer(gen, dtype=torch.bfloat16):
    from repro_torch.models import moe as moe_lib

    layer = moe_lib.init_moe(2048, 768, 128, False, dtype=dtype, device="cuda",
                             generator=gen)
    x = torch.randn(1, 256, 2048, generator=gen, device="cuda").to(dtype)
    return moe_lib, layer, x


def test_moe_layer_kernel_path_matches_plain(gen):
    """One layer, a 256-token chunk, bf16, the paper's policy: the kernel
    path (nm_prune, torch._grouped_mm) routes as the plain path (nm_prune_plain,
    the per-expert loop) does, launches nm_prune for the expert gate and
    down inputs, and differs from it by at most twice the plain path's own
    bf16 effect (against the plain path in float32 on the same weights)."""
    import copy

    from repro_torch import kernels
    from repro_torch.core.policy import paper_policy

    moe_lib, layer, x = _moe_layer(gen)
    pol = paper_policy(8, 16)
    ids = [moe_lib.route(x.reshape(-1, 2048), layer.router.w, 8)[1] for _ in range(2)]
    kernels.reset_launch_counts()
    got = moe_lib.moe(x, layer, pol.with_(use_kernels=True), "prefill", 8)
    assert kernels.launch_counts()["nm_prune"] == 2
    want = moe_lib.moe(x, layer, pol, "prefill", 8)
    ref = moe_lib.moe(x.float(), copy.deepcopy(layer).float(), pol, "prefill", 8)
    assert torch.equal(ids[0], ids[1])
    assert bool(got.isfinite().all())
    e_ref = float((want.float() - ref).abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2.0 * e_ref


def test_moe_graph_replay_on_new_routing(gen):
    """The layer captured once in a CUDA graph (sort, group counts and
    offsets on the device, the grouped product reading them there), then
    replayed on new inputs that route elsewhere: each replay gives the eager
    layer's output bit for bit."""
    from repro_torch.core.policy import paper_policy
    from repro_torch.kernels import _capture

    moe_lib, layer, x = _moe_layer(gen)
    pol = paper_policy(8, 16).with_(use_kernels=True)
    buf = x.clone()
    moe_lib.moe(buf, layer, pol, "prefill", 8)            # eager first, as the engines do
    graph = _capture.Graph(buf.device, None)
    out = graph.capture(lambda: moe_lib.moe(buf, layer, pol, "prefill", 8))
    for scale in (1.0, 3.0, 0.1):
        new = torch.randn(x.shape, generator=gen, device="cuda").bfloat16() * scale
        buf.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, moe_lib.moe(new, layer, pol, "prefill", 8))


@pytest.mark.parametrize("rows", [32, 2048])
def test_grouped_matmul_matches_plain_with_empty_groups(gen, rows):
    from repro_torch.models import moe as moe_lib

    e, d, f = 16, 256, 128
    sizes = torch.randint(0, 2 * rows // e, (e,), generator=gen, device="cuda")
    sizes[[1, 5, 6]] = 0                                  # empty groups
    sizes[-1] += rows - sizes.sum()                       # the rows end at the last group
    sizes[-1] = sizes[-1].clamp(min=0)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    x = torch.randn(int(offs[-1]), d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(e, d, f, generator=gen, device="cuda") * d**-0.5).bfloat16()
    got = moe_lib.grouped_matmul(x, w, offs)
    _close(got, moe_lib.grouped_matmul_plain(x, w, offs), torch.bfloat16)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "recurrentgemma_2b"])
def test_replayed_decode_leaves_inactive_slots_state_unchanged(gen, arch):
    """The recurrent families' smoke models in bf16 with the kernels: a fused
    step (slot 1's 4-token exact chunk, slot 0 decoding, slot 2 empty) run
    eagerly and captured, then replayed from the same state: the replay
    leaves slot 2's recurrent state bit-unchanged, moves slot 0's, and gives
    slot 1 what the same chunk run alone gives; each program is captured
    once for its chunk length."""
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serve import ContinuousConfig
    from repro_torch.serve.executor import Executor
    from repro_torch.serve.scheduler import DecodeWork, PrefillWork, StepPlan

    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    policy = paper_policy(8, 16).with_(use_kernels=True)
    precompute_scales(params, policy)
    ex = Executor(model, policy, ContinuousConfig(max_seq=32, num_slots=3, chunk_size=8))
    ex.init_cache(None)
    assert ex.exact_chunks and not ex.paged
    for layer in ex.cache["layers"]:
        for leaf in layer.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda").to(leaf.dtype))
    start = [{k: v.clone() for k, v in layer.items()} for layer in ex.cache["layers"]]
    pos = torch.tensor([9, 4, 0], dtype=torch.int32, device="cuda")
    prefill = PrefillWork(SimpleNamespace(slot=1), np.arange(7, 11, dtype=np.int32)[None], 4,
                          False)
    fused = StepPlan(prefill=prefill, decode=DecodeWork(
        [], np.array([3, 0, 0], np.int32), np.array([True, False, False])))

    def run(plan):
        for layer, old in zip(ex.cache["layers"], start):
            for k, v in layer.items():
                v.copy_(old[k])
        ex.cache["pos"].copy_(pos)
        ex.step(params, plan)
        torch.cuda.synchronize()
        return [{k: v.clone() for k, v in layer.items()} for layer in ex.cache["layers"]]

    run(fused)                         # eager, then captured
    replayed = run(fused)              # a replay
    alone = run(StepPlan(prefill=prefill))
    assert ex.trace_counts == {"step_prefill_decode": 1, "step_prefill": 1}
    moved = False
    for kind, new, one, old in zip(layer_kinds(cfg), replayed, alone, start):
        if kind == "attn":
            continue
        for k in new:
            assert torch.equal(new[k][2], old[k][2]), (kind, k)
            assert torch.equal(new[k][1], one[k][1]), (kind, k)
            moved |= not torch.equal(new[k][0], old[k][0])
    assert moved


# ------------------------------------------------------------- training

def _req(t):
    return t.requires_grad_(True)


_GUARDED = {
    "flash_attention": lambda d: kfa.flash_attention(
        _req(torch.randn(1, 32, 2, 64, device=d)), *[torch.randn(1, 32, 2, 64, device=d)] * 2),
    "nm_spmm": lambda d: kns.nm_spmm(_req(torch.randn(32, 64, device=d)),
                                     torch.randn(64, 16, device=d), None, 8, 16),
    "osparse_matmul": lambda d: kos.osparse_matmul(
        _req(torch.randn(4, 64, device=d)), torch.zeros(64, 16, dtype=torch.int8, device=d),
        torch.ones(64, device=d), None, torch.ones(16, device=d), 8, 16,
        act_scale=torch.ones(1, device=d)),
    "w8a8_matmul": lambda d: kw8.w8a8_matmul(
        torch.zeros(4, 64, dtype=torch.int8, device=d),
        torch.zeros(64, 16, dtype=torch.int8, device=d), torch.ones(1, device=d),
        _req(torch.ones(16, device=d))),
    "paged_kv_scatter": lambda d: kpa.paged_kv_scatter(
        _req(torch.randn(1, 4, 1, 64, device=d)), torch.randn(1, 4, 1, 64, device=d),
        torch.zeros(2, 8, 1, 64, device=d), torch.zeros(2, 8, 1, 64, device=d),
        torch.zeros(1, 1, dtype=torch.int32, device=d),
        torch.zeros(1, dtype=torch.int32, device=d), torch.full((1,), 4, dtype=torch.int32,
                                                                device=d)),
    "paged_attention": lambda d: kpa.paged_attention(
        _req(torch.randn(1, 1, 1, 64, device=d)), torch.zeros(2, 8, 1, 64, device=d),
        torch.zeros(2, 8, 1, 64, device=d), torch.zeros(1, 1, dtype=torch.int32, device=d),
        torch.zeros(1, dtype=torch.int32, device=d), torch.ones(1, dtype=torch.int32, device=d)),
}


@pytest.mark.parametrize("kernel", sorted(_GUARDED))
def test_kernels_without_backward_refuse_grad(gen, kernel):
    """A kernel with no backward, called where autograd records (an input
    requires grad, grad mode on), raises naming itself, before any launch;
    under ``no_grad`` a kernel with a backward records nothing either
    (``nm_prune`` and ``nm_prune_matmul`` have one: their autograd
    Functions' tests are below)."""
    with pytest.raises(RuntimeError, match=f"{kernel}: the CUDA kernel has no backward"):
        _GUARDED[kernel]("cuda")
    x = torch.randn(4, 64, device="cuda", requires_grad=True)
    with torch.no_grad():
        assert knp.nm_prune(x, None, 8, 16).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,n_out,bias", [(37, 128, 72, True), (256, 4096, 1024, False)])
def test_prune_matmul_function_matches_plain_autograd(gen, dtype, t, d, n_out, bias):
    """``PruneMatmul`` on the card (one kernel launch, its selection kept)
    against the plain path's autograd on the same inputs, with a whole
    16-group of zeros and a lone zero: the kernel's keep-mask is the plain
    selection bit for bit (kept zeros included), and y, dX, dW and db are
    within the kernels' tolerance (dX and dW are ``torch.matmul`` on both
    sides)."""
    x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    x[1, :16] = 0
    x[2, 5] = 0
    w = (torch.randn(d, n_out, generator=gen, device="cuda") * d**-0.5).to(dtype)
    b = torch.randn(n_out, generator=gen, device="cuda").to(dtype) if bias else None
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5
    dy = torch.randn(t, n_out, generator=gen, device="cuda").to(dtype)
    _, _, keep = knm._launch(x, w, sc, 8, 16, b, with_keep=True)
    want_keep = nm.nm_topk_mask(scoring.score_activations(x, sc), 8, 16)
    assert torch.equal(keep.view(torch.bool), want_keep)
    assert bool(keep[1, :8].all()) and not bool(keep[1, 8:16].any())
    outs = []
    for via_kernel in (True, False):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        ba = b.clone().requires_grad_() if bias else None
        n0 = knm.nm_prune_matmul.launches
        if via_kernel:
            y = knm.nm_prune_matmul(xa, wa, sc, 8, 16, bias=ba)
            assert knm.nm_prune_matmul.launches == n0 + 1
        else:
            y = torch.where(want_keep, xa, torch.zeros((), dtype=dtype, device="cuda")) @ wa
            y = y if ba is None else y + ba
        y.backward(dy)
        outs.append([y.detach(), xa.grad, wa.grad] + ([ba.grad] if bias else []))
    for got, want in zip(*outs):
        _close(got, want, dtype)
    assert bool((outs[0][1][1, :8] != 0).any())          # kept zeros pass their gradient
    assert not bool(outs[0][1][1, 8:16].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,scaled", [(37, 96, True), (256, 2048, False), (2048, 768, False)])
def test_prune_function_matches_plain_autograd(gen, dtype, t, d, scaled):
    """``nm_prune``'s ``Prune`` on the card (one kernel launch writing its
    keep-mask) against the plain path's autograd, with a whole 16-group of
    zeros and a lone zero: the mask is the plain selection bit for bit and
    the output and ``dX`` are bit-exact (the kept zeros pass their
    gradient); off autograd the launch writes no mask."""
    x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    x[1, :16] = 0
    x[2, 5] = 0
    sc = torch.rand(d, generator=gen, device="cuda") + 0.5 if scaled else None
    dy = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    out, keep = knp._launch(x, sc, 8, 16, with_keep=True)
    want_keep = nm.nm_topk_mask(scoring.score_activations(x, sc), 8, 16)
    assert torch.equal(keep.view(torch.bool), want_keep)
    assert knp._launch(x, sc, 8, 16, with_keep=False)[1] is None
    outs = []
    for via_kernel in (True, False):
        xa = x.clone().requires_grad_()
        n0 = knp.nm_prune.launches
        if via_kernel:
            y = knp.nm_prune(xa, sc, 8, 16)
            assert knp.nm_prune.launches == n0 + 1
        else:
            y = torch.where(want_keep, xa, torch.zeros((), dtype=dtype, device="cuda"))
        y.backward(dy)
        outs.append((y.detach(), xa.grad))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert torch.equal(outs[0][1][1, :8], dy[1, :8])     # kept zeros pass their gradient
    assert not bool(outs[0][1][1, 8:16].any())


# ------------------------------------------------ tensor-parallel shards
# Each sharded entry point's shards computed in this one process, each with
# the unsharded call's plan, concatenated: bit-identical to the unsharded
# launch (the gathers are concatenations).  Each case also shows that a
# shard's own plan differs, which would sum in another order.

def _column_shards(full, tp, fn):
    """``fn(r)`` for every rank's shard, concatenated along the last axis."""
    return torch.cat([fn(r) for r in range(tp)], dim=-1)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_nm_prune_matmul_shards_take_the_full_plan(gen, tp):
    from repro_torch.distributed.tp import shard_columns

    x = torch.randn(256, 4096, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(4096, 4096, generator=gen, device="cuda") * 4096**-0.5).bfloat16()
    sc = torch.rand(4096, generator=gen, device="cuda") + 0.5
    b = (torch.randn(4096, generator=gen, device="cuda") * 0.1).bfloat16()
    plan = knm.gemm_plan(w, 256)
    assert knm.gemm_plan(shard_columns(w, 0, tp), 256) != plan
    got = _column_shards(w, tp, lambda r: knm.nm_prune_matmul(
        x, shard_columns(w, r, tp), sc, 8, 16, bias=shard_columns(b, r, tp), plan=plan))
    assert torch.equal(got, knm.nm_prune_matmul(x, w, sc, 8, 16, bias=b))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_nm_spmm_shards_take_the_full_plan(gen, tp):
    from repro_torch.distributed.tp import shard_columns

    x = torch.randn(512, 3584, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(3584, 3584, generator=gen, device="cuda") * 3584**-0.5).bfloat16()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = kns.gemm_plan(x.dtype, 512, 3584, 3584, 8, 16, 256, True, sms)
    assert kns.gemm_plan(x.dtype, 512, 3584, 3584 // tp, 8, 16, 256, True, sms) != plan
    got = _column_shards(w, tp, lambda r: kns.nm_spmm(x, shard_columns(w, r, tp), None, 8,
                                                       16, plan=plan))
    assert torch.equal(got, kns.nm_spmm(x, w, None, 8, 16))


@pytest.mark.parametrize("t,prune", [(256, True), (4, False)], ids=["prefill", "decode"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_osparse_matmul_shards_take_the_full_plan(gen, tp, t, prune):
    from repro_torch.distributed.tp import shard_columns

    x = torch.randn(t, 4096, generator=gen, device="cuda").bfloat16()
    wq = quant.k_major(torch.randint(-127, 128, (4096, 4096), generator=gen,
                                     device="cuda").to(torch.int8))
    smooth = torch.rand(4096, generator=gen, device="cuda") + 0.5
    amber = torch.rand(4096, generator=gen, device="cuda") + 0.5
    ws = torch.rand(4096, generator=gen, device="cuda") * 1e-3
    act = torch.full((1,), 0.02, device="cuda")
    plan = kos.call_plan(x, wq, smooth, amber, 16, prune, False)
    shard = shard_columns(wq, 1, tp)
    assert shard.data_ptr() == wq.data_ptr() + 4096 * 4096 // tp     # a view
    assert kos.call_plan(x, shard, smooth, amber, 16, prune, False) != plan
    got = _column_shards(wq, tp, lambda r: kos.osparse_matmul(
        x, shard_columns(wq, r, tp), smooth, amber, shard_columns(ws, r, tp), 8, 16,
        act_scale=act, prune=prune, plan=plan))
    assert torch.equal(got, kos.osparse_matmul(x, wq, smooth, amber, ws, 8, 16,
                                               act_scale=act, prune=prune))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_w8a8_matmul_shards_take_the_full_plan(gen, tp):
    from repro_torch.distributed.tp import shard_columns

    xq = torch.randint(-127, 128, (256, 4096), generator=gen, device="cuda").to(torch.int8)
    wq = quant.k_major(torch.randint(-127, 128, (4096, 4096), generator=gen,
                                     device="cuda").to(torch.int8))
    ws = torch.rand(4096, generator=gen, device="cuda") * 1e-3
    xs = torch.full((1,), 0.02, device="cuda")
    plan = kw8.call_plan(xq, wq)
    assert kw8.call_plan(xq, shard_columns(wq, 0, tp)) != plan
    got = _column_shards(wq, tp, lambda r: kw8.w8a8_matmul(
        xq, shard_columns(wq, r, tp), xs, shard_columns(ws, r, tp), plan=plan))
    assert torch.equal(got, kw8.w8a8_matmul(xq, wq, xs, ws))


def _heads(t, r, tp):
    h = t.shape[2] // tp
    return t[:, :, r * h:(r + 1) * h].contiguous()


@pytest.mark.parametrize("case", ["chunk", "decode"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_paged_attention_head_shards_take_the_full_plan(gen, tp, case):
    """LLaMA-3.1-8B's heads (32 / 8 of 128): a 256-token chunk and a decode
    batch of 4 over each rank's share of the pools."""
    b, tq, kv_len, qoff = ((1, 256, [700], [444]) if case == "chunk"
                           else (4, 1, [701, 514, 65, 2], [700, 513, 64, 1]))
    q, kp, vp, tab, qo, kvl = _paged_case(gen, b, tq, 32, 8, 128, 16, kv_len, qoff)
    kp, vp = kp.nan_to_num(), vp.nan_to_num()
    plan = kpa.call_plan(q, kp, vp, tab)
    # a shard of fewer heads leaves more SMs idle, so it would split its walk
    assert kpa.call_plan(_heads(q, 0, tp), _heads(kp, 0, tp), _heads(vp, 0, tp), tab) != plan
    got = torch.cat([kpa.paged_attention(_heads(q, r, tp), _heads(kp, r, tp),
                                         _heads(vp, r, tp), tab, qo, kvl, causal=tq > 1,
                                         plan=plan) for r in range(tp)], dim=2)
    assert torch.equal(got, kpa.paged_attention(q, kp, vp, tab, qo, kvl, causal=tq > 1))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_paged_kv_scatter_into_head_shards(gen, tp):
    kp, vp, tab = _paged(gen, torch.bfloat16, 3, 8, 128, 16, 6, [90, 20, 33])
    kp, vp = kp.nan_to_num(), vp.nan_to_num()
    kn = torch.randn(3, 24, 8, 128, generator=gen, device="cuda").bfloat16()
    vn = torch.randn(3, 24, 8, 128, generator=gen, device="cuda").bfloat16()
    pos = torch.tensor([70, 20, 9], dtype=torch.int32, device="cuda")
    clen = torch.tensor([24, 13, 5], dtype=torch.int32, device="cuda")
    shards = [(_heads(kp, r, tp), _heads(vp, r, tp)) for r in range(tp)]
    for r, (k_r, v_r) in enumerate(shards):
        kpa.paged_kv_scatter(_heads(kn, r, tp), _heads(vn, r, tp), k_r, v_r, tab, pos, clen)
    kpa.paged_kv_scatter(kn, vn, kp, vp, tab, pos, clen)
    assert torch.equal(torch.cat([k for k, _ in shards], dim=2), kp)
    assert torch.equal(torch.cat([v for _, v in shards], dim=2), vp)


# ------------------------------------------------------------- sharded cells
# A cell holds its column-parallel weights as shards already: the kernel
# plans for the whole weight's columns (``tp.full_cols``), so the shard sums
# in the unsharded call's order.  The MoE's slot tensors prune on the kernel.

@pytest.mark.parametrize("parts", [2, 4])
def test_cell_held_column_shard_takes_the_full_plan(gen, parts):
    from repro_torch.distributed import sharding, tp
    from repro_torch.launch.mesh import abstract_mesh

    x = torch.randn(256, 4096, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(4096, 4096, generator=gen, device="cuda") * 4096**-0.5).bfloat16()
    sc = torch.rand(4096, generator=gen, device="cuda") + 0.5
    want = knm.nm_prune_matmul(x, w, sc, 8, 16)
    mesh = abstract_mesh((1, parts), ("data", "model"))
    c = 4096 // parts
    for r in range(parts):
        shard = sharding.tag(w[:, r * c:(r + 1) * c].contiguous(), (None, "model"), mesh,
                             w.shape)
        assert tp.full_cols(shard) == 4096
        assert torch.equal(tp.shard_columns(shard, r, parts), shard)   # taken as it is
        plan = knm.gemm_plan(shard, 256, tp.full_cols(shard))
        assert plan == knm.gemm_plan(w, 256) != knm.gemm_plan(shard, 256)
        got = knm.nm_prune_matmul(x, shard, sc, 8, 16, plan=plan)
        assert torch.equal(got, want[:, r * c:(r + 1) * c])


def test_cell_moe_slots_prune_on_the_kernel(gen):
    from repro_torch import kernels
    from repro_torch.core.policy import paper_policy
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe

    d, f, e = 256, 128, 8
    p = moe.init_moe(d, f, e, False, dtype=torch.bfloat16, device="cuda", generator=gen)
    x = torch.randn(2, 64, d, generator=gen, device="cuda").bfloat16()
    pol = paper_policy(8, 16)
    kernels.reset_launch_counts()
    got = moe._moe_shard_map(make_local_mesh(), x, p, pol.with_(use_kernels=True), "prefill",
                             2, "silu", None)
    assert kernels.launch_counts()["nm_prune"] == 2          # the gate and down inputs
    want = moe._moe_shard_map(make_local_mesh(), x, p, pol, "prefill", 2, "silu", None)
    assert torch.equal(got, want)


# --------------------------------------------------------------- the dry-run
# ``chip_smoke.py``'s 16a and 16b at smoke size: a dry rank (``meta``,
# ``sharding.Mesh.at``) holds the bytes and records the collectives that two
# ranks of the card (gloo) hold and run; the dry-run's bound of a one-rank
# cell on the kernels does not exceed its busy time on the card.

def _dryrun_cells():
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.policy import paper_policy
    from repro_torch.launch.cells import build_cell

    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="bfloat16")
    pol = paper_policy(8, 16, cfg.qgate_skip_layers, use_kernels=True)
    return {
        "prefill": lambda m: build_cell("llama31_8b", "prefill_32k", m, cfg=cfg, policy=pol,
                                        shape=ShapeCell("cut", 64, 4, "prefill")),
        "decode": lambda m: build_cell("llama31_8b", "decode_32k", m, cfg=cfg,
                                       shape=ShapeCell("cut", 64, 4, "decode")),
    }


def _dryrun_step(cell, device):
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun

    state = cell.materialize(0, device)
    with sharding.recording() as log:
        cell.run(state)
    return dryrun.state_bytes(state), [r[:3] for r in log]


def dryrun_card_rank(mesh):
    """A rank of the (1, 2) cell mesh on the card: each smoke cell's held
    bytes and recorded collectives, gathered to every rank."""
    import torch.distributed as dist

    mine = {name: _dryrun_step(build(mesh), "cuda") for name, build in _dryrun_cells().items()}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return everyone


def test_dryrun_ranks_equal_two_ranks_of_the_card(gen, tmp_path):
    from repro_torch.launch.mesh import abstract_mesh, spawn

    ranks = spawn(dryrun_card_rank, 2, device="cuda", store_dir=str(tmp_path),
                  grid=((1, 2), ("data", "model")))
    for rank, got in enumerate(ranks):
        for name, build in _dryrun_cells().items():
            dry = _dryrun_step(build(abstract_mesh((1, 2), ("data", "model")).at(rank)), "meta")
            assert dry == got[name] and got[name][1], (rank, name)


@pytest.mark.parametrize("name", ["prefill", "decode"])
def test_dryrun_bound_within_the_card_busy_time(gen, name):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_local_mesh

    cell = _dryrun_cells()[name](make_local_mesh())
    _, count = roofline.count_step(cell.run, cell.materialize(device="meta"),
                                   args_bytes=dryrun.args_bytes(cell))
    kind = cell.shape.kind
    tokens = cell.shape.global_batch * (cell.shape.seq_len if kind == "prefill" else 1)
    rep = roofline.analyze("llama31_8b", name, "1x1", count, cell.cfg, kind, tokens,
                           roofline.HW.for_card(torch.cuda.get_device_name(0)))
    state = cell.materialize(0, "cuda", filled=60 if kind == "decode" else None)
    cell.run(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cell.run(state)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    assert busy > 0
    assert rep.bound_s * 1e6 <= 1.05 * busy
    if kind == "prefill":
        assert count.unit_counts()["nm_prune_matmul"] > 0
