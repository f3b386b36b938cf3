"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU.  Every test here is marked ``cuda`` and skips without a card
(the kernels have no CPU form).  The file imports torch only, so it also
runs where JAX is not installed::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import nm_prune_matmul as knm
from repro_torch.kernels import paged_attention as kpa

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
