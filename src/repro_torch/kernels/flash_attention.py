"""Attention over contiguous K/V: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention_pallas`` (with ``softmax_init``/``softmax_update``/
``softmax_finalize``): ``q (B, T, Hq, hd)`` attends to ``k``/``v (B, S,
Hkv, hd)``, causal or not, with an optional sliding-window band (``window
> 0``: key ``p`` visible to query ``t`` iff ``p > t - window``); the keys
may be longer or shorter than the queries (``S != T``) only without a
causal mask or a band, as in the JAX kernel's test of keys longer than its
queries — the reference kernel counts both positions from 0 there, while
its oracle aligns the last query with the last key, so a causal or banded
``S != T`` call has no one meaning and raises ``ValueError``; query head
``h`` reads KV head ``h // (Hq // Hkv)``;
float32 softmax; the output is in q's dtype and the scale is ``hd**-0.5``.
The port's ``(B, T, H, hd)`` layout is taken as it is: nothing is
transposed and no KV head is repeated.  The kernel masks its own ragged
edge, so every ``T`` is served (the JAX package's ``attention`` takes its
jnp scan when ``T % min(128, T) != 0``; the port has no such gate).

``csrc/flash_attention.cu`` says what bounds the kernel on the H100 and how
its design answers it.  :func:`flash_plan` picks the kernel: bf16 at a
head_dim that is a multiple of 8 with 16-byte-aligned q/k/v takes the wgmma
kernel (TMA ring, S and P in registers) on the tile of 64, 128 or 256
columns that holds the head_dim, padded to it; float32, other head sizes
and unaligned tensors take the CUDA-core rows kernel — a shape route
between two hand kernels, not a fallback: a call the plan gives the wgmma
kernel launches it or raises.  The wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``flash_attention.launches`` counts kernel launches and
``flash_attention.route_launches`` them by route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _meta

__all__ = ["flash_attention", "flash_attention_plain", "flash_plan"]

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:116"
_MAX_HD = 256
_SYMBOLS = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}
ROUTES = ("wgmma", "rows")
# the wgmma kernel's builds: (tile width, consumer warpgroups), narrowest first
_TILES = ((64, 3), (128, 2), (256, 1))


def flash_plan(dtype: torch.dtype, hd: int, aligned: bool) -> tuple[str, int, int]:
    """The kernel for one call: ``(route, tile width, consumer warpgroups)``.

    ``("wgmma", tile, nwg)``: bf16, ``hd`` a multiple of 8, ``aligned`` (q,
    k, v and the output 16-byte aligned).  The tile is the narrowest of 64,
    128 and 256 columns that holds ``hd`` (hd 80 pads to 128, hd 160 to 256;
    the padded columns are zeros that the kernel never stores), and ``nwg``
    64-row warpgroups share each K/V tile: 3 at tile 64, 2 at 128, 1 at 256
    (whose K/V ring and 128 accumulator registers a thread leave room for
    no second one).
    ``("rows", 0, 0)``: the CUDA-core kernel, for the rest.
    """
    if dtype == torch.bfloat16 and aligned and hd > 0 and hd % 8 == 0:
        for tile, nwg in _TILES:
            if hd <= tile:
                return "wgmma", tile, nwg
    return "rows", 0, 0


def _lib():
    lib = _build.load("flash_attention.cu")
    for sym in _SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.flash_attention_wgmma_bf16.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    lib.flash_attention_wgmma_bf16.restype = ctypes.c_int
    return lib


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version (``repro/kernels/ref.py:flash_attention_ref``): one dense
    float32 softmax over all ``S`` keys, masked with -inf, in the grouped
    ``(B, T, Hkv, G, hd)`` view (a causal or banded mask aligns the last
    query with the last key, as the oracle does; the wrapper takes such
    masks only at ``S == T``)."""
    b, t, hq, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, t, hkv, hq // hkv, hd)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * hd**-0.5
    q_pos = torch.arange(t, device=q.device)[:, None] + (s_len - t)
    k_pos = torch.arange(s_len, device=q.device)[None, :]
    mask = torch.ones((t, s_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return o.reshape(b, t, hq, hd).to(q.dtype)


def _check_lengths(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int) -> None:
    if k.dim() == 4 and q.dim() == 4 and k.shape[1] != q.shape[1] and (causal or window > 0):
        raise ValueError(f"flash_attention: {k.shape[1]} keys for {q.shape[1]} queries take "
                         "neither a causal mask nor a band (S != T: non-causal, window 0)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of ``q (B, T, Hq, hd)`` over ``k``/``v (B, S, Hkv, hd)`` →
    ``(B, T, Hq, hd)`` in q's dtype; ``window > 0`` adds the sliding band.
    ``S != T`` only with ``causal=False`` and ``window=0``."""
    _check_lengths(q, k, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if q.device.type == "meta":
        return _meta.flash_attention(q, k, v, causal, window)
    what = "flash_attention"
    _build.refuse_grad(what, q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device != q.device or not a.is_contiguous() or a.dim() != 4:
            raise ValueError(f"{what}: {name} must be a contiguous 4-d tensor on {q.device}")
    b, t, hq, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    if (v.shape != k.shape or k.shape[0] != b or s_len == 0 or k.shape[3] != hd
            or hkv == 0 or hq % hkv != 0):
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)} "
                         "(same B and head_dim, at least one key, Hq a multiple of Hkv)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SYMBOLS:
        raise TypeError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel takes "
                        "bfloat16 or float32 throughout")
    if not 0 < hd <= _MAX_HD:
        raise ValueError(f"{what}: head_dim {hd} outside (0, {_MAX_HD}]")
    if max(*q.shape, s_len) >= 2**31:
        raise ValueError(f"{what}: dimension exceeds int32")
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    route, tile, nwg = flash_plan(q.dtype, hd,
                                  all(a.data_ptr() % 16 == 0 for a in (q, k, v, out)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, s_len, hq, hkv,
            hd, int(causal), int(window), hd**-0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma":
            rc = _lib().flash_attention_wgmma_bf16(*args, tile, nwg, stream)
        else:
            rc = getattr(_lib(), _SYMBOLS[q.dtype])(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed on the {route} route (CUDA error "
                           f"{rc})")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
