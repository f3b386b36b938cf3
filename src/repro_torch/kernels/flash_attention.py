"""Self-attention over contiguous K/V: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention_pallas`` (with ``softmax_init``/``softmax_update``/
``softmax_finalize``): ``q (B, T, Hq, hd)`` attends to ``k``/``v (B, T,
Hkv, hd)`` of the same length, causal or not, with an optional
sliding-window band (``window > 0``: key ``p`` visible to query ``t`` iff
``p > t - window``); query head ``h`` reads KV head ``h // (Hq // Hkv)``;
float32 softmax; the output is in q's dtype and the scale is ``hd**-0.5``.
The port's ``(B, T, H, hd)`` layout is taken as it is: nothing is
transposed and no KV head is repeated.  The kernel masks its own ragged
edge, so every ``T`` is served (the JAX package's ``attention`` takes its
jnp scan when ``T % min(128, T) != 0``; the port has no such gate).

``csrc/flash_attention.cu`` says what bounds the kernel on the H100 and how
its design answers it: bf16 at head_dim 64 or 128 with 16-byte-aligned
q/k/v takes the wgmma kernel (TMA ring, S and P in registers); float32,
other head sizes and unaligned tensors take the CUDA-core rows kernel — a
shape route between two hand kernels, not a fallback.  The wrapper runs
the plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain"]

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:116"
_MAX_HD = 256
_SYMBOLS = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}


def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention.cu"), _SYMBOLS[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version (``repro/kernels/ref.py:flash_attention_ref``): one dense
    float32 softmax over all keys, masked with -inf, in the grouped
    ``(B, T, Hkv, G, hd)`` view."""
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of ``q (B, T, Hq, hd)`` over ``k``/``v (B, T, Hkv, hd)`` →
    ``(B, T, Hq, hd)`` in q's dtype; ``window > 0`` adds the sliding band."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    what = "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device != q.device or not a.is_contiguous() or a.dim() != 4:
            raise ValueError(f"{what}: {name} must be a contiguous 4-d tensor on {q.device}")
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    if (v.shape != k.shape or k.shape[:2] != (b, t) or k.shape[3] != hd
            or hkv == 0 or hq % hkv != 0):
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)} "
                         "(self-attention: same B and T, Hq a multiple of Hkv)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SYMBOLS:
        raise TypeError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel takes "
                        "bfloat16 or float32 throughout")
    if not 0 < hd <= _MAX_HD:
        raise ValueError(f"{what}: head_dim {hd} outside (0, {_MAX_HD}]")
    if max(q.shape) >= 2**31:
        raise ValueError(f"{what}: dimension exceeds int32")
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          b, t, hq, hkv, hd, int(causal), int(window), hd**-0.5,
                          torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (CUDA error {rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
