"""Each hand kernel as one unit on ``meta`` tensors.

A wrapper given ``meta`` tensors (the dry-run, ``launch/dryrun.py``) calls
its function here instead of launching or running its plain version: the
result is a ``meta`` tensor of the wrapper's shape and dtype, and the unit
tells the step counter (``launch/roofline.count_step``, through
:data:`_sink`) what the kernel needs and no more: its operands read once,
its result written once (or, for the KV scatter, the rows written in
place), and the products its inputs need, by class (``"bf16"`` for bf16 or
fp16 operands, ``"fp32"``, ``"int8"``):

* per-token N:M (``nm_prune_matmul``, ``nm_spmm``'s compacted product,
  ``osparse_matmul`` with ``prune``): the kept ``D·N/M`` of each row,
  ``2·T·(D·N/M)·N_out``;
* the int8 GEMMs (``osparse_matmul``, ``w8a8_matmul``): int8 operations;
* attention: ``4·hd`` a (query head, key) pair that the mask keeps, where
  the lengths are known on the host; the paged kernel reads its lengths
  from the device, so on ``meta`` it counts every key its table can map.

So a kernel's count is the same whatever implements it.  No launch counter
moves: nothing launches.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["product_class"]

# the step counter's hook: (kernel, reads, outs, ops, wrote) → None, where
# reads holds tensors or (tensor, bytes) pairs, ops {class: operations} and
# wrote the bytes written in place
_sink: Optional[Callable] = None


def product_class(dtype: torch.dtype) -> str:
    if dtype == torch.int8:
        return "int8"
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "fp32"


def _unit(kernel: str, reads, out, ops: dict, wrote: int = 0):
    if _sink is not None:
        outs = [] if out is None else list(out) if isinstance(out, tuple) else [out]
        _sink(kernel, [r for r in reads if r is not None], outs, ops, wrote)
    return out


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _kept(d: int, n: int, m: int) -> int:
    return d * n // m


def nm_prune_matmul(x, w, scale, n, m, bias):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"nm_prune_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    t, d = x.shape
    out = _empty((t, w.shape[1]), torch.result_type(x, w))
    return _unit("nm_prune_matmul", (x, w, scale, bias), out,
                 {product_class(x.dtype): 2 * t * _kept(d, n, m) * w.shape[1]})


def nm_prune(x, scale, n, m):
    return _unit("nm_prune", (x, scale), _empty(x.shape, x.dtype), {})


def nm_spmm(x, w, scale, n, m):
    t, d = x.shape
    out = _empty((t, w.shape[1]), x.dtype)
    return _unit("nm_spmm", (x, w, scale), out,
                 {product_class(x.dtype): 2 * t * _kept(d, n, m) * w.shape[1]})


def osparse_matmul(x, wq, smooth, amber, w_scale, n, m, act_scale, bias, prune):
    t, d = x.shape
    out = _empty((t, wq.shape[1]), torch.float32)
    k = _kept(d, n, m) if prune else d
    return _unit("osparse_matmul", (x, wq, smooth, amber, w_scale, act_scale, bias), out,
                 {"int8": 2 * t * k * wq.shape[1]})


def w8a8_matmul(xq, wq, x_scale, w_scale):
    t, d = xq.shape
    out = _empty((t, wq.shape[1]), torch.float32)
    return _unit("w8a8_matmul", (xq, wq, x_scale, w_scale), out,
                 {"int8": 2 * t * d * wq.shape[1]})


def paged_kv_scatter(k_new, v_new, block_table, pos, chunk_len):
    wrote = 2 * k_new.numel() * k_new.element_size()
    _unit("paged_kv_scatter", (k_new, v_new, block_table, pos, chunk_len), None, {}, wrote)


def paged_attention(q, k_pool, v_pool, block_table, q_offset, kv_len):
    b, tq, hq, hd = q.shape
    keys = block_table.shape[1] * k_pool.shape[1]
    row = k_pool.shape[2] * k_pool.shape[3] * k_pool.element_size()
    pools = min(k_pool.numel() * k_pool.element_size(), b * keys * row)
    return _unit("paged_attention", (q, (k_pool, pools), (v_pool, pools), block_table,
                                     q_offset, kv_len), _empty(q.shape, q.dtype),
                 {product_class(q.dtype): 4 * b * hq * hd * tq * keys})


def _pairs(t: int, s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps (the last query aligned with the
    last key)."""
    if not causal and window <= 0:
        return t * s
    total = 0
    for i in range(t):
        hi = i + (s - t) + 1 if causal else s
        lo = max(0, i + (s - t) - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def flash_attention(q, k, v, causal, window):
    b, t, hq, hd = q.shape
    ops = 4 * b * hq * hd * _pairs(t, k.shape[1], causal, window)
    return _unit("flash_attention", (q, k, v), _empty(q.shape, q.dtype),
                 {product_class(q.dtype): ops})
