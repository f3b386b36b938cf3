"""Attention for the dense family (port of ``repro/models/attention.py``).

* :func:`attention` — grouped-query attention of
  ``repro/models/attention.py:163``.  ``impl="flash"`` sends whole-sequence
  self-attention (``T == S > 1`` from position 0, no ``kv_len`` or
  ``kv_positions``, full or causally banded) to the ``flash_attention``
  kernel, for every ``T`` (the JAX package's ``T % 128`` gate is not carried
  over: the kernel masks its own ragged edge).  Otherwise a sliding window
  over the whole sequence takes :func:`_banded_attention` (a loop over query
  chunks, each attending its ``window + chunk`` key slab), and everything
  else the plain online softmax :func:`_kv_chunk_attention`: a Python loop
  over KV chunks carrying float32 (max, denom, acc), GQA in the grouped
  ``(B, T, Hkv, G, hd)`` layout, masked by ``kv_len``, causality and the
  window on the keys' absolute ``kv_positions`` (``-1``: never written).
* :func:`gather_kv_blocks` — the contiguous logical view of a pooled cache,
  with unallocated (``-1``) blocks zeroed.
* :func:`paged_kv_update` / :func:`paged_attention` — the paged KV write and
  read.  ``use_kernel`` sends them to the Hopper kernels, which on CUDA
  tensors launch or raise; otherwise they run the flat-index scatter oracle
  and the gather oracle below.  There is no coverage rule: the kernel
  serves every query count and window.  Under ``use_kernel`` each first
  consults its fault site (``kernel.paged_scatter``,
  ``kernel.paged_attention``; ``kernels/_faults.py``).  Under an active TP
  scope (``distributed/tp.py``) a pool that holds this rank's share of the
  KV heads takes this rank's heads of the new rows, and attention runs this
  rank's query heads over it and gathers the output along the head axis; on
  the card the kernel takes the unsharded call's plan.  Both paths shard
  (the kernel and the oracles), since the pools hold only their heads.
"""
from __future__ import annotations

import numbers
from typing import Optional, Union

import torch

from repro_torch.distributed import tp

__all__ = ["attention", "gather_kv_blocks", "paged_kv_update", "paged_attention"]

_NEG = -1e30
IntOrTensor = Union[int, torch.Tensor]


def _vec(v: IntOrTensor, b: int, device) -> torch.Tensor:
    """Scalar or (B,) → contiguous (B,) int32 on ``device``.  A Python
    number becomes a device fill, never a host-to-device copy, so the call
    can be captured in a CUDA graph."""
    if isinstance(v, numbers.Integral):
        return torch.full((b,), int(v), dtype=torch.int32, device=device)
    t = torch.as_tensor(v, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(b).contiguous() if t.numel() == 1 else t.contiguous()


def _long(v: IntOrTensor, device) -> torch.Tensor:
    """A position or length (Python number or tensor) as an int64 tensor,
    made on the device without a host-to-device copy."""
    if isinstance(v, numbers.Integral):
        return torch.full((), int(v), dtype=torch.long, device=device)
    return torch.as_tensor(v, device=device).long()


def _kv_chunk_attention(q, k, v, q_pos, causal, window, kv_len, kv_pos, chunk):
    """q (B, T, Hkv, G, hd) pre-scaled; k/v (B, S, Hkv, hd); q_pos (B|1, T);
    kv_len None or (B|1,); kv_pos (S,) absolute key positions (-1: masked).
    Returns float32 (B, T, Hkv, G, hd)."""
    B, T, Hkv, G, hd = q.shape
    S = k.shape[1]
    c = min(chunk, S)
    dev = q.device
    m = torch.full((B, T, Hkv, G), _NEG, dtype=torch.float32, device=dev)
    l_sum = torch.zeros((B, T, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, T, Hkv, G, hd), dtype=torch.float32, device=dev)
    qf = q.float()
    for start in range(0, S, c):
        kc, vc = k[:, start:start + c], v[:, start:start + c]
        slot = start + torch.arange(kc.shape[1], device=dev)
        pci = kv_pos[start:start + c]
        s = torch.einsum("bthgd,bchd->bthgc", qf, kc.float())
        # (B'|1, T'|1, c) masks broadcast against the (B, T, Hkv, G, c) tile
        mask = (pci >= 0)[None, None, :]
        if kv_len is not None:
            mask = mask & (slot[None, None, :] < kv_len.reshape(-1, 1, 1))
        if causal:
            mask = mask & (pci[None, None, :] <= q_pos[:, :, None])
        if window is not None:
            mask = mask & (pci[None, None, :] > q_pos[:, :, None] - window)
        mask = mask[:, :, None, None, :]
        s = torch.where(mask, s, torch.full((), _NEG, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=dev))
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bthgc,bchd->bthgd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    return acc / l_sum.clamp_min(1e-20)[..., None]


def _banded_attention(q, k, v, window: int, chunk: int):
    """Sliding-window causal attention over the whole sequence
    (``repro/models/attention.py:113``): q (B, T, Hkv, G, hd) pre-scaled,
    k/v (B, T, Hkv, hd).  Each chunk of ``chunk`` queries attends the
    ``window + chunk`` keys that can reach it, in one float32 softmax, so
    the work is O(T * window).  Returns float32 (B, T, Hkv, G, hd)."""
    B, T = q.shape[:2]
    cq = min(chunk, T)
    dev = q.device
    outs = []
    for s0 in range(0, T, cq):
        s1 = min(s0 + cq, T)
        lo = max(0, s0 - window)
        q_pos = torch.arange(s0, s1, device=dev)
        kv_pos = torch.arange(lo, s1, device=dev)
        s = torch.einsum("bthgd,bchd->bthgc", q[:, s0:s1].float(), k[:, lo:s1].float())
        mask = ((kv_pos[None, :] <= q_pos[:, None])
                & (kv_pos[None, :] > q_pos[:, None] - window))[None, :, None, None, :]
        s = torch.where(mask, s, torch.full((), _NEG, device=dev))
        p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                        torch.zeros((), device=dev))
        vc = v[:, lo:s1]
        o = torch.einsum("bthgc,bchd->bthgd", p.to(vc.dtype).float(), vc.float())
        outs.append(o / p.sum(dim=-1).clamp_min(1e-20)[..., None])
    return torch.cat(outs, dim=1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: IntOrTensor = 0, kv_len: Optional[IntOrTensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              chunk: int = 1024, impl: str = "chunked") -> torch.Tensor:
    """Grouped-query attention.  q (B, T, Hq, hd), k/v (B, S, Hkv, hd) →
    (B, T, Hq, hd).  ``q_offset`` / ``kv_len`` may be scalars or per-row
    ``(B,)`` vectors; ``kv_positions`` (S,) gives every key's absolute
    position (ring caches; default ``arange(S)``, ``-1`` masks a key);
    ``window`` keeps keys at ``k_pos > q_pos - window``.  ``impl="flash"``
    takes the ``flash_attention`` kernel where the JAX package takes its
    Pallas kernel (the self-attention prefill case), and the plain loops
    otherwise."""
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    from_zero = isinstance(q_offset, int) and q_offset == 0
    whole = (T == S and T > 1 and kv_len is None and kv_positions is None
             and from_zero)
    if impl == "flash" and whole and (window is None or causal):
        from repro_torch.kernels import flash_attention as kfa

        return kfa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal,
                                   window=0 if window is None else min(window, S))
    qg = (q * hd**-0.5).reshape(B, T, Hkv, Hq // Hkv, hd)
    if window is not None and whole and causal:
        out = _banded_attention(qg, k, v, min(window, S), chunk)
        return out.reshape(B, T, Hq, hd).to(q.dtype)
    qo = _long(q_offset, q.device)
    ar = torch.arange(T, device=q.device)
    q_pos = qo[:, None] + ar[None, :] if qo.dim() == 1 else (qo + ar)[None, :]
    kvl = None if kv_len is None else _long(kv_len, q.device)
    kv_pos = (torch.arange(S, device=q.device) if kv_positions is None
              else kv_positions.long())
    out = _kv_chunk_attention(qg, k, v, q_pos, causal, window, kvl, kv_pos, chunk)
    return out.reshape(B, T, Hq, hd).to(q.dtype)


# ------------------------------------------------------------ paged caches

def gather_kv_blocks(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """``(B, max_blocks * block_size, Hkv, hd)`` logical view of a pooled
    cache.  Unallocated entries are clipped to block 0 for the gather and
    then zeroed, so whatever block 0 holds (NaN included) never reaches a
    contraction."""
    nb, bs = pool.shape[:2]
    tab = block_table.long()
    g = pool[tab.clamp(0, nb - 1)]                 # (B, mb, bs, Hkv, hd)
    g = torch.where((tab >= 0)[:, :, None, None, None], g,
                    torch.zeros((), dtype=pool.dtype, device=pool.device))
    b, mb = tab.shape
    return g.reshape(b, mb * bs, *pool.shape[2:])


def paged_kv_update(k_pool: torch.Tensor, v_pool: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    block_table: torch.Tensor, pos: IntOrTensor,
                    chunk_len: Optional[IntOrTensor] = None, *,
                    use_kernel: bool = False):
    """Write new K/V rows ``(B, T, Hkv, hd)`` into the pools through the
    block table, **in place**, and return the pools.

    Rows landing on an unallocated (-1) or out-of-range block are dropped.
    ``use_kernel`` sends the write to the ``paged_kv_scatter`` kernel;
    otherwise the flat-index oracle below runs.
    """
    b, t = k_new.shape[:2]
    posv = _vec(pos, b, k_new.device)
    cl = _vec(t if chunk_len is None else chunk_len, b, k_new.device)
    out = tp.head_sharded_scatter(
        lambda kn, vn, kp, vp: _scatter(kp, vp, kn, vn, block_table, posv, cl, use_kernel),
        k_new, v_new, k_pool, v_pool)
    if out is not None:
        return out
    return _scatter(k_pool, v_pool, k_new, v_new, block_table, posv, cl, use_kernel)


def _scatter(k_pool, v_pool, k_new, v_new, block_table, posv, cl, use_kernel: bool):
    """:func:`paged_kv_update` on ``(B,)`` positions and lengths."""
    b, t = k_new.shape[:2]
    if use_kernel:
        from repro_torch.kernels import paged_attention as kpa
        from repro_torch.kernels._faults import kernel_site

        kernel_site("kernel.paged_scatter")
        kpa.paged_kv_scatter(k_new.contiguous(), v_new.contiguous(), k_pool,
                             v_pool, block_table, posv, cl)
        return k_pool, v_pool
    nb, bs = k_pool.shape[:2]
    mb = block_table.shape[1]
    i = torch.arange(t, device=k_new.device)
    wpos = posv.long()[:, None] + i[None, :]                  # (B, T) abs pos
    lb = torch.div(wpos, bs, rounding_mode="floor")
    blk = block_table.long().gather(1, lb.clamp(0, mb - 1))
    flat = torch.where((i[None, :] < cl.long()[:, None]) & (blk >= 0) & (blk < nb)
                       & (lb < mb), blk * bs + wpos % bs, nb * bs)   # OOB → dropped
    # dropped rows land on one scratch row past the pool, which is then cut
    # off: no row count is read back to the host, so a CUDA graph can
    # capture the write
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        rows = pool.view(nb * bs, *pool.shape[2:])
        ext = torch.cat([rows, rows[:1]])
        ext[flat.reshape(-1)] = new.reshape(b * t, *new.shape[2:])
        rows.copy_(ext[:-1])
    return k_pool, v_pool


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_table: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: IntOrTensor = 0,
                    kv_len: Optional[IntOrTensor] = None, chunk: int = 1024,
                    use_kernel: bool = False, kv_heads: Optional[int] = None) -> torch.Tensor:
    """Attention of ``q (B, T, Hq, hd)`` over non-contiguous physical KV
    blocks.  ``use_kernel`` sends the call to the ``paged_attention``
    kernel (which takes any T and window); otherwise the gather oracle
    runs: the logical view from :func:`gather_kv_blocks`, then
    :func:`attention`.  ``kv_heads``: the model's KV heads, of which the
    pools may hold one rank's share under a TP scope (default: the pools
    hold them all)."""
    kv_heads = k_pool.shape[2] if kv_heads is None else kv_heads
    plan = None
    if use_kernel and q.is_cuda and tp.current() is not None:
        from repro_torch.kernels import paged_attention as kpa

        # the unsharded call's plan: a shard of fewer heads would split its
        # key walk further and merge in another order
        plan = kpa.attention_plan(
            q.dtype, q.shape[0], q.shape[1], q.shape[2], kv_heads, q.shape[3],
            k_pool.shape[1], block_table.shape[1], True,
            torch.cuda.get_device_properties(q.device).multi_processor_count,
            0 if window is None else window)
    out = tp.head_sharded_attention(
        lambda q_, kp, vp: _attend(q_, kp, vp, block_table, causal, window, q_offset, kv_len,
                                   chunk, use_kernel, plan),
        q, k_pool, v_pool, kv_heads)
    if out is not None:
        return out
    return _attend(q, k_pool, v_pool, block_table, causal, window, q_offset, kv_len, chunk,
                   use_kernel, None)


def _attend(q, k_pool, v_pool, block_table, causal, window, q_offset, kv_len, chunk,
            use_kernel: bool, plan) -> torch.Tensor:
    """:func:`paged_attention` on pools that hold q's KV heads."""
    if use_kernel:
        if kv_len is None:
            raise NotImplementedError("the paged_attention kernel takes kv_len")
        from repro_torch.kernels import paged_attention as kpa
        from repro_torch.kernels._faults import kernel_site

        kernel_site("kernel.paged_attention")
        b = q.shape[0]
        return kpa.paged_attention(q.contiguous(), k_pool, v_pool, block_table,
                                   _vec(q_offset, b, q.device),
                                   _vec(kv_len, b, q.device), causal=causal,
                                   window=0 if window is None else window, plan=plan)
    k = gather_kv_blocks(k_pool, block_table)
    v = gather_kv_blocks(v_pool, block_table)
    return attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                     kv_len=kv_len, chunk=chunk)
