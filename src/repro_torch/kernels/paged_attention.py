"""Paged KV scatter and paged attention: the CUDA kernels' wrappers and their
plain PyTorch versions.

``paged_kv_scatter`` replaces ``repro/kernels/paged_attention.py:
paged_kv_scatter_pallas``: write chunk rows ``[pos, pos + chunk_len)`` of
``k_new``/``v_new (B, T, Hkv, hd)`` into the pools ``(rows, block_size,
Hkv, hd)`` through the block table.  Rows whose logical block is ``-1`` or
past the table width are dropped.  It updates the pools **in place** (the
TPU kernel aliases them input→output), is bit-exact, and is bound by bytes.
The kernel (one warp per row, 16-byte words, or bytes for rows that are
not 16-byte multiples or not aligned) is launched as a programmatic
dependent of the kernel before it, and reads ``block_table``, ``pos`` and
``chunk_len`` before it waits for that kernel: they must have been written
before it (the model builds them once a step, before its first layer).

``paged_attention`` replaces ``repro/kernels/paged_attention.py:
paged_attention_pallas``: attention of ``q (B, Tq, Hq, hd)`` over the paged
pools.  It walks the table, skips ``-1`` blocks, masks by absolute
position (``q_offset[b] + row`` against the key position, and
``k_pos < kv_len[b]``), zeroes V rows past ``kv_len`` so unwritten pool
memory cannot reach the output, maps query head ``h`` to KV head
``h // (Hq // Hkv)``, and gives zeros for a fully masked row.  Any ``Tq``
is served, decode's ``Tq = 1`` included.  ``csrc/paged_attention.cu`` says
what bounds each kernel on the H100 and how the design answers it;
:func:`attention_plan` picks the kernel from the shapes: the wgmma kernel
(GQA heads packed into its rows, K/V pages by TMA, the key walk split over
blocks) for bf16 at head_dim 64/128 with a block size TMA can box and
16-byte-aligned tensors, the CUDA-core kernel for everything else.  Shape
routes between hand kernels, not fallbacks.  No sliding-window band: the
JAX kernel's ``window`` comes with the sliding-window models.

Each wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  ``paged_kv_scatter.launches`` and
``paged_attention.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _capture

__all__ = ["attention_plan", "paged_kv_scatter", "paged_kv_scatter_plain",
           "paged_attention", "paged_attention_plain"]

SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
SCATTER_REPLACES = "src/repro/kernels/paged_attention.py:263"
ATTENTION_REPLACES = "src/repro/kernels/paged_attention.py:130"
_NEG = -1e30
_MAX_HD = 256
_TILE_ROWS = 16        # flattened (query, GQA head) rows of one CUDA-core tile
_ATTN_SYMBOLS = {torch.bfloat16: "paged_attention_bf16",
                 torch.float32: "paged_attention_f32"}
_H100_SMS = 132
_KEY_TILE = 64         # keys of one wgmma tile
_MAX_SPLITS = 16       # the wgmma kernel's merge holds 16 walks' weights
# per (device, stream): int32 ticket counters of the split wgmma walk, one
# per query tile; every launch leaves them 0 (the merging block resets its
# own).  Launches on one stream run one after another, so they may share a
# set; a launch on another stream gets its own, and a launch captured in a
# CUDA graph the set of that graph (``_capture.Graph.tickets``), so a replay
# never shares its counters with an eager call or with another graph.
_TICKETS: dict = {}


def _lib():
    lib = _build.load("paged_attention.cu")
    lib.paged_kv_scatter.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    lib.paged_kv_scatter.restype = ctypes.c_int
    for sym in _ATTN_SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.paged_attention_wgmma_bf16.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.paged_attention_wgmma_bf16.restype = ctypes.c_int
    return lib


def _check_cuda(device: torch.device, what: str, **tensors) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    for name, a in tensors.items():
        if a.device != device or not a.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {device}")


def _check_index(what: str, b: int, table, **vecs) -> None:
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"{what}: block_table must be int32 (B, max_blocks)")
    for name, v in vecs.items():
        if v.dtype != torch.int32 or v.shape != (b,):
            raise ValueError(f"{what}: {name} must be int32 of shape (B,)")


# ------------------------------------------------------------------ scatter

def paged_kv_scatter_plain(k_new, v_new, k_pool, v_pool, block_table, pos,
                           chunk_len) -> None:
    """Plain version: select the kept (b, t) rows, then one indexed copy
    per pool.  Updates the pools in place."""
    b, t = k_new.shape[:2]
    nb, bs = k_pool.shape[:2]
    mb = block_table.shape[1]
    i = torch.arange(t, device=k_new.device)
    wpos = pos.long()[:, None] + i[None, :]
    lb = torch.div(wpos, bs, rounding_mode="floor")
    pb = block_table.long().gather(1, lb.clamp(0, mb - 1))
    keep = ((i[None, :] < chunk_len.long()[:, None]) & (wpos >= 0) & (lb < mb)
            & (pb >= 0) & (pb < nb))
    bi, ti = keep.nonzero(as_tuple=True)
    rows = pb[bi, ti] * bs + wpos[bi, ti] % bs
    k_pool.view(nb * bs, *k_pool.shape[2:])[rows] = k_new[bi, ti]
    v_pool.view(nb * bs, *v_pool.shape[2:])[rows] = v_new[bi, ti]


def paged_kv_scatter(k_new, v_new, k_pool, v_pool, block_table, pos,
                     chunk_len) -> None:
    """Write ``k_new``/``v_new (B, T, Hkv, hd)`` rows into the pools in
    place.  ``pos``/``chunk_len``: ``(B,)`` int32 absolute position of row 0
    and number of valid rows; ``block_table``: ``(B, max_blocks)`` int32."""
    if k_new.device.type == "cpu":
        return paged_kv_scatter_plain(k_new, v_new, k_pool, v_pool,
                                      block_table, pos, chunk_len)
    what = "paged_kv_scatter"
    _check_cuda(k_new.device, what, k_new=k_new, v_new=v_new, k_pool=k_pool,
                v_pool=v_pool, block_table=block_table, pos=pos,
                chunk_len=chunk_len)
    if (k_new.dim() != 4 or v_new.shape != k_new.shape
            or k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or k_new.shape[2:] != k_pool.shape[2:]
            or not (k_new.dtype == v_new.dtype == k_pool.dtype == v_pool.dtype)):
        raise ValueError(f"{what}: chunk {tuple(k_new.shape)} {k_new.dtype} does not "
                         f"fit pool {tuple(k_pool.shape)} {k_pool.dtype}")
    b, t = k_new.shape[:2]
    _check_index(what, b, block_table, pos=pos, chunk_len=chunk_len)
    if b == 0 or t == 0:
        return
    nb, bs = k_pool.shape[:2]
    row_bytes = k_pool[0, 0].numel() * k_pool.element_size()
    vec = row_bytes % 16 == 0 and all(a.data_ptr() % 16 == 0
                                      for a in (k_new, v_new, k_pool, v_pool))
    with torch.cuda.device(k_new.device):
        rc = _lib().paged_kv_scatter(
            k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), pos.data_ptr(),
            chunk_len.data_ptr(), b, t, block_table.shape[1], bs, nb, row_bytes,
            int(vec), torch.cuda.current_stream(k_new.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_kv_scatter kernel launch failed (CUDA error {rc})")
    paged_kv_scatter.launches += 1


paged_kv_scatter.launches = 0


# ---------------------------------------------------------------- attention

def paged_attention_plain(q, k_pool, v_pool, block_table, q_offset, kv_len,
                          causal: bool = True) -> torch.Tensor:
    """Plain version: gather every table row's logical view, mask, and run
    one float32 softmax over all keys (-1e30 sentinel, guarded weights,
    ``l`` clamped at 1e-20 — the kernel's fully-masked-row semantics)."""
    b, tq, hq, hd = q.shape
    nb, bs, hkv = k_pool.shape[:3]
    mb = block_table.shape[1]
    g = hq // hkv
    tab = block_table.long()
    allocated = (tab >= 0) & (tab < nb)
    idx = tab.clamp(0, nb - 1)
    s_len = mb * bs
    k = k_pool[idx].reshape(b, s_len, hkv, hd).float()
    v = v_pool[idx].reshape(b, s_len, hkv, hd).float()
    kpos = torch.arange(s_len, device=q.device)
    live = allocated.repeat_interleave(bs, dim=1) & (kpos[None, :] < kv_len.long()[:, None])
    v = torch.where(live[:, :, None, None], v, torch.zeros((), device=q.device))
    qpos = q_offset.long()[:, None] + torch.arange(tq, device=q.device)[None, :]
    valid = live[:, None, :]                                   # (B, 1|Tq, S)
    if causal:
        valid = valid & (kpos[None, None, :] <= qpos[:, :, None])
    qg = q.float().reshape(b, tq, hkv, g, hd) * hd**-0.5
    s = torch.einsum("bthgd,bshd->bhgts", qg, k)
    s = torch.where(valid[:, None, None], s, torch.full((), _NEG, device=q.device))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > _NEG / 2, torch.exp(s - mx), torch.zeros((), device=q.device))
    l_sum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgts,bshd->bhgtd", p, v) / l_sum.clamp_min(1e-20)
    return o.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, hd).to(q.dtype)


def attention_plan(dtype: torch.dtype, b: int, tq: int, hq: int, hkv: int, hd: int,
                   bs: int, mb: int, aligned: bool,
                   sms: int = _H100_SMS) -> tuple[str, int, int, int]:
    """The kernel for one call: ``(route, tokens per query tile, splits,
    walk per split)``, from the shapes alone (no device values: ``kv_len``
    stays on the card, so the split is sized by the table width ``mb`` and
    splits past a row's ``kv_len`` end at once).

    * ``("wgmma", nt, n_split, per)``: bf16, ``hd`` 64 or 128, ``bs`` a
      multiple of 8 that divides 64 or a multiple of 64 (the TMA boxes a
      page), ``aligned`` (q and the pools 16-byte aligned), at most 64 query
      heads per KV head.  A query tile is ``nt`` tokens of all ``G = hq //
      hkv`` heads of a KV head (``nt * G <= 64`` wgmma rows); a row's key
      tiles of 64 are split into ``n_split`` walks of ``per`` tiles only
      where the query tiles leave SMs without a block, and into at most 16
      and 256 / rows walks: the last block merges them, at a cost that grows
      with walks times rows.  Decode (4 or 7 rows) splits; a serving chunk
      of 256 tokens does not.
    * ``("rows", 0, n_split, per)``: the CUDA-core kernel; decode (all of a
      row's query heads in one 16-row tile) over a table of at least 8
      blocks splits its walk into up to 32 ranges of ``per`` blocks, merged
      by a combine kernel.
    """
    g = hq // hkv
    if (dtype == torch.bfloat16 and hd in (64, 128) and aligned and bs > 0 and bs % 8 == 0
            and (_KEY_TILE % bs == 0 or bs % _KEY_TILE == 0) and g <= _KEY_TILE):
        nt = min(_KEY_TILE // g, tq)
        blocks = b * hkv * -(-tq // nt)
        tiles = max(1, -(-mb * bs // _KEY_TILE))
        n_split = min(tiles, _MAX_SPLITS, max(1, sms // blocks), max(1, 256 // (nt * g)))
        per = -(-tiles // n_split)
        return "wgmma", nt, -(-tiles // per), per
    if tq * g <= _TILE_ROWS and mb >= 8:
        n_split = min(32, -(-mb // 4))
        return "rows", 0, n_split, -(-mb // n_split)
    return "rows", 0, 1, mb


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    graph = _capture.current()
    if graph is not None:
        if graph.tickets.numel() < n:
            raise ValueError(f"paged_attention: {n} query tiles need more than the "
                             f"{graph.tickets.numel()} ticket counters of a captured graph")
        return graph.tickets
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[device, stream] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                   device=device)
    return t


def paged_attention(q, k_pool, v_pool, block_table, q_offset, kv_len,
                    causal: bool = True) -> torch.Tensor:
    """Attention of ``q (B, Tq, Hq, hd)`` over the paged pools.

    ``q_offset``: ``(B,)`` int32 absolute position of ``q[:, 0]``;
    ``kv_len``: ``(B,)`` int32 number of valid KV positions per row.
    Returns ``(B, Tq, Hq, hd)`` in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table, q_offset,
                                     kv_len, causal)
    what = "paged_attention"
    _check_cuda(q.device, what, q=q, k_pool=k_pool, v_pool=v_pool,
                block_table=block_table, q_offset=q_offset, kv_len=kv_len)
    b, tq, hq, hd = q.shape
    if (k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or k_pool.shape[3] != hd or hq % k_pool.shape[2] != 0):
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit pool "
                         f"{tuple(k_pool.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype) or q.dtype not in _ATTN_SYMBOLS:
        raise TypeError(f"{what}: dtypes {q.dtype}/{k_pool.dtype}; the kernel takes "
                        "bfloat16 or float32 throughout")
    if hd > _MAX_HD:
        raise ValueError(f"{what}: head_dim {hd} > {_MAX_HD}")
    _check_index(what, b, block_table, q_offset=q_offset, kv_len=kv_len)
    out = torch.empty_like(q)
    if b == 0 or tq == 0:
        return out
    nb, bs, hkv = k_pool.shape[:3]
    mb = block_table.shape[1]
    aligned = all(a.data_ptr() % 16 == 0 for a in (q, k_pool, v_pool))
    route, nt, n_split, per = attention_plan(
        q.dtype, b, tq, hq, hkv, hd, bs, mb, aligned,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
            q_offset.data_ptr(), kv_len.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if route == "wgmma":
            q_tiles = b * hkv * -(-tq // nt)
            part = tickets = None
            if n_split > 1:     # per split: (max, sum) and O of 64 rows, float32
                part = torch.empty(q_tiles * n_split * 64 * (hd + 2), dtype=torch.float32,
                                   device=q.device)
                tickets = _tickets(q.device, stream, q_tiles)
            rc = _lib().paged_attention_wgmma_bf16(
                *ptrs, None if part is None else part.data_ptr(),
                None if tickets is None else tickets.data_ptr(), b, tq, hq, hkv, hd, bs,
                mb, nb, int(causal), hd**-0.5, nt, n_split, per, stream)
        else:
            part = None
            if n_split > 1:
                part = torch.empty(b * hkv * n_split * _TILE_ROWS * (2 + hd),
                                   dtype=torch.float32, device=q.device)
            rc = getattr(_lib(), _ATTN_SYMBOLS[q.dtype])(
                *ptrs, b, tq, hq, hkv, hd, bs, mb, nb, int(causal), hd**-0.5, n_split,
                None if part is None else part.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (CUDA error {rc})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
