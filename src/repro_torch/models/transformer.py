"""Decoder-only LM: the dense, MoE, VLM and recurrent families (port of
``repro/models/transformer.py``; the encoder-decoder is ``models/encdec.py``).

A :class:`Transformer` holds the embedding, an ``nn.ModuleList`` of blocks
whose kinds follow ``cfg.block_pattern`` tiled over the layers
(:func:`layer_kinds`), the final norm and the LM head.  An attention
block's feed-forward is a gated MLP, or with ``cfg.n_experts`` the routed
experts of ``models/moe.py`` (``family="moe"``).  An ``rwkv6`` block
(:class:`RWKVLayer`) is ``models/rwkv6.py``'s time and channel mix with no
norm around it; an ``rglru`` block (:class:`RGLRULayer`) is a norm, the
RG-LRU of ``models/rglru.py``, a norm and a gated MLP.  The VLM
(``family="vlm"``) is the dense family with M-RoPE (``(3, B, T)`` position
streams, all three the token positions by default) and a first chunk's
``pixel_embeds`` in place of its first ``n_patches`` rows.  Layers run as a Python
loop with a static layer index, so each projection consults the policy's
skip list directly (the JAX package scans the stacked layers and passes a
traced per-layer flag instead).  Under ``paper_policy`` this routes q_proj
and gate_proj through the fused kernel in every layer the skip list does
not name, where the JAX scan takes its mask-select form: the same function,
with more of it on the kernel.

Caches come in two layouts, both written in place.  Paged: ``{"pos",
"block_table", "layers": [{"k", "v"}, ...]}`` with per-layer pools ``(rows,
block_size, Hkv, hd)``; :func:`init_cache` gives each batch row its own
contiguous run of blocks, and serving builds a shared pool with
``serve.paged.init_paged_cache``.  Dense: ``{"pos", "layers": [{"k", "v"},
...]}`` with per-layer ``(B, s_c, Hkv, hd)`` slabs, ``s_c`` =
``min(window, max_seq)`` for sliding-window layers (a ring: position ``p``
lives in row ``p % s_c``) and ``max_seq`` otherwise.  Sliding-window layers
are never paged (:func:`paged_kv_spec`), as in the JAX package; a
full-attention model takes the dense layout when asked (``paged=False``,
the serving slab of ``serve/slots.py``).  A dense cache may carry
``"slot"``, a ``(B,)`` device index of the slab rows the batch occupies
(:func:`~repro_torch.serve.slots.slice_slot`), so a step reads and writes
one slot's rows in place without copying them out and back.

A recurrent layer's cache is its state, per batch row and in place like
the K/V: ``rwkv6`` ``{"tm_shift", "cm_shift"}`` ``(B, d)`` in the model
dtype and ``"S"`` ``(B, H, N, N)`` float32; ``rglru`` ``{"h"}`` ``(B, W)``
float32 and ``"conv"`` ``(B, cw - 1, W)`` in the model dtype.  Recurrent
layers live on the dense layout only (their state is per slot, and a
hybrid with full-attention layers, which would pool its K/V, is not ported).
:func:`prefill` starts them from zeros; :func:`prefill_chunk` carries the
state of the slot it runs on but cannot mask padded tokens out of a scan,
so a recurrent model's chunk must be fully valid (the serving engine sends
exact dyadic chunks); :func:`decode_step` on a cache carrying ``"active"``,
a ``(B,)`` bool mask, leaves the state of inactive rows as it was.

Attention without a cache (:func:`forward`) and the one-shot
:func:`prefill` attend over the fresh K/V with ``cfg.attn_impl``
(``"flash"``: the ``flash_attention`` kernel, sliding windows included;
otherwise the plain banded loop for a window); :func:`prefill` also writes
all B rows into the cache at position 0 (a ring keeps the last ``s_c``).
Chunked prefill and decode read the paged pools through the paged
kernels, or the dense slab through the plain attention
(``repro/models/transformer.py:302-375``, which the JAX package also
computes outside any Pallas kernel): a ring chunk attends over ``[old ring
∥ fresh chunk]`` with the keys' absolute positions, then scatters its valid
rows into the ring.

Every entry point is a sequence of device operations that a CUDA graph can
capture: positions, lengths and the per-step index vectors of the paged
write and read are made on the device (no host-to-device copy, no host
read), once a step, before the first layer.

Sharded (a cell under a mesh, ``launch/cells.py``): a model whose tensors
are shards (``distributed.sharding.is_sharded``) gathers its embedding,
final norm and LM head whole for an entry point (:func:`_top`) and each
block's shards for the extent of that block (:func:`_run_blocks`), except
the expert stacks, which ``models/moe.py`` uses as shards, and the
column-parallel weights of the projections that run on a kernel, which
``distributed.tp.column_parallel`` computes column by column on the
rank's shard (:func:`_local_shards`, ``KERNEL_COLUMNS``).  A dense cache
sharded on heads is read and written on the rank's heads
(``sharding.head_local``), one sharded on sequence (Granite-34B's and
RecurrentGemma-2B's one KV head; a ring keeps its ring rows) is gathered
whole for the layer and its rows written back
(``sharding.whole_sequence``).  A recurrent layer's state is held as the
cell shards it: RWKV6's ``S`` on its heads, which the recurrence runs on
(``models/rwkv6.py``), every other state on its batch rows only.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import SparsityPolicy
from repro_torch.distributed import sharding, tp
from repro_torch.layers.linear import QuantLinear, dense_linear, init_linear, sparse_linear
from repro_torch.models import common
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import attention, paged_attention, paged_kv_update
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.rglru import RGLRUBlock, init_rglru_state, rglru_block
from repro_torch.models.rwkv6 import RWKV6Block, init_rwkv6_state, rwkv6_block

__all__ = ["Transformer", "AttnBlock", "RWKVLayer", "RGLRULayer", "check_supported",
           "check_trainable",
           "layer_kinds", "init_params", "init_cache", "paged_kv_spec", "pools_anything",
           "forward", "prefill", "prefill_chunk", "decode_step"]


def check_supported(cfg: ModelConfig) -> None:
    """The port's decoder-only LM covers the dense, MoE and VLM families with
    full, sliding-window or local attention (the JAX package treats the
    last two alike), with RMSNorm or LayerNorm and the default, the 2-D
    (ChatGLM) or the M-RoPE (Qwen2-VL, whose ``vision_stub`` patch
    embeddings replace a prompt's first ``n_patches`` token rows), and the
    recurrent families: RWKV6 (``("rwkv6",)``, no RoPE) and the
    RecurrentGemma hybrid (``("rglru", "rglru", "attn")``) with windowed
    attention.  A recurrent model with full-attention layers (a paged
    hybrid) is not ported; an encoder-decoder is ``models/encdec.py``'s."""
    supported = {
        "family": (cfg.family, ("dense", "moe", "ssm", "hybrid", "vlm")),
        "attn_type": (cfg.attn_type, ("full", "swa", "local")),
        "rope_variant": (cfg.rope_variant, ("default", "2d", "mrope", "none")),
        "norm": (cfg.norm, ("rmsnorm", "layernorm")),
        "attn_impl": (cfg.attn_impl, ("chunked", "flash")),
        "block_pattern": (cfg.block_pattern,
                          (("attn",), ("rwkv6",), ("rglru", "rglru", "attn"))),
    }
    for field, (have, want) in supported.items():
        if have not in want:
            raise NotImplementedError(
                f"{cfg.name}: {field}={have!r} is not ported yet (only {want!r})")
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: an encoder-decoder is models/encdec.py's, "
                                  "not the decoder-only transformer's")
    kinds = set(layer_kinds(cfg))
    if kinds != {"attn"} and "attn" in kinds and _window(cfg) is None:
        raise NotImplementedError(f"{cfg.name}: a recurrent model with full-attention "
                                  "layers (a paged hybrid) is not ported yet")


def layer_kinds(cfg: ModelConfig):
    """Each layer's block kind: ``cfg.block_pattern`` tiled over the layers."""
    return [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]


def _n_periods(cfg: ModelConfig) -> Tuple[int, int]:
    """(whole periods of the pattern, layers of the tail)."""
    p = len(cfg.block_pattern)
    return cfg.n_layers // p, cfg.n_layers % p


def _apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """RoPE of ``x (B, T, H, hd)`` at ``positions``: ``(B, T)``, or under
    M-RoPE the ``(3, B, T)`` position streams (:func:`_rope_positions`)."""
    if cfg.rope_variant == "none":
        return x
    if cfg.rope_variant == "default":
        return common.apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope_variant == "2d":
        return common.apply_rope_2d(x, positions, cfg.rope_theta)
    if cfg.rope_variant == "mrope":
        return common.apply_mrope(x, positions, cfg.rope_theta)
    raise NotImplementedError(f"{cfg.name}: rope_variant={cfg.rope_variant!r} is not "
                              "ported yet")


class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        d = cfg.d_model
        self.ln1 = common.init_norm(d, cfg.norm, dtype=dtype, device=device)
        self.q_proj = init_linear(d, cfg.q_dim, bias=cfg.qkv_bias, **kw)
        self.k_proj = init_linear(d, cfg.kv_dim, bias=cfg.qkv_bias, **kw)
        self.v_proj = init_linear(d, cfg.kv_dim, bias=cfg.qkv_bias, **kw)
        self.o_proj = init_linear(cfg.q_dim, d, **kw)
        self.ln2 = common.init_norm(d, cfg.norm, dtype=dtype, device=device)
        if cfg.n_experts:
            self.moe = moe_lib.init_moe(d, cfg.moe_d_ff, cfg.n_experts,
                                        cfg.shared_expert, **kw)
        else:
            self.mlp = init_mlp(d, cfg.d_ff, **kw)


class RWKVLayer(nn.Module):
    """An ``rwkv6`` layer: the JAX package's ``{"rwkv": ...}``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator):
        super().__init__()
        self.rwkv = RWKV6Block(cfg.d_model, cfg.d_ff, cfg.n_heads, dtype=dtype, device=device,
                               generator=generator)


class RGLRULayer(nn.Module):
    """An ``rglru`` layer: ``ln1``, ``rglru``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        d = cfg.d_model
        self.ln1 = common.init_norm(d, cfg.norm, dtype=dtype, device=device)
        self.rglru = RGLRUBlock(d, cfg.rnn_width or d, cfg.conv_width, **kw)
        self.ln2 = common.init_norm(d, cfg.norm, dtype=dtype, device=device)
        self.mlp = init_mlp(d, cfg.d_ff, **kw)


_BLOCKS = {"attn": AttnBlock, "rwkv6": RWKVLayer, "rglru": RGLRULayer}


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        check_supported(cfg)
        dtype = common.dtype_of(cfg)
        self.cfg = cfg
        self.embed = common.init_embedding(cfg.vocab_size, cfg.d_model, dtype=dtype,
                                           device=device, generator=generator)
        self.blocks = nn.ModuleList(
            _BLOCKS[kind](cfg, dtype=dtype, device=device, generator=generator)
            for kind in layer_kinds(cfg))
        self.final_norm = common.init_norm(cfg.d_model, cfg.norm, dtype=dtype,
                                           device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        init_linear(cfg.d_model, cfg.vocab_size, dtype=dtype,
                                    device=device, generator=generator))


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """Random weights made on ``device`` (default: the GPU, raising if there
    is none) from a seeded ``torch.Generator``."""
    device = common.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return Transformer(cfg, device=device, generator=gen)


# ------------------------------------------------------------------- caches

def _window(cfg: ModelConfig) -> Optional[int]:
    return cfg.window if cfg.attn_type in ("swa", "local") else None


def _attn_cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Rows of a layer's dense cache: a sliding-window ring holds
    ``min(window, max_seq)``."""
    return max_seq if _window(cfg) is None else min(cfg.window, max_seq)


def _layer_leaves(kind: str) -> Tuple[str, ...]:
    return {"attn": ("k", "v"), "rwkv6": ("tm_shift", "cm_shift", "S"),
            "rglru": ("h", "conv")}[kind]


def paged_kv_spec(cfg: ModelConfig) -> Dict:
    """Which cache leaves live in the block pool: the K/V leaves of
    full-attention layers.  Sliding-window rings are already bounded by the
    window and their wraparound does not compose with block tables, and a
    recurrent layer's state is per slot and position-independent, so they
    stay out, and a model whose spec pools nothing is served on the dense
    slab."""
    check_supported(cfg)
    paged = _window(cfg) is None
    return {"layers": [{leaf: kind == "attn" and paged for leaf in _layer_leaves(kind)}
                       for kind in layer_kinds(cfg)]}


def pools_anything(cfg: ModelConfig) -> bool:
    return any(leaf for layer in paged_kv_spec(cfg)["layers"] for leaf in layer.values())


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype,
                      device) -> Dict:
    if kind == "rwkv6":
        return init_rwkv6_state(batch, cfg.d_model, cfg.n_heads, dtype, device)
    if kind == "rglru":
        return init_rglru_state(batch, cfg.rnn_width or cfg.d_model, cfg.conv_width, dtype,
                                device)
    shape = (batch, _attn_cache_len(cfg, max_seq), cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _init_dense_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                     device=None) -> Dict:
    """The dense layout: per attention layer ``(batch, s_c, Hkv, hd)`` zeros
    (:func:`_attn_cache_len`), per recurrent layer its zero state, on
    ``device`` (default: the GPU, raising if there is none), and a 0-d
    ``pos``."""
    device = common.resolve_device(device)
    dtype = dtype or common.dtype_of(cfg)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": [_init_layer_cache(cfg, kind, batch, max_seq, dtype, device)
                       for kind in layer_kinds(cfg)]}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None, block_size: int = 16, paged: Optional[bool] = None) -> Dict:
    """Per-row cache of ``max_seq`` positions on ``device`` (default: the
    GPU, raising if there is none).  Paged (the default where
    :func:`paged_kv_spec` pools something): row ``b`` owns blocks ``b*mb ..
    b*mb + mb - 1`` (plus the pool's trailing sentinel row, as
    ``serve.paged.device_pool_rows`` sizes it).  ``paged=False``, or a
    model whose spec pools nothing (sliding windows, recurrent layers): the
    dense layout of :func:`_init_dense_cache`."""
    from repro_torch.serve.paged import init_paged_cache, max_blocks_per_slot

    if paged is None:
        paged = pools_anything(cfg)
    if not paged:
        return _init_dense_cache(cfg, batch, max_seq, dtype, device)
    if not pools_anything(cfg):
        raise ValueError(f"{cfg.name}: sliding-window rings and recurrent state are "
                         "never paged")
    device = common.resolve_device(device)
    mb = max_blocks_per_slot(max_seq, block_size)
    cache = init_paged_cache(cfg, batch, max_seq, block_size, batch * mb,
                             dtype=dtype, device=device)
    cache["block_table"] = torch.arange(batch * mb, dtype=torch.int32,
                                        device=device).reshape(batch, mb)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


# -------------------------------------------------------------- block apply

def _paged_index(cache: Dict, b: int, pos: torch.Tensor, chunk_len: torch.Tensor,
                 kv_len: Optional[torch.Tensor], causal: bool) -> Dict:
    """The int32 ``(B,)`` vectors every layer's paged KV write and read
    take, built once a step, before the first layer: a layer then launches
    nothing to make them, and the ``paged_kv_scatter`` kernel may read them
    before it waits for the kernel that produced its K/V rows.  ``kv_len``
    None: the one-shot prefill, which attends over the fresh K/V."""
    def vec(v):
        return v.to(torch.int32).reshape(-1).expand(b).contiguous()

    return {"dense": False, "table": cache["block_table"], "pos": vec(pos),
            "chunk_len": vec(chunk_len), "kv_len": None if kv_len is None else vec(kv_len),
            "causal": causal}


def _dense_index(cfg: ModelConfig, cache: Dict, b: int, t: int, pos: torch.Tensor,
                 chunk_len: Optional[torch.Tensor], mode: str) -> Dict:
    """The dense layout's counterpart of :func:`_paged_index`, built once a
    step: ``mode`` "prefill" (one-shot, position 0), "chunk" (at the 0-d
    ``pos``, ``chunk_len`` valid rows) or "decode" (``pos`` 0-d or
    ``(B,)``).  ``w_rows``/``w_valid`` say which slab row each new K/V row
    goes to and whether it is written at all (pad rows and rows past a full
    cache are dropped); a ring chunk gets every key's absolute position
    (``kv_pos``: the old ring, then the chunk, -1 where never written) and a
    full cache ``kv_len``.  ``rows`` (the slot) and ``active`` (decode's
    mask of the rows whose recurrent state moves) are the recurrent
    layers'; a model with no attention layer needs nothing more."""
    s_c = _attn_rows(cache)
    dev = pos.device
    rows = cache.get("slot")
    idx = {"dense": True, "mode": mode, "pos": pos,
           "rows": None if rows is None else rows.long(), "active": cache.get("active")}
    if s_c is None:
        return idx
    window = _window(cfg)
    if mode == "prefill":
        if t > s_c:     # a ring shorter than the prompt keeps its last s_c rows
            idx["ring"] = torch.arange(t - s_c, t, device=dev) % s_c
        return idx
    p = pos.long()
    if mode == "decode":
        posv = p.reshape(-1).expand(b)
        slot = posv % s_c if window is not None else posv
        idx["w_rows"] = slot.clamp(max=s_c - 1)[:, None]
        idx["w_valid"] = (slot < s_c)[:, None]
        idx["kv_len"] = torch.clamp(pos + 1, max=s_c)
        return idx
    i = torch.arange(t, device=dev)
    valid = i < chunk_len
    wpos = p + i
    # t <= s_c: the chunk's rows land on distinct slab rows, pad rows too;
    # a full cache drops the rows past its end, a ring wraps them
    idx["w_rows"] = (wpos % s_c)[None, :].expand(b, t)
    idx["w_valid"] = (valid if window is not None else valid & (wpos < s_c))[None, :]
    if window is not None:
        # row r of the old ring holds the latest position <= pos - 1 that is
        # r mod s_c (-1: never written)
        p_old = p - 1 - torch.remainder(p - 1 - torch.arange(s_c, device=dev), s_c)
        idx["kv_pos"] = torch.cat([torch.where(p_old >= 0, p_old, -1),
                                   torch.where(valid, wpos, -1)])
    else:
        idx["kv_len"] = pos + chunk_len
    return idx


def _attn_rows(cache: Dict) -> Optional[int]:
    """Rows of the first attention layer's dense cache (None: no attention
    layer)."""
    return next((sharding.full_shape(layer["k"])[1] for layer in cache["layers"]
                 if "k" in layer), None)


def _slab_rows(buf: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    return buf if rows is None else buf.index_select(0, rows)


def _write_rows(buf: torch.Tensor, rows: Optional[torch.Tensor], r: torch.Tensor,
                new: torch.Tensor, valid: torch.Tensor) -> None:
    """``buf[rows[b], r[b, t]] = new[b, t]`` where ``valid``, in place; rows
    not valid keep what they hold (the JAX package's dropped scatter)."""
    bi = (torch.arange(new.shape[0], device=new.device) if rows is None else rows)
    bi = bi[:, None].expand_as(r)
    buf[bi, r] = torch.where(valid[..., None, None], new, buf[bi, r])


def _dense_attention(cfg: ModelConfig, q, k, v, cache: Dict, index: Dict):
    """Write the step's K/V into the dense slab and attend (plain torch, as
    the JAX package computes it outside any Pallas kernel).  A cell's
    cache sharded over ``model`` is attended on this rank's heads, or
    gathered whole along the sequence for the layer (module docstring)."""
    split = sharding.model_dim(cache["k"])
    if split == 2:
        # views of the cache's shards: the same memory, no longer tagged
        mine = dict(cache, k=cache["k"][:], v=cache["v"][:])
        return sharding.head_local(
            lambda q_, k_, v_: _dense_attention(cfg, q_, k_, v_, mine, index), q, k, v,
            cache["k"])
    if split == 1:
        with sharding.whole_sequence(cache) as whole:
            return _dense_attention(cfg, q, k, v, whole, index)
    ck, cv, rows, mode = cache["k"], cache["v"], index["rows"], index["mode"]
    window = _window(cfg)
    if mode == "prefill":
        o = attention(q, k, v, causal=True, window=window, q_offset=0,
                      chunk=cfg.attn_chunk, impl=cfg.attn_impl)
        t = k.shape[1]
        for buf, new in ((ck, k), (cv, v)):
            if "ring" in index:
                buf.index_copy_(1, index["ring"], new[:, t - buf.shape[1]:])
            else:
                buf[:, :t] = new
        return o
    if mode == "chunk" and window is not None:
        # the chunk's early queries still see ring rows the chunk would
        # overwrite: attend over [old ring ∥ fresh chunk] first, then write
        o = attention(q, torch.cat([_slab_rows(ck, rows), k], dim=1),
                      torch.cat([_slab_rows(cv, rows), v], dim=1), causal=True,
                      window=window, q_offset=index["pos"], kv_positions=index["kv_pos"],
                      chunk=cfg.attn_chunk)
        _write_rows(ck, rows, index["w_rows"], k, index["w_valid"])
        _write_rows(cv, rows, index["w_rows"], v, index["w_valid"])
        return o
    _write_rows(ck, rows, index["w_rows"], k, index["w_valid"])
    _write_rows(cv, rows, index["w_rows"], v, index["w_valid"])
    return attention(q, _slab_rows(ck, rows), _slab_rows(cv, rows),
                     causal=mode == "chunk", q_offset=index["pos"],
                     kv_len=index["kv_len"], chunk=cfg.attn_chunk)


def _attn_block_apply(cfg: ModelConfig, h: torch.Tensor, p: AttnBlock,
                      policy: SparsityPolicy, phase: str, layer_idx: int,
                      cache: Optional[Dict], positions: torch.Tensor,
                      index: Optional[Dict] = None) -> torch.Tensor:
    b, t, _ = h.shape
    x = common.norm_apply(h, p.ln1, cfg.norm)
    q = sparse_linear(x, p.q_proj, "q_proj", policy, phase, layer_idx)
    k = sparse_linear(x, p.k_proj, "k_proj", policy, phase, layer_idx)
    v = sparse_linear(x, p.v_proj, "v_proj", policy, phase, layer_idx)
    q = _apply_rope(cfg, q.reshape(b, t, cfg.n_heads, cfg.head_dim), positions)
    k = _apply_rope(cfg, k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim), positions)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)

    use_kernel = policy.use_kernels
    if index is not None and index["dense"]:
        o = _dense_attention(cfg, q, k, v, cache, index)
    elif index is None or index["kv_len"] is None:
        if cache is not None:
            # the one-shot prefill into the paged layout: every row written
            # at position 0 (with use_kernels a paged_kv_scatter launch)
            paged_kv_update(cache["k"], cache["v"], k, v, index["table"], index["pos"],
                            index["chunk_len"], use_kernel=use_kernel)
        # no cache, or the one-shot prefill: attend over the fresh K/V
        o = attention(q, k, v, causal=True, window=_window(cfg), q_offset=0,
                      chunk=cfg.attn_chunk, impl=cfg.attn_impl)
    else:
        # paged cache: logical row p of a batch row lives at physical row
        # (table[p // bs], p % bs).  The write goes first (in place); with
        # use_kernels it is a paged_kv_scatter launch
        paged_kv_update(cache["k"], cache["v"], k, v, index["table"], index["pos"],
                        index["chunk_len"], use_kernel=use_kernel)
        # chunked prefill (causal, batch 1) or decode (each row at its own
        # depth): the read of the pools, a paged_attention launch with
        # use_kernels
        o = paged_attention(q, cache["k"], cache["v"], index["table"],
                            causal=index["causal"], q_offset=index["pos"],
                            kv_len=index["kv_len"], chunk=cfg.attn_chunk,
                            use_kernel=use_kernel, kv_heads=cfg.n_kv_heads)
    o = sparse_linear(o.reshape(b, t, cfg.q_dim), p.o_proj, "o_proj", policy,
                      phase, layer_idx)
    h = h + o
    x2 = common.norm_apply(h, p.ln2, cfg.norm)
    if cfg.n_experts:
        ff = moe_lib.moe(x2, p.moe, policy, phase, cfg.top_k, cfg.act_fn,
                         cfg.moe_impl, layer_idx)
    else:
        ff = mlp(x2, p.mlp, policy, phase, cfg.act_fn, layer_idx)
    return h + ff


def _read_state(cache: Optional[Dict], index: Optional[Dict]) -> Optional[Dict]:
    """A recurrent layer's state for this step: None (zeros) without a cache
    and in the one-shot prefill; else the batch's rows of the cache.  A
    cell's state held on its heads (RWKV6's ``S`` over ``model``) starts
    the prefill from zeros of its shard's shape, and what is read of it
    keeps the shard's tag (``sharding.head_state_local`` reads it)."""
    if cache is None or index is None:
        return None
    held = {k: buf for k, buf in cache.items() if sharding.model_dim(buf) is not None}
    if index["mode"] == "prefill":
        if not held:
            return None
        state = {k: torch.zeros_like(buf) for k, buf in cache.items()}
    else:
        state = {k: _slab_rows(buf, index["rows"]) for k, buf in cache.items()}
    for k, buf in held.items():
        sharding.tag(state[k], *buf._shard)
    return state


def _write_state(cache: Optional[Dict], index: Optional[Dict], new: Dict) -> None:
    """Write a recurrent layer's new state into its cache in place: at the
    slot's rows, or every row (decode: only where ``active``)."""
    if cache is None:
        return
    rows, active = index["rows"], index["active"]
    for k, buf in cache.items():
        val = new[k].to(buf.dtype)
        if rows is not None:
            buf.index_copy_(0, rows, val)
            continue
        if active is not None:
            val = torch.where(active.reshape(-1, *[1] * (val.ndim - 1)), val, buf)
        buf.copy_(val)


def _recurrent_apply(cfg: ModelConfig, kind: str, h: torch.Tensor, p, policy: SparsityPolicy,
                     phase: str, layer_idx: int, cache: Optional[Dict],
                     index: Optional[Dict], state: Optional[Dict] = None) -> torch.Tensor:
    """An ``rwkv6`` or ``rglru`` layer (``repro/models/transformer.py:390-405``);
    ``state``: the state to start from where there is no cache (default
    zeros)."""
    if cache is not None:
        state = _read_state(cache, index)
    if kind == "rwkv6":
        h, new = rwkv6_block(h, p.rwkv, policy, phase, cfg.n_heads, state, layer_idx)
    else:
        x = common.norm_apply(h, p.ln1, cfg.norm)
        y, new = rglru_block(x, p.rglru, policy, phase, state, layer_idx)
        h = h + y
        x2 = common.norm_apply(h, p.ln2, cfg.norm)
        h = h + mlp(x2, p.mlp, policy, phase, cfg.act_fn, layer_idx)
    _write_state(cache, index, new)
    return h


def _rope_positions(cfg: ModelConfig, positions: torch.Tensor,
                    positions_3d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What the attention blocks rotate by: ``positions (B, T)``, or under
    M-RoPE the ``(3, B, T)`` streams, by default the positions broadcast to
    all three, as the reference builds them
    (``repro/models/transformer.py:619, 642, 688, 723-728``)."""
    if cfg.rope_variant != "mrope":
        return positions
    return positions[None].expand(3, *positions.shape) if positions_3d is None else positions_3d


def _embed_inputs(cfg: ModelConfig, params: Transformer, batch: Dict) -> torch.Tensor:
    """The token embeddings; a VLM's ``batch["pixel_embeds"] (B, P, d)``,
    cast to the model dtype, replaces the first ``P`` rows
    (``repro/models/transformer.py:451-462``)."""
    h = common.embed(batch["tokens"], params.embed)
    pe = batch.get("pixel_embeds") if cfg.vision_stub else None
    if pe is not None:
        if pe.shape[1] > h.shape[1]:
            raise ValueError(f"{cfg.name}: {pe.shape[1]} patch embeddings do not fit "
                             f"{h.shape[1]} token rows")
        h[:, :pe.shape[1]] = pe.to(h.dtype)
    return h


# per block kind: (path in the block, the policy name it prunes under) of
# each column-parallel projection that a kernel may compute on the rank's
# column shard
KERNEL_COLUMNS = {
    "attn": (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
             ("mlp.gate_proj", "gate_proj"), ("mlp.up_proj", "up_proj"),
             ("moe.shared.gate_proj", "gate_proj"), ("moe.shared.up_proj", "up_proj")),
    "rwkv6": tuple((f"rwkv.tm.{n}", "q_proj") for n in ("r_proj", "k_proj_tm", "v_proj_tm",
                                                        "g_proj"))
    + (("rwkv.cm.gate_proj", "gate_proj"), ("rwkv.cm.up_proj", "up_proj")),
    "rglru": (("rglru.q_proj", "q_proj"), ("rglru.gate_proj", "gate_proj"),
              ("mlp.gate_proj", "gate_proj"), ("mlp.up_proj", "up_proj")),
}


def _local_shards(blk: nn.Module, policy: SparsityPolicy, phase: str, i: Optional[int],
                  columns) -> Tuple[str, ...]:
    """The names in a sharded block that stay shards for layer ``i``: the
    expert stacks, and the projections of ``columns`` (``KERNEL_COLUMNS``)
    that run column-parallel on a kernel where the rank holds a column
    shard of them (what each rank computes with).  Row-parallel
    projections (``o_proj``, ``down_proj``) are gathered whole."""
    keep = ["moe.experts"]
    if policy.use_kernels and policy.active(phase):
        for name, as_ in columns:
            if not policy.should_prune(as_, i):
                continue
            try:
                w = blk.get_submodule(name).w
            except AttributeError:                  # no shared expert, no MLP
                continue
            if getattr(w, "held_cols", None):
                # nm_spmm takes no bias: a biased projection adds its bias
                # after the gather of the output's columns, so it is whole
                keep.append(f"{name}.w" if policy.tile_consensus else name)
    return tuple(keep)


def _top(params: nn.Module, blocks: Tuple[str, ...] = ("blocks",)):
    """A sharded model's embedding, norms and LM head gathered whole for
    the extent of an entry point (its ``blocks`` gather their own)."""
    if not sharding.is_sharded(params):
        return contextlib.nullcontext()
    return sharding.gathered(params, blocks)


def _sharded_block(cfg, h, blk, policy, phase, i, layer, positions, index=None):
    """A block of a sharded model, its shards gathered for the block alone."""
    with sharding.gathered(blk, _local_shards(blk, policy, phase, i, KERNEL_COLUMNS["attn"])):
        return _attn_block_apply(cfg, h, blk, policy, phase, i, layer, positions, index)


def _sharded_recurrent(cfg, kind, h, blk, policy, phase, i, layer, index):
    """A recurrent layer of a sharded model, its shards gathered for the
    layer alone; its state is read and written as the cell holds it
    (RWKV6's ``S`` on the rank's heads, the rest on its batch rows).
    Without a cache (a train cell) RWKV6 starts from zeros held on the
    rank's heads (``sharding.fresh_head_state``), as the reference's pjit
    shards the scan's carry."""
    state = None
    if layer is None and kind == "rwkv6":
        s = sharding.fresh_head_state(h.shape[0], cfg.n_heads, cfg.d_model // cfg.n_heads,
                                      h.device)
        if s is not None:
            state = {"tm_shift": h.new_zeros(h.shape[0], cfg.d_model),
                     "cm_shift": h.new_zeros(h.shape[0], cfg.d_model), "S": s}
    with sharding.gathered(blk, _local_shards(blk, policy, phase, i, KERNEL_COLUMNS[kind])):
        return _recurrent_apply(cfg, kind, h, blk, policy, phase, i, layer, index, state)


def _remat_context():
    """``checkpoint``'s ``context_fn``: the block runs as it is; remat's
    recompute, which autograd runs in a thread of its own on the card,
    re-enters the forward's mesh and TP scopes (thread-locals), so that it
    takes the forward's paths (``models/moe.moe`` reads the mesh and the
    batch's DP shards to choose ``_moe_shard_map``)."""
    mesh, shards = sharding._context_mesh(), sharding._batch_shards()
    group = getattr(tp.current(), "group", None)

    @contextlib.contextmanager
    def again():
        with (sharding.mesh_scope(mesh, shards) if mesh is not None
              else contextlib.nullcontext()), tp.scope(group):
            yield

    return contextlib.nullcontext(), again()


def _run_blocks(cfg, params: Transformer, h, policy, phase, cache, positions,
                index=None):
    # the reference's jax.checkpoint around the layer body
    # (repro/models/transformer.py:497-530): under "train" with cfg.remat and
    # autograd recording, each block keeps only its input and is run again
    # in the backward
    # (a recurrent layer's new state is dropped there: no cache takes it)
    remat = cfg.remat and phase == "train" and cache is None and torch.is_grad_enabled()
    sharded = sharding.is_sharded(params)
    apply = _sharded_block if sharded else _attn_block_apply
    recurrent = _sharded_recurrent if sharded else _recurrent_apply
    for i, (kind, blk) in enumerate(zip(layer_kinds(cfg), params.blocks)):
        layer = None if cache is None else cache["layers"][i]
        if kind != "attn" and remat:
            h = checkpoint(recurrent, cfg, kind, h, blk, policy, phase, i, None, None,
                           use_reentrant=False, context_fn=_remat_context)
        elif kind != "attn":
            h = recurrent(cfg, kind, h, blk, policy, phase, i, layer, index)
        elif remat:
            h = checkpoint(apply, cfg, h, blk, policy, phase, i, None, positions,
                           use_reentrant=False, context_fn=_remat_context)
        else:
            h = apply(cfg, h, blk, policy, phase, i, layer, positions, index)
    return h


def _lm_logits(cfg: ModelConfig, params: Transformer, h: torch.Tensor) -> torch.Tensor:
    h = common.norm_apply(h, params.final_norm, cfg.norm)
    if cfg.tie_embeddings:
        return h @ params.embed.w.T
    return dense_linear(h, params.lm_head)


# ------------------------------------------------------------------ entries

def check_trainable(cfg: ModelConfig, params: nn.Module) -> None:
    """Raise ``NotImplementedError`` where autograd would record a forward
    through a W8A8 (``QuantLinear``) projection, an MoE's or an
    encoder-decoder's included, with parameters that require grad, under
    grad mode: its int8 weights have no float counterpart to train, and the
    reference trains none either (its trainer never quantizes, and
    ``jax.grad`` over the int8 ``wq`` leaves fails).  Every family trains in
    the model dtype; without grad a W8A8 model runs as it serves."""
    if not torch.is_grad_enabled() or not any(p.requires_grad for p in params.parameters()):
        return
    if any(isinstance(m, QuantLinear) for m in params.modules()):
        raise NotImplementedError(
            f"{cfg.name}: a W8A8 projection does not train: its int8 weights have no "
            "gradient, and the reference trains no quantized model either")


def forward(cfg: ModelConfig, params: Transformer, batch: Dict, *,
            policy: SparsityPolicy, phase: str = "train") -> torch.Tensor:
    """Full-sequence causal pass without a cache → (B, T, V) logits.  The
    phase defaults to ``"train"``, as the reference's does, so a policy
    whose phases omit it leaves the pass dense.  Autograd records the pass
    when grad is enabled and the parameters require it (every family;
    :func:`check_trainable` says what raises)."""
    check_trainable(cfg, params)
    tokens = batch["tokens"]
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    with _top(params):
        h = _embed_inputs(cfg, params, batch)
        h = _run_blocks(cfg, params, h, policy, phase, None,
                        _rope_positions(cfg, positions, batch.get("positions_3d")))
        return _lm_logits(cfg, params, h)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Transformer, batch: Dict, cache: Dict, *,
            policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One-shot prompt ingestion of ``batch["tokens"] (B, T)`` into a cache
    from :func:`init_cache`: attention over the fresh K/V with
    ``cfg.attn_impl``, and every row's K/V written at position 0 (through
    ``paged_kv_scatter`` under ``policy.use_kernels``; a dense ring shorter
    than the prompt keeps its last rows).  Returns (last-token logits (B,
    V), cache with ``pos + T``); the cache is updated in place."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = tokens.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if "block_table" in cache:
        bs, mb = cache["layers"][0]["k"].shape[1], cache["block_table"].shape[1]
        if t > mb * bs:
            raise ValueError(f"prefill: {t} tokens do not fit a cache of {mb * bs} positions")
        index = _paged_index(cache, b, zero, torch.full((), t, dtype=torch.int32, device=dev),
                             None, True)
    else:
        s_c = _attn_rows(cache)
        if s_c is not None and t > s_c and _window(cfg) is None:
            raise ValueError(f"prefill: {t} tokens do not fit a cache of {s_c} positions")
        index = _dense_index(cfg, cache, b, t, zero, None, "prefill")
    positions = torch.arange(t, device=dev).expand(b, t)
    with _top(params):
        h = _embed_inputs(cfg, params, batch)
        h = _run_blocks(cfg, params, h, policy, "prefill", cache,
                        _rope_positions(cfg, positions, batch.get("positions_3d")), index)
        logits = _lm_logits(cfg, params, h[:, -1:])[:, 0]
    return logits, {**cache, "pos": cache["pos"] + t}


@torch.no_grad()
def prefill_chunk(cfg: ModelConfig, params: Transformer, batch: Dict, cache: Dict,
                  *, policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One prefill chunk written at the cache offset ``cache["pos"]`` (a 0-d
    int32 tensor).  ``batch["tokens"]`` is ``(1, C)`` (a dense cache takes
    ``(B, C)`` rows at one offset); ``batch["chunk_len"]`` (default C) marks
    how many leading tokens are valid — the padded tail is masked out of
    the KV write and the attention.  A dense cache takes chunks of at most
    its row count (a ring's ``min(window, max_seq)``).  Returns (logits of
    the last valid token (B, V), cache with ``pos += chunk_len``); the cache
    is updated in place."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = tokens.device
    pos = cache["pos"]
    chunk_len = batch.get("chunk_len")
    if chunk_len is None:
        chunk_len = torch.full((), t, dtype=torch.int32, device=dev)
    if "block_table" in cache:
        if b != 1:
            raise ValueError("paged chunked prefill is per-slot (batch 1)")
        index = _paged_index(cache, b, pos, chunk_len, pos + chunk_len, True)
    else:
        s_c = _attn_rows(cache)
        if s_c is not None and t > s_c:
            raise ValueError(f"prefill_chunk: a {t}-token chunk exceeds the cache's "
                             f"{s_c} rows")
        index = _dense_index(cfg, cache, b, t, pos, chunk_len, "chunk")
    positions = pos + torch.arange(t, device=dev).expand(b, t)
    with _top(params):
        h = _embed_inputs(cfg, params, batch)
        h = _run_blocks(cfg, params, h, policy, "prefill", cache,
                        _rope_positions(cfg, positions), index)
        h_last = h.index_select(1, (chunk_len.long() - 1).reshape(1))
        logits = _lm_logits(cfg, params, h_last)[:, 0]
    return logits, {**cache, "pos": pos + chunk_len}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                cache: Dict, *, policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One decode step for ``tokens (B, 1)``; ``cache["pos"]`` is a (B,)
    int32 vector of per-row positions (or a scalar shared by every row).
    A dense cache may carry ``"active"``, a ``(B,)`` bool mask: the
    recurrent state of the other rows is left as it was.  → ((B, V) logits,
    cache with ``pos + 1``); the cache is updated in place."""
    b, t = tokens.shape
    pos = cache["pos"]
    # a scalar pos moves every row in lockstep (the one-shot cache)
    if "block_table" in cache:
        mb, bs = cache["block_table"].shape[1], cache["layers"][0]["k"].shape[1]
        index = _paged_index(cache, b, pos,
                             torch.ones((), dtype=torch.int32, device=pos.device),
                             torch.clamp(pos + 1, max=mb * bs), False)
    else:
        index = _dense_index(cfg, cache, b, t, pos, None, "decode")
    positions = pos.reshape(-1, 1).expand(b, t)
    with _top(params):
        h = common.embed(tokens, params.embed)
        h = _run_blocks(cfg, params, h, policy, "decode", cache,
                        _rope_positions(cfg, positions), index)
        logits = _lm_logits(cfg, params, h)[:, 0]
    return logits, {**cache, "pos": pos + 1}
