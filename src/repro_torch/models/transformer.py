"""Decoder-only LM, dense family (port of ``repro/models/transformer.py``).

A :class:`Transformer` holds the embedding, an ``nn.ModuleList`` of
attention blocks, the final norm and the LM head.  Layers run as a Python
loop with a static layer index, so each projection consults the policy's
skip list directly (the JAX package scans the stacked layers and passes a
traced per-layer flag instead).  Under ``paper_policy`` this routes q_proj
and gate_proj through the fused kernel in every layer the skip list does
not name, where the JAX scan takes its mask-select form: the same function,
with more of it on the kernel.

Caches are paged: ``{"pos", "block_table", "layers": [{"k", "v"}, ...]}``
with per-layer pools ``(rows, block_size, Hkv, hd)`` written in place.
:func:`init_cache` gives each batch row its own contiguous run of blocks
(a dense per-row slab expressed as a block table); serving builds a shared
pool with ``serve.paged.init_paged_cache``.

Attention without a cache (:func:`forward`) and the one-shot
:func:`prefill` attend over the fresh K/V with ``cfg.attn_impl``
(``"flash"``: the ``flash_attention`` kernel); :func:`prefill` also writes
all B rows into the cache at position 0.  Chunked prefill and decode read
the paged pools.

Every entry point is a sequence of device operations that a CUDA graph can
capture: positions, lengths and the per-step index vectors of the paged
write and read are made on the device (no host-to-device copy, no host
read), once a step, before the first layer.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import SparsityPolicy
from repro_torch.layers.linear import dense_linear, init_linear, sparse_linear
from repro_torch.models import common
from repro_torch.models.attention import attention, paged_attention, paged_kv_update
from repro_torch.models.mlp import init_mlp, mlp

__all__ = ["Transformer", "AttnBlock", "check_supported", "init_params",
           "init_cache", "paged_kv_spec", "forward", "prefill", "prefill_chunk",
           "decode_step"]


def check_supported(cfg: ModelConfig) -> None:
    """The port's slice covers the dense full-attention RMSNorm/RoPE family."""
    supported = {
        "family": (cfg.family, ("dense",)), "attn_type": (cfg.attn_type, ("full",)),
        "rope_variant": (cfg.rope_variant, ("default",)), "norm": (cfg.norm, ("rmsnorm",)),
        "attn_impl": (cfg.attn_impl, ("chunked", "flash")),
        "block_pattern": (cfg.block_pattern, (("attn",),)),
    }
    for field, (have, want) in supported.items():
        if have not in want:
            raise NotImplementedError(
                f"{cfg.name}: {field}={have!r} is not ported yet (only {want!r})")
    if cfg.n_experts or cfg.is_encdec or cfg.vision_stub:
        raise NotImplementedError(f"{cfg.name}: MoE/encdec/VLM are not ported yet")


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
        self.mlp = init_mlp(d, cfg.d_ff, **kw)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        check_supported(cfg)
        dtype = common.dtype_of(cfg)
        self.cfg = cfg
        self.embed = common.init_embedding(cfg.vocab_size, cfg.d_model, dtype=dtype,
                                           device=device, generator=generator)
        self.blocks = nn.ModuleList(
            AttnBlock(cfg, dtype=dtype, device=device, generator=generator)
            for _ in range(cfg.n_layers))
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

def paged_kv_spec(cfg: ModelConfig) -> Dict:
    """Which cache leaves live in the block pool: every attention K/V leaf
    of the dense full-attention family."""
    check_supported(cfg)
    return {"layers": [{"k": True, "v": True} for _ in range(cfg.n_layers)]}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None, block_size: int = 16) -> Dict:
    """Per-row cache of ``max_seq`` positions in the paged layout on
    ``device`` (default: the GPU, raising if there is none): row ``b`` owns
    blocks ``b*mb .. b*mb + mb - 1`` (plus the pool's trailing sentinel row,
    as ``serve.paged.device_pool_rows`` sizes it)."""
    from repro_torch.serve.paged import init_paged_cache, max_blocks_per_slot

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

    return {"table": cache["block_table"], "pos": vec(pos), "chunk_len": vec(chunk_len),
            "kv_len": None if kv_len is None else vec(kv_len), "causal": causal}


def _attn_block_apply(cfg: ModelConfig, h: torch.Tensor, p: AttnBlock,
                      policy: SparsityPolicy, phase: str, layer_idx: int,
                      cache: Optional[Dict], positions: torch.Tensor,
                      index: Optional[Dict] = None) -> torch.Tensor:
    b, t, _ = h.shape
    x = common.rms_norm(h, p.ln1)
    q = sparse_linear(x, p.q_proj, "q_proj", policy, phase, layer_idx)
    k = sparse_linear(x, p.k_proj, "k_proj", policy, phase, layer_idx)
    v = sparse_linear(x, p.v_proj, "v_proj", policy, phase, layer_idx)
    q = common.apply_rope(q.reshape(b, t, cfg.n_heads, cfg.head_dim), positions,
                          cfg.rope_theta)
    k = common.apply_rope(k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim), positions,
                          cfg.rope_theta)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)

    use_kernel = policy.use_kernels
    if cache is not None:
        # paged cache: logical row p of a batch row lives at physical row
        # (table[p // bs], p % bs).  The write goes first (in place); with
        # use_kernels it is a paged_kv_scatter launch
        paged_kv_update(cache["k"], cache["v"], k, v, index["table"], index["pos"],
                        index["chunk_len"], use_kernel=use_kernel)
    if index is None or index["kv_len"] is None:
        # no cache, or the one-shot prefill (written at position 0 above):
        # attend over the fresh K/V
        o = attention(q, k, v, causal=True, q_offset=0, chunk=cfg.attn_chunk,
                      impl=cfg.attn_impl)
    else:
        # chunked prefill (causal, batch 1) or decode (each row at its own
        # depth): the read of the pools, a paged_attention launch with
        # use_kernels
        o = paged_attention(q, cache["k"], cache["v"], index["table"],
                            causal=index["causal"], q_offset=index["pos"],
                            kv_len=index["kv_len"], chunk=cfg.attn_chunk,
                            use_kernel=use_kernel)
    o = sparse_linear(o.reshape(b, t, cfg.q_dim), p.o_proj, "o_proj", policy,
                      phase, layer_idx)
    h = h + o
    x2 = common.rms_norm(h, p.ln2)
    return h + mlp(x2, p.mlp, policy, phase, cfg.act_fn, layer_idx)


def _run_blocks(cfg, params: Transformer, h, policy, phase, cache, positions,
                index=None):
    for i, blk in enumerate(params.blocks):
        h = _attn_block_apply(cfg, h, blk, policy, phase, i,
                              None if cache is None else cache["layers"][i],
                              positions, index)
    return h


def _lm_logits(cfg: ModelConfig, params: Transformer, h: torch.Tensor) -> torch.Tensor:
    h = common.rms_norm(h, params.final_norm)
    if cfg.tie_embeddings:
        return h @ params.embed.w.T
    return dense_linear(h, params.lm_head)


# ------------------------------------------------------------------ entries

@torch.no_grad()
def forward(cfg: ModelConfig, params: Transformer, batch: Dict, *,
            policy: SparsityPolicy, phase: str = "prefill") -> torch.Tensor:
    """Full-sequence causal pass without a cache → (B, T, V) logits."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    h = common.embed(tokens, params.embed)
    h = _run_blocks(cfg, params, h, policy, phase, None, positions)
    return _lm_logits(cfg, params, h)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Transformer, batch: Dict, cache: Dict, *,
            policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One-shot prompt ingestion of ``batch["tokens"] (B, T)`` into a cache
    from :func:`init_cache`: attention over the fresh K/V with
    ``cfg.attn_impl``, and every row's K/V written at position 0 (through
    ``paged_kv_scatter`` under ``policy.use_kernels``).  Returns (last-token
    logits (B, V), cache with ``pos + T``); the pools are updated in
    place."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    bs, mb = cache["layers"][0]["k"].shape[1], cache["block_table"].shape[1]
    if t > mb * bs:
        raise ValueError(f"prefill: {t} tokens do not fit a cache of {mb * bs} positions")
    dev = tokens.device
    positions = torch.arange(t, device=dev).expand(b, t)
    index = _paged_index(cache, b, torch.zeros((), dtype=torch.int32, device=dev),
                         torch.full((), t, dtype=torch.int32, device=dev), None, True)
    h = common.embed(tokens, params.embed)
    h = _run_blocks(cfg, params, h, policy, "prefill", cache, positions, index)
    logits = _lm_logits(cfg, params, h[:, -1:])[:, 0]
    return logits, {**cache, "pos": cache["pos"] + t}


@torch.no_grad()
def prefill_chunk(cfg: ModelConfig, params: Transformer, batch: Dict, cache: Dict,
                  *, policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One prefill chunk written at the cache offset ``cache["pos"]`` (a 0-d
    int32 tensor).  ``batch["tokens"]`` is ``(1, C)``; ``batch["chunk_len"]``
    (default C) marks how many leading tokens are valid — the padded tail is
    masked out of the KV write and the attention.  Returns (logits of the
    last valid token (1, V), cache with ``pos += chunk_len``); the pools are
    updated in place."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = tokens.device
    pos = cache["pos"]
    chunk_len = batch.get("chunk_len")
    if chunk_len is None:
        chunk_len = torch.full((), t, dtype=torch.int32, device=dev)
    if b != 1:
        raise ValueError("paged chunked prefill is per-slot (batch 1)")
    positions = pos + torch.arange(t, device=dev).expand(b, t)
    index = _paged_index(cache, b, pos, chunk_len, pos + chunk_len, True)
    h = common.embed(tokens, params.embed)
    h = _run_blocks(cfg, params, h, policy, "prefill", cache, positions, index)
    h_last = h.index_select(1, (chunk_len.long() - 1).reshape(1))
    logits = _lm_logits(cfg, params, h_last)[:, 0]
    return logits, {**cache, "pos": pos + chunk_len}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                cache: Dict, *, policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One decode step for ``tokens (B, 1)``; ``cache["pos"]`` is a (B,)
    int32 vector of per-row positions (or a scalar shared by every row).
    → ((B, V) logits, cache with
    ``pos + 1``); the pools are updated in place."""
    b, t = tokens.shape
    pos = cache["pos"]
    mb, bs = cache["block_table"].shape[1], cache["layers"][0]["k"].shape[1]
    # a scalar pos moves every row in lockstep (the one-shot cache)
    index = _paged_index(cache, b, pos, torch.ones((), dtype=torch.int32, device=pos.device),
                         torch.clamp(pos + 1, max=mb * bs), False)
    positions = index["pos"][:, None].expand(b, t)
    h = common.embed(tokens, params.embed)
    h = _run_blocks(cfg, params, h, policy, "decode", cache, positions, index)
    logits = _lm_logits(cfg, params, h)[:, 0]
    return logits, {**cache, "pos": pos + 1}
