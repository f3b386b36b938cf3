"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``); the
audio frontend is a stub, as in the reference: ``batch["frame_embeds"]
(B, encoder_seq, d_model)`` carries what the two conv layers would make.

An :class:`EncDec` holds the embedding, the encoder blocks (``ln1``,
``attn``, ``ln2``, ``ff``) and ``enc_norm``, the decoder blocks (``ln1``,
``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``ff``) and ``dec_norm``,
and the LM head.  Attention projections: q/v/o with biases, k without.  The
feed-forward is Whisper's non-gated ``fc1 → gelu(tanh) → fc2``, named
``gate_proj``/``down_proj`` so that the Amber policy selects them as the
reference does.  Positions are sinusoidal, added to the frame and token
embeddings; attention is the plain online softmax of
``models/attention.py`` (the reference's default ``impl="chunked"``):
the encoder non-causal, the decoder's self-attention causal over its
cache and its cross-attention non-causal over the encoder's K/V.

Every projection calls ``sparse_linear`` with no layer index
(``repro/models/encdec.py:39-41, 96-98, 114, 177, 185, 196``), so the
policy's q/gate skip list never applies here: under ``paper_policy`` q
(encoder, decoder self and cross), fc1 and fc2 are pruned in every layer.

The cache is ``{"pos", "layers": [{"k", "v", "cross_k", "cross_v"},
...]}``, one entry per decoder layer: the self-attention's ``k``/``v``
``(B, max_seq, H, hd)`` (the reference's ``self_k``/``self_v``) and
``cross_*`` ``(B, encoder_seq, H, hd)``.  It is never
paged (:func:`paged_kv_spec` pools nothing): the serving engine keeps it on
the dense per-slot slab, where a slice carries ``"slot"`` and a step reads
and writes that slot's rows in place.  The decoder's four cache cases are
the reference's (``repro/models/encdec.py:146-176``): no cache (whole
sequence, causal), the one-shot prefill (written at 0), a chunk at the
offset ``pos`` (rows ``i >= chunk_len`` and rows past the cache dropped)
and a decode step (``pos`` a scalar or a ``(B,)`` vector; a write past the
cache dropped).  The encoder runs only where the batch carries
``frame_embeds`` (:func:`forward`, :func:`prefill`, and the first chunk of
a request in :func:`prefill_chunk`), which writes the cross K/V; later
chunks and decode steps reuse them.  The self-attention's slab writes and
reads are the decoder-only model's dense path
(``transformer._dense_index``/``_dense_attention``), its index built once
a step on the device, so a CUDA graph can capture every entry point.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import SparsityPolicy
from repro_torch.layers.linear import dense_linear, init_linear, sparse_linear
from repro_torch.models import common
from repro_torch.models.attention import attention
from repro_torch.models.transformer import _dense_attention, _dense_index, _slab_rows

__all__ = ["EncDec", "check_supported", "layer_kinds", "init_params", "init_cache",
           "paged_kv_spec", "pools_anything", "forward", "prefill", "prefill_chunk",
           "decode_step"]

_LEAVES = ("k", "v", "cross_k", "cross_v")


def check_supported(cfg: ModelConfig) -> None:
    """The encoder-decoder of the reference: sinusoidal positions, full
    attention, one attention block kind, no experts and no vision stub."""
    supported = {
        "family": (cfg.family, ("encdec",)),
        "attn_type": (cfg.attn_type, ("full",)),
        "rope_variant": (cfg.rope_variant, ("sinusoidal",)),
        "norm": (cfg.norm, ("rmsnorm", "layernorm")),
        "block_pattern": (cfg.block_pattern, (("attn",),)),
        "n_experts": (cfg.n_experts, (0,)),
        "vision_stub": (cfg.vision_stub, (False,)),
    }
    for field, (have, want) in supported.items():
        if have not in want:
            raise NotImplementedError(
                f"{cfg.name}: {field}={have!r} is not ported for an encoder-decoder "
                f"(only {want!r})")
    if not cfg.is_encdec or cfg.n_encoder_layers <= 0:
        raise NotImplementedError(f"{cfg.name}: not an encoder-decoder")


def layer_kinds(cfg: ModelConfig):
    """Every decoder layer is an attention layer (none is recurrent)."""
    return ["attn"] * cfg.n_layers


def paged_kv_spec(cfg: ModelConfig) -> Dict:
    """Nothing is pooled: the caches are request-shaped (the cross K/V) or
    served on the slab, as the reference's executor does."""
    return {"layers": [dict.fromkeys(_LEAVES, False) for _ in range(cfg.n_layers)]}


def pools_anything(cfg: ModelConfig) -> bool:
    return False


class Attn(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        d = cfg.d_model
        self.q_proj = init_linear(d, cfg.q_dim, bias=True, **kw)
        self.k_proj = init_linear(d, cfg.kv_dim, **kw)
        self.v_proj = init_linear(d, cfg.kv_dim, bias=True, **kw)
        self.o_proj = init_linear(cfg.q_dim, d, bias=True, **kw)


class FF(nn.Module):
    """fc1 (``gate_proj``) and fc2 (``down_proj``), both with biases."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.gate_proj = init_linear(cfg.d_model, cfg.d_ff, bias=True, **kw)
        self.down_proj = init_linear(cfg.d_ff, cfg.d_model, bias=True, **kw)


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.ln1 = common.init_norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.attn = Attn(cfg, **kw)
        self.ln2 = common.init_norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.ff = FF(cfg, **kw)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.ln1 = common.init_norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.self_attn = Attn(cfg, **kw)
        self.ln_x = common.init_norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.cross_attn = Attn(cfg, **kw)
        self.ln2 = common.init_norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.ff = FF(cfg, **kw)


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        check_supported(cfg)
        dtype = common.dtype_of(cfg)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.cfg = cfg
        self.embed = common.init_embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, **kw)
                                        for _ in range(cfg.n_encoder_layers))
        self.enc_norm = common.init_norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, **kw) for _ in range(cfg.n_layers))
        self.dec_norm = common.init_norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.lm_head = init_linear(cfg.d_model, cfg.vocab_size, **kw)


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> EncDec:
    """Random weights made on ``device`` (default: the GPU, raising if there
    is none) from a seeded ``torch.Generator``."""
    device = common.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return EncDec(cfg, device=device, generator=gen)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device=None,
               block_size: int = 16, paged: Optional[bool] = None) -> Dict:
    """Zeros on ``device`` (default: the GPU, raising if there is none):
    per decoder layer ``k``/``v`` ``(batch, max_seq, H, hd)`` and
    ``cross_k``/``cross_v`` ``(batch, encoder_seq, H, hd)``, and a 0-d
    ``pos``.  ``paged=True`` raises: nothing of it is pooled."""
    if paged:
        raise ValueError(f"{cfg.name}: an encoder-decoder's cache is never paged")
    device = common.resolve_device(device)
    dtype = dtype or common.dtype_of(cfg)
    kv = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    xkv = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": [{"k": zeros(kv), "v": zeros(kv), "cross_k": zeros(xkv),
                        "cross_v": zeros(xkv)} for _ in range(cfg.n_layers)]}


# ------------------------------------------------------------------ blocks

def _qkv(cfg: ModelConfig, x: torch.Tensor, p: Attn, policy: SparsityPolicy, phase: str,
         kv_x: Optional[torch.Tensor] = None):
    b, t, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    s = kv_x.shape[1]
    q = sparse_linear(x, p.q_proj, "q_proj", policy, phase)
    k = sparse_linear(kv_x, p.k_proj, "k_proj", policy, phase)
    v = sparse_linear(kv_x, p.v_proj, "v_proj", policy, phase)
    return (q.reshape(b, t, cfg.n_heads, cfg.head_dim),
            k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))


def _ff(x: torch.Tensor, p: FF, policy: SparsityPolicy, phase: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(sparse_linear(x, p.gate_proj, "gate_proj", policy, phase), approximate="tanh")
    return sparse_linear(h, p.down_proj, "down_proj", policy, phase)


def _out(cfg: ModelConfig, o: torch.Tensor, p: Attn, policy: SparsityPolicy, phase: str):
    b, t = o.shape[:2]
    return sparse_linear(o.reshape(b, t, cfg.q_dim), p.o_proj, "o_proj", policy, phase)


def _encode(cfg: ModelConfig, params: EncDec, frame_embeds: torch.Tensor,
            policy: SparsityPolicy, phase: str) -> torch.Tensor:
    """The encoder over ``frame_embeds (B, S, d)``, cast to the model dtype,
    plus sinusoidal positions → ``(B, S, d)``."""
    fe = frame_embeds.to(params.enc_norm.w.dtype)
    b, s, d = fe.shape
    pos = torch.arange(s, device=fe.device).expand(b, s)
    h = fe + common.sinusoidal_positions(pos, d).to(fe.dtype)
    for blk in params.enc_blocks:
        x = common.norm_apply(h, blk.ln1, cfg.norm)
        q, k, v = _qkv(cfg, x, blk.attn, policy, phase)
        o = attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        h = h + _out(cfg, o, blk.attn, policy, phase)
        h = h + _ff(common.norm_apply(h, blk.ln2, cfg.norm), blk.ff, policy, phase)
    return common.norm_apply(h, params.enc_norm, cfg.norm)


def _cross_kv(cfg: ModelConfig, xx, p: Attn, enc_out, cc: Optional[Dict],
              index: Optional[Dict], policy: SparsityPolicy, phase: str):
    """Cross-attention q, k, v: k/v fresh from ``enc_out`` (and written into
    the cache's cross K/V), or with no ``enc_out`` the cached ones."""
    if cc is not None and enc_out is None:
        b, t = xx.shape[:2]
        qx = sparse_linear(xx, p.q_proj, "q_proj", policy, phase)
        rows = index["rows"]
        return (qx.reshape(b, t, cfg.n_heads, cfg.head_dim),
                _slab_rows(cc["cross_k"], rows), _slab_rows(cc["cross_v"], rows))
    qx, kx, vx = _qkv(cfg, xx, p, policy, phase, kv_x=enc_out)
    if cc is not None:
        rows = index["rows"]
        for leaf, new in (("cross_k", kx), ("cross_v", vx)):
            if rows is None:
                cc[leaf].copy_(new)
            else:
                cc[leaf].index_copy_(0, rows, new.to(cc[leaf].dtype))
    return qx, kx, vx


def _decode_blocks(cfg: ModelConfig, params: EncDec, h: torch.Tensor,
                   enc_out: Optional[torch.Tensor], policy: SparsityPolicy, phase: str,
                   cache: Optional[Dict], index: Optional[Dict]) -> torch.Tensor:
    """The decoder stack; ``cache`` None: the whole sequence, no cache."""
    for i, blk in enumerate(params.dec_blocks):
        cc = None if cache is None else cache["layers"][i]
        x = common.norm_apply(h, blk.ln1, cfg.norm)
        q, k, v = _qkv(cfg, x, blk.self_attn, policy, phase)
        o = (attention(q, k, v, causal=True, chunk=cfg.attn_chunk) if cc is None
             else _dense_attention(cfg, q, k, v, cc, index))
        h = h + _out(cfg, o, blk.self_attn, policy, phase)
        xx = common.norm_apply(h, blk.ln_x, cfg.norm)
        qx, kx, vx = _cross_kv(cfg, xx, blk.cross_attn, enc_out, cc, index, policy, phase)
        ox = attention(qx, kx, vx, causal=False, chunk=cfg.attn_chunk)
        h = h + _out(cfg, ox, blk.cross_attn, policy, phase)
        h = h + _ff(common.norm_apply(h, blk.ln2, cfg.norm), blk.ff, policy, phase)
    return h


def _embed_dec(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor,
               pos0: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings plus the sinusoidal positions ``pos0 + arange(T)``
    (``pos0`` None: 0; a 0-d or ``(B,)`` tensor)."""
    b, t = tokens.shape
    h = common.embed(tokens, params.embed)
    pos = torch.arange(t, device=tokens.device).expand(b, t)
    if pos0 is not None:
        pos = pos0.long().reshape(-1, 1) + pos
    return h + common.sinusoidal_positions(pos, cfg.d_model).to(h.dtype)


def _logits(cfg: ModelConfig, params: EncDec, h: torch.Tensor) -> torch.Tensor:
    return dense_linear(common.norm_apply(h, params.dec_norm, cfg.norm), params.lm_head)


# ------------------------------------------------------------------ entries

def forward(cfg: ModelConfig, params: EncDec, batch: Dict, *, policy: SparsityPolicy,
            phase: str = "train") -> torch.Tensor:
    """Encoder over ``batch["frame_embeds"]``, then the causal decoder over
    ``batch["tokens"] (B, T)`` without a cache → ``(B, T, V)`` logits.  The
    phase defaults to ``"train"``, as the reference's does.  Training is
    not ported: under grad mode with parameters that require grad it raises
    ``NotImplementedError`` (ROADMAP A3b)."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters()):
        raise NotImplementedError(f"{cfg.name}: encoder-decoder training: ROADMAP A3b")
    enc_out = _encode(cfg, params, batch["frame_embeds"], policy, phase)
    h = _embed_dec(cfg, params, batch["tokens"], None)
    h = _decode_blocks(cfg, params, h, enc_out, policy, phase, None, None)
    return _logits(cfg, params, h)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: EncDec, batch: Dict, cache: Dict, *,
            policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One-shot prompt ingestion: the encoder over ``batch["frame_embeds"]``
    (its K/V written into every layer's cross cache) and the decoder over
    ``batch["tokens"] (B, T)``, written at position 0.  Returns (last-token
    logits (B, V), cache with ``pos + T``); the cache is updated in place."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    s_c = cache["layers"][0]["k"].shape[1]
    if t > s_c:
        raise ValueError(f"prefill: {t} tokens do not fit a cache of {s_c} positions")
    enc_out = _encode(cfg, params, batch["frame_embeds"], policy, "prefill")
    h = _embed_dec(cfg, params, tokens, None)
    index = _dense_index(cfg, cache, b, t, cache["pos"], None, "prefill")
    h = _decode_blocks(cfg, params, h, enc_out, policy, "prefill", cache, index)
    logits = _logits(cfg, params, h[:, -1:])[:, 0]
    return logits, {**cache, "pos": cache["pos"] + t}


@torch.no_grad()
def prefill_chunk(cfg: ModelConfig, params: EncDec, batch: Dict, cache: Dict, *,
                  policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One prefill chunk ``batch["tokens"] (B, C)`` at the cache offset
    ``cache["pos"]`` (0-d); ``batch["chunk_len"]`` (default C) marks the
    valid rows.  The encoder runs only when the batch carries
    ``frame_embeds`` (a request's first chunk), which writes the cross K/V;
    later chunks reuse them.  Returns (logits of the last valid token
    (B, V), cache with ``pos += chunk_len``); the cache is updated in
    place."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    pos = cache["pos"]
    chunk_len = batch.get("chunk_len")
    if chunk_len is None:
        chunk_len = torch.full((), t, dtype=torch.int32, device=tokens.device)
    s_c = cache["layers"][0]["k"].shape[1]
    if t > s_c:
        raise ValueError(f"prefill_chunk: a {t}-token chunk exceeds the cache's {s_c} rows")
    fe = batch.get("frame_embeds")
    enc_out = None if fe is None else _encode(cfg, params, fe, policy, "prefill")
    h = _embed_dec(cfg, params, tokens, pos)
    index = _dense_index(cfg, cache, b, t, pos, chunk_len, "chunk")
    h = _decode_blocks(cfg, params, h, enc_out, policy, "prefill", cache, index)
    h_last = h.index_select(1, (chunk_len.long() - 1).reshape(1))
    return _logits(cfg, params, h_last)[:, 0], {**cache, "pos": pos + chunk_len}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor, cache: Dict, *,
                policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One decode step for ``tokens (B, 1)`` at ``cache["pos"]`` (a (B,)
    vector of per-row positions, or a scalar), over the cached cross K/V →
    ((B, V) logits, cache with ``pos + 1``); the cache is updated in place."""
    b, t = tokens.shape
    pos = cache["pos"]
    h = _embed_dec(cfg, params, tokens, pos)
    index = _dense_index(cfg, cache, b, t, pos, None, "decode")
    h = _decode_blocks(cfg, params, h, None, policy, "decode", cache, index)
    return _logits(cfg, params, h)[:, 0], {**cache, "pos": pos + 1}
