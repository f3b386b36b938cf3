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

Sharded (a cell under a mesh, ``launch/cells.py``), as the decoder-only
model: the embedding (on ``d_model``: Whisper's vocabulary of 51865 does
not split), the norms and the LM head are gathered whole for an entry
point (``transformer._top``), each encoder and decoder block's shards for that
block (:func:`_block_scope`), except the column shards of the
projections a kernel computes on (q of the encoder, the self- and the
cross-attention, and fc1 under ``paper_policy``).  The self-attention's
``k``/``v`` and the cross ``cross_k``/``cross_v``, held on heads, are
written and read on the rank's heads and the outputs gathered.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import SparsityPolicy
from repro_torch.distributed import sharding
from repro_torch.layers.linear import dense_linear, init_linear, sparse_linear
from repro_torch.models import common
from repro_torch.models.attention import attention
from repro_torch.models.transformer import (_dense_attention, _dense_index, _local_shards,
                                            _slab_rows, _top, check_trainable)

__all__ = ["EncDec", "check_supported", "layer_kinds", "init_params", "init_cache",
           "paged_kv_spec", "pools_anything", "forward", "prefill", "prefill_chunk",
           "decode_step"]

_LEAVES = ("k", "v", "cross_k", "cross_v")
_STACKS = ("enc_blocks", "dec_blocks")      # what a sharded entry point leaves to its blocks


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


# (path in a block, the policy name it prunes under) of each column-parallel
# projection a kernel may compute on the rank's column shard
_ENC_COLUMNS = tuple((f"attn.{n}", n) for n in ("q_proj", "k_proj", "v_proj")) \
    + (("ff.gate_proj", "gate_proj"),)
_DEC_COLUMNS = tuple((f"{a}.{n}", n) for a in ("self_attn", "cross_attn")
                     for n in ("q_proj", "k_proj", "v_proj")) + (("ff.gate_proj", "gate_proj"),)


def _block_scope(params: EncDec, blk: nn.Module, policy: SparsityPolicy, phase: str,
                 columns):
    """A sharded model's block gathered whole for its extent, except the
    column shards a kernel computes on (``transformer._local_shards``; no
    layer index, as every projection here is called without one)."""
    if not sharding.is_sharded(params):
        return contextlib.nullcontext()
    return sharding.gathered(blk, _local_shards(blk, policy, phase, None, columns))


def _encode(cfg: ModelConfig, params: EncDec, frame_embeds: torch.Tensor,
            policy: SparsityPolicy, phase: str) -> torch.Tensor:
    """The encoder over ``frame_embeds (B, S, d)``, cast to the model dtype,
    plus sinusoidal positions → ``(B, S, d)``."""
    fe = frame_embeds.to(params.enc_norm.w.dtype)
    b, s, d = fe.shape
    pos = torch.arange(s, device=fe.device).expand(b, s)
    h = fe + common.sinusoidal_positions(pos, d).to(fe.dtype)
    for blk in params.enc_blocks:
        with _block_scope(params, blk, policy, phase, _ENC_COLUMNS):
            x = common.norm_apply(h, blk.ln1, cfg.norm)
            q, k, v = _qkv(cfg, x, blk.attn, policy, phase)
            o = attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
            h = h + _out(cfg, o, blk.attn, policy, phase)
            h = h + _ff(common.norm_apply(h, blk.ln2, cfg.norm), blk.ff, policy, phase)
    return common.norm_apply(h, params.enc_norm, cfg.norm)


def _cross_attention(cfg: ModelConfig, xx, p: Attn, enc_out, cc: Optional[Dict],
                     index: Optional[Dict], policy: SparsityPolicy, phase: str):
    """Cross-attention over k/v fresh from ``enc_out`` (and written into the
    cache's cross K/V), or with no ``enc_out`` over the cached ones.  A
    cell's cross K/V held on heads are written and read on the rank's heads,
    and the output gathered (``sharding.head_local``); held on the frames'
    rows (heads the model axis does not divide), gathered whole for the
    layer and the rank's rows written back (``sharding.whole_sequence``)."""
    b, t = xx.shape[:2]
    rows = None if index is None else index["rows"]
    if enc_out is None:
        qx = sparse_linear(xx, p.q_proj, "q_proj", policy, phase)
        qx, kx, vx = qx.reshape(b, t, cfg.n_heads, cfg.head_dim), None, None
    else:
        qx, kx, vx = _qkv(cfg, xx, p, policy, phase, kv_x=enc_out)

    def attend(q, k, v, cache):
        if cache is not None and k is not None:
            for leaf, new in (("cross_k", k), ("cross_v", v)):
                if rows is None:
                    cache[leaf].copy_(new)
                else:
                    cache[leaf].index_copy_(0, rows, new.to(cache[leaf].dtype))
        if k is None:
            k, v = _slab_rows(cache["cross_k"], rows), _slab_rows(cache["cross_v"], rows)
        return attention(q, k, v, causal=False, chunk=cfg.attn_chunk)

    split = None if cc is None else sharding.model_dim(cc["cross_k"])
    if split == 2:
        # views of the cache's shards: the same memory, no longer tagged
        mine = {leaf: cc[leaf][:] for leaf in ("cross_k", "cross_v")}
        return sharding.head_local(lambda q, k, v: attend(q, k, v, mine), qx, kx, vx,
                                   cc["cross_k"])
    if split == 1:
        # heads the model axis does not divide: the frames' rows, gathered
        with sharding.whole_sequence(cc, ("cross_k", "cross_v")) as whole:
            return attend(qx, kx, vx, whole)
    return attend(qx, kx, vx, cc)


def _decode_blocks(cfg: ModelConfig, params: EncDec, h: torch.Tensor,
                   enc_out: Optional[torch.Tensor], policy: SparsityPolicy, phase: str,
                   cache: Optional[Dict], index: Optional[Dict]) -> torch.Tensor:
    """The decoder stack; ``cache`` None: the whole sequence, no cache."""
    for i, blk in enumerate(params.dec_blocks):
        cc = None if cache is None else cache["layers"][i]
        with _block_scope(params, blk, policy, phase, _DEC_COLUMNS):
            x = common.norm_apply(h, blk.ln1, cfg.norm)
            q, k, v = _qkv(cfg, x, blk.self_attn, policy, phase)
            o = (attention(q, k, v, causal=True, chunk=cfg.attn_chunk) if cc is None
                 else _dense_attention(cfg, q, k, v, cc, index))
            h = h + _out(cfg, o, blk.self_attn, policy, phase)
            xx = common.norm_apply(h, blk.ln_x, cfg.norm)
            ox = _cross_attention(cfg, xx, blk.cross_attn, enc_out, cc, index, policy, phase)
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
    phase defaults to ``"train"``, as the reference's does; autograd
    records the pass where grad is enabled and the parameters require it,
    without remat, as the reference's forward has none (a W8A8 model
    raises, ``transformer.check_trainable``).  A batch without
    ``frame_embeds`` (a tokens-only ``lm_batch``) raises ``KeyError`` where
    the reference's forward fails on it."""
    check_trainable(cfg, params)
    if "frame_embeds" not in batch:
        raise KeyError(f"{cfg.name}: the encoder-decoder's forward needs batch['frame_embeds'] "
                       "(B, encoder_seq, d_model) beside the tokens; a tokens-only batch "
                       "(data.pipeline.lm_batch) carries none")
    with _top(params, _STACKS):
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
    s_c = sharding.full_shape(cache["layers"][0]["k"])[1]
    if t > s_c:
        raise ValueError(f"prefill: {t} tokens do not fit a cache of {s_c} positions")
    index = _dense_index(cfg, cache, b, t, cache["pos"], None, "prefill")
    with _top(params, _STACKS):
        enc_out = _encode(cfg, params, batch["frame_embeds"], policy, "prefill")
        h = _embed_dec(cfg, params, tokens, None)
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
    s_c = sharding.full_shape(cache["layers"][0]["k"])[1]
    if t > s_c:
        raise ValueError(f"prefill_chunk: a {t}-token chunk exceeds the cache's {s_c} rows")
    fe = batch.get("frame_embeds")
    index = _dense_index(cfg, cache, b, t, pos, chunk_len, "chunk")
    with _top(params, _STACKS):
        enc_out = None if fe is None else _encode(cfg, params, fe, policy, "prefill")
        h = _embed_dec(cfg, params, tokens, pos)
        h = _decode_blocks(cfg, params, h, enc_out, policy, "prefill", cache, index)
        h_last = h.index_select(1, (chunk_len.long() - 1).reshape(1))
        logits = _logits(cfg, params, h_last)[:, 0]
    return logits, {**cache, "pos": pos + chunk_len}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor, cache: Dict, *,
                policy: SparsityPolicy) -> Tuple[torch.Tensor, Dict]:
    """One decode step for ``tokens (B, 1)`` at ``cache["pos"]`` (a (B,)
    vector of per-row positions, or a scalar), over the cached cross K/V →
    ((B, V) logits, cache with ``pos + 1``); the cache is updated in place."""
    b, t = tokens.shape
    pos = cache["pos"]
    index = _dense_index(cfg, cache, b, t, pos, None, "decode")
    with _top(params, _STACKS):
        h = _embed_dec(cfg, params, tokens, pos)
        h = _decode_blocks(cfg, params, h, None, policy, "decode", cache, index)
        logits = _logits(cfg, params, h)[:, 0]
    return logits, {**cache, "pos": pos + 1}
