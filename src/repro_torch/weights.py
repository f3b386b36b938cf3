"""Carry the JAX package's parameters into the port's modules.

``from_jax_params(cfg, params_np)`` takes the JAX parameter pytree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) and returns the port's :class:`~repro_torch.models.transformer.
Transformer` with the same weights: the scan-stacked ``periods`` are
unstacked into the block list (block ``b{j}`` of period ``i`` is layer
``i * len(block_pattern) + j``, and the tail's ``t{j}`` follows the last
period), a LayerNorm's bias ``b`` is carried beside its ``w``, and
``amber_scale`` entries are carried as float32.  A recurrent layer's
parameters keep their JAX names and dtypes (``w0``, ``u`` and ``lam`` stay
float32); the Amber scales the JAX walk gives RG-LRU's ``gate_a`` and
``gate_x``, which nothing reads, are not carried.
bfloat16 arrays come out of numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses, so every float array goes through float32
first; bf16 → f32 → bf16 is exact.
A quantized projection's dict (``wq`` and no ``w``) becomes a
:class:`~repro_torch.layers.linear.QuantLinear`: ``wq`` is carried as int8,
stored K-major (one ``(d_out, d_in)`` buffer behind the ``(d_in, d_out)``
view, transposed on the host so no second copy reaches the device);
``w_scale``, ``smooth``, ``act_scale`` and ``amber_scale`` as float32.
An MoE block's ``moe`` dict becomes its :class:`~repro_torch.models.moe.MoE`:
``router/w`` in float32 (its Amber scale, which the JAX walk attaches and
nothing reads, is not carried), ``experts/{gate,up,down}_proj/w``
(layer ``i`` of the ``(L, E, D, F)`` stack) as they are, and ``shared`` as
an MLP with its Amber scales, where the model has one (Mixtral-8x7B has
none: its blocks carry the router and the expert stacks alone); a
quantized dict there (or in an MoE block's attention) becomes a
``QuantLinear`` as anywhere else.
An encoder-decoder's ``enc_blocks``/``dec_blocks`` (vmap-stacked: layer
``i`` is index ``i`` of every leaf) become its block lists, with
``enc_norm``, ``dec_norm``, the embedding and the LM head; a VLM's tree is
the dense family's.

``quantize_linears(model, absmax, qcfg)`` applies the offline
SmoothQuant / Outstanding rewrite (``core.quant.make_quantized_linear``) to
the projections ``qcfg`` quantizes and frees their float weights, in every
family: dense and MoE blocks (the attention projections and the MLP's or
the shared expert's), RWKV6 and RG-LRU layers, and the encoder-decoder's
two stacks.  ``absmax`` is keyed by each projection's place
(:func:`projection_sites`).

``named_from_jax(cfg, tree_np)`` maps any parameter-shaped tree of any
family (parameters, gradients, AdamW's ``mu`` and ``nu``) onto the
port's parameter names (``model.named_parameters()``), unstacked but not
cast: ``from_jax_params`` casts to ``cfg.dtype``, which would round float32
moments of a bf16 model.

This module imports nothing of JAX: it sees only numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.policy import ATTN_PROJS, MLP_PROJS
from repro_torch.core.pruner import SCALE_KEY
from repro_torch.layers.linear import Linear, QuantLinear
from repro_torch.models import common, encdec, transformer

__all__ = ["from_jax_params", "named_from_jax", "projection_sites", "quantize_linears",
           "reference_leaves"]


def _t(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(device=device,
                                                                 dtype=dtype)


def _load(owner, names, p: Dict[str, Any], device) -> None:
    """Copy ``p[name]`` into each tensor ``owner.<name>``, in that tensor's
    dtype (the float32 ones stay float32)."""
    for name in names:
        dst = getattr(owner, name)
        dst.copy_(_t(p[name], dst.dtype, device))


def _quant_linear(p: Dict[str, Any], dtype, device) -> QuantLinear:
    f32 = lambda k: _t(p[k], torch.float32, device)
    ql = quant.QuantizedLinear(
        wq=torch.from_numpy(np.ascontiguousarray(np.asarray(p["wq"], dtype=np.int8).T)
                            ).to(device).t(),
        w_scale=f32("w_scale"), smooth=f32("smooth"), act_scale=f32("act_scale"),
        per_token=bool(p.get("per_token", False)))
    return QuantLinear(ql, amber_scale=f32(SCALE_KEY) if SCALE_KEY in p else None,
                       bias=_t(p["b"], dtype, device) if "b" in p else None)


def _load_linear(owner, name: str, p: Dict[str, Any], dtype, device) -> None:
    if "wq" in p:
        setattr(owner, name, _quant_linear(p, dtype, device))
        return
    lin = getattr(owner, name)
    lin.w.copy_(_t(p["w"], dtype, device))
    if lin.b is not None:
        lin.b.copy_(_t(p["b"], dtype, device))
    if SCALE_KEY in p:
        lin.amber_scale = _t(p[SCALE_KEY], torch.float32, device)


def _load_norm(norm, p: Dict[str, Any], dtype, device) -> None:
    norm.w.copy_(_t(p["w"], dtype, device))
    if "b" in p:                              # LayerNorm
        norm.b.copy_(_t(p["b"], dtype, device))


def _layer_params(cfg: ModelConfig, params_np: Dict, i: int) -> Dict:
    """Layer ``i`` of the JAX pytree: block ``b{j}`` of the scan-stacked
    period ``i // len(pattern)``, or the tail's ``t{j}``.  A leaf without a
    layer axis (a quantized dict's ``per_token`` flag) is the same in every
    layer and is carried as it is."""
    plen = len(cfg.block_pattern)
    n_per, _ = transformer._n_periods(cfg)
    if i >= n_per * plen:
        return params_np["tail"][f"t{i - n_per * plen}"]
    per, j = divmod(i, plen)
    return _take(params_np["periods"][f"b{j}"], per)


def _take(d: Dict, i: int) -> Dict:
    """Index ``i`` of every leaf with a leading layer axis."""
    return {k: _take(v, i) if isinstance(v, dict) else np.asarray(v)[i] if np.ndim(v) else v
            for k, v in d.items()}


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, params_np: Dict, device=None
                    ) -> transformer.Transformer:
    """The port's model holding the JAX parameters ``params_np``, on
    ``device`` (default: the GPU, raising if there is none)."""
    device = common.resolve_device(device)
    dtype = common.dtype_of(cfg)
    if cfg.is_encdec:
        return _from_jax_encdec(cfg, params_np, dtype, device)
    model = transformer.init_params(cfg, 0, device=device)
    model.embed.w.copy_(_t(params_np["embed"]["w"], dtype, device))
    _load_norm(model.final_norm, params_np["final_norm"], dtype, device)
    if model.lm_head is not None:
        _load_linear(model, "lm_head", params_np["lm_head"], dtype, device)
    for i, (kind, blk) in enumerate(zip(transformer.layer_kinds(cfg), model.blocks)):
        lp = _layer_params(cfg, params_np, i)
        if kind == "rwkv6":
            _load_rwkv6(blk.rwkv, lp["rwkv"], dtype, device)
            continue
        _load_norm(blk.ln1, lp["ln1"], dtype, device)
        _load_norm(blk.ln2, lp["ln2"], dtype, device)
        if kind == "rglru":
            _load_rglru(blk.rglru, lp["rglru"], dtype, device)
        else:
            _load_attn(blk, lp, dtype, device)
            if "moe" in lp:
                _load_moe(blk.moe, lp["moe"], dtype, device)
                continue
        for name in ("gate_proj", "up_proj", "down_proj"):
            _load_linear(blk.mlp, name, lp["mlp"][name], dtype, device)
    return model


def named_from_jax(cfg: ModelConfig, tree_np: Dict) -> Dict[str, np.ndarray]:
    """``{port parameter name: array}`` of a parameter-shaped JAX tree of
    any family (``blocks.{i}.`` + the layer's path, RWKV6's and RG-LRU's
    included, ``embed.w``, ``final_norm.w``, ``lm_head.w``; an expert
    stack's ``w`` dropped, as ``models/moe.Experts`` names it; an
    encoder-decoder's ``enc_blocks.{i}.`` and ``dec_blocks.{i}.`` +
    the layer's path, ``enc_norm``, ``dec_norm``), each array as it is: no
    cast.  The Amber scales are buffers in the port, not parameters, and
    are left out."""
    out: Dict[str, np.ndarray] = {}

    def walk(prefix: str, d: Dict) -> None:
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            elif k != SCALE_KEY:
                name = prefix + k
                if ".moe.experts." in name:
                    name = name[:-len(".w")]
                out[name] = np.asarray(v)

    if cfg.is_encdec:
        walk("", {k: v for k, v in tree_np.items() if k not in encdec._STACKS})
        for stack, n in zip(encdec._STACKS, (cfg.n_encoder_layers, cfg.n_layers)):
            for i in range(n):
                walk(f"{stack}.{i}.", _take(tree_np[stack], i))
        return out
    walk("", {k: v for k, v in tree_np.items() if k not in ("periods", "tail")})
    for i in range(cfg.n_layers):
        walk(f"blocks.{i}.", _layer_params(cfg, tree_np, i))
    return out


def reference_leaves(cfg: ModelConfig, names) -> Dict[str, str]:
    """``{port parameter name: the JAX tree's leaf that holds it}``: a
    layer's parameter is a row of its stacked leaf there (``periods`` block
    ``b{i % len(pattern)}``, the unrolled ``tail``'s ``t{j}``, an
    encoder-decoder's ``enc_blocks`` / ``dec_blocks``), every other the leaf
    of its own name.  What the reference's per-tensor operations
    (``distributed/compression.py``'s scale) take as one tensor."""
    n_per, _ = transformer._n_periods(cfg)
    plen = len(cfg.block_pattern)
    out = {}
    for name in names:
        stack, _, rest = name.partition(".")
        layer, _, path = rest.partition(".")
        if stack in encdec._STACKS:
            out[name] = f"{stack}.{path}"
        elif stack == "blocks" and int(layer) >= n_per * plen:
            out[name] = f"tail.t{int(layer) - n_per * plen}.{path}"
        elif stack == "blocks":
            out[name] = f"periods.b{int(layer) % plen}.{path}"
        else:
            out[name] = name
    return out


def _load_attn(p, lp: Dict, dtype, device) -> None:
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        _load_linear(p, name, lp[name], dtype, device)


def _from_jax_encdec(cfg: ModelConfig, params_np: Dict, dtype, device) -> encdec.EncDec:
    model = encdec.init_params(cfg, 0, device=device)
    model.embed.w.copy_(_t(params_np["embed"]["w"], dtype, device))
    _load_linear(model, "lm_head", params_np["lm_head"], dtype, device)
    for name in ("enc_norm", "dec_norm"):
        _load_norm(getattr(model, name), params_np[name], dtype, device)
    for stack, blocks, attns in (("enc_blocks", model.enc_blocks, ("attn",)),
                                 ("dec_blocks", model.dec_blocks, ("self_attn", "cross_attn"))):
        for i, blk in enumerate(blocks):
            lp = _take(params_np[stack], i)
            for name in ("ln1", "ln2") + (("ln_x",) if "ln_x" in lp else ()):
                _load_norm(getattr(blk, name), lp[name], dtype, device)
            for name in attns:
                _load_attn(getattr(blk, name), lp[name], dtype, device)
            for name in ("gate_proj", "down_proj"):
                _load_linear(blk.ff, name, lp["ff"][name], dtype, device)
    return model


def _load_rwkv6(p, lp: Dict, dtype, device) -> None:
    tm, cm = lp["tm"], lp["cm"]
    _load(p.tm, ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "w0", "w_A", "w_B", "u"), tm,
          device)
    for name in ("r_proj", "k_proj_tm", "v_proj_tm", "g_proj", "o_proj"):
        _load_linear(p.tm, name, tm[name], dtype, device)
    _load_norm(p.tm.ln_x, tm["ln_x"], dtype, device)
    _load(p.cm, ("mix_k", "mix_r"), cm, device)
    for name in ("gate_proj", "down_proj", "up_proj"):
        _load_linear(p.cm, name, cm[name], dtype, device)


def _load_rglru(p, lp: Dict, dtype, device) -> None:
    for name in ("q_proj", "gate_proj", "o_proj"):
        _load_linear(p, name, lp[name], dtype, device)
    _load(p, ("conv_w", "conv_b", "lam"), lp, device)
    for name in ("gate_a", "gate_x"):      # plain products: their scales are not read
        _load(getattr(p, name), ("w",), lp[name], device)


def _load_moe(p, lp: Dict, dtype, device) -> None:
    p.router.w.copy_(_t(lp["router"]["w"], torch.float32, device))
    for name in ("gate_proj", "up_proj", "down_proj"):
        getattr(p.experts, name).copy_(_t(lp["experts"][name]["w"], dtype, device))
    if p.shared is not None:
        for name in ("gate_proj", "up_proj", "down_proj"):
            _load_linear(p.shared, name, lp["shared"][name], dtype, device)


# an RWKV6 layer's projections: (sub-block, attribute, the module name its
# ``sparse_linear`` call passes); W_A/W_B of the decay are plain float products
_RWKV6 = (("tm", "r_proj", "q_proj"), ("tm", "k_proj_tm", "q_proj"),
          ("tm", "v_proj_tm", "q_proj"), ("tm", "g_proj", "q_proj"), ("tm", "o_proj", "o_proj"),
          ("cm", "gate_proj", "gate_proj"), ("cm", "down_proj", "down_proj"),
          ("cm", "up_proj", "up_proj"))
# an RG-LRU block's: W_in, W_gate and W_out; gate_a/gate_x and the conv stay float32
_RGLRU = ("q_proj", "gate_proj", "o_proj")


def projection_sites(model):
    """Every projection the W8A8 rewrite may take, as ``(key, owner,
    attribute, module, layer)``: ``module`` is the name its ``sparse_linear``
    call passes (what ``QuantConfig.should_quantize`` sees), ``layer`` the
    index ``skip_layers`` is held to (None in the encoder-decoder), and
    ``key`` its ``absmax`` key, its place in the module tree:

    * an attention block: ``(i, name)`` for q/k/v/o and the MLP's (or an MoE
      block's shared expert's) gate/up/down; the routed experts are
      ``moe.Experts`` parameters, not projections;
    * an RWKV6 layer: ``(i, "tm.r_proj")``, ``"tm.k_proj_tm"``,
      ``"tm.v_proj_tm"``, ``"tm.g_proj"`` (module ``q_proj``),
      ``"tm.o_proj"``, ``"cm.gate_proj"``, ``"cm.down_proj"``,
      ``"cm.up_proj"``;
    * an RG-LRU layer: ``(i, "rglru.q_proj")``, ``"rglru.gate_proj"``,
      ``"rglru.o_proj"``, and its MLP's as an attention block's;
    * the encoder-decoder: ``("enc", i, "attn.<name>")``, ``("enc", i,
      "ff.<name>")``, ``("dec", i, "self_attn.<name>")``, ``("dec", i,
      "cross_attn.<name>")``, ``("dec", i, "ff.<name>")`` (fc1 and fc2 are
      ``gate_proj`` and ``down_proj``)."""
    cfg = model.cfg
    if cfg.is_encdec:
        for stack, blocks, parts in (("enc", model.enc_blocks, ("attn", "ff")),
                                     ("dec", model.dec_blocks, ("self_attn", "cross_attn", "ff"))):
            for i, blk in enumerate(blocks):
                for part in parts:
                    names = ("gate_proj", "down_proj") if part == "ff" else ATTN_PROJS
                    for name in names:
                        yield (stack, i, f"{part}.{name}"), getattr(blk, part), name, name, None
        return
    for i, (kind, blk) in enumerate(zip(transformer.layer_kinds(cfg), model.blocks)):
        if kind == "rwkv6":
            for part, name, module in _RWKV6:
                yield (i, f"{part}.{name}"), getattr(blk.rwkv, part), name, module, i
            continue
        if kind == "rglru":
            for name in _RGLRU:
                yield (i, f"rglru.{name}"), blk.rglru, name, name, i
        else:
            for name in ATTN_PROJS:
                yield (i, name), blk, name, name, i
        ffn = blk.moe.shared if hasattr(blk, "moe") else blk.mlp
        if ffn is not None:
            for name in MLP_PROJS:
                yield (i, name), ffn, name, name, i


@torch.no_grad()
def quantize_linears(model, absmax: Dict[Tuple, torch.Tensor],
                     qcfg: quant.QuantConfig):
    """Replace every projection ``qcfg.should_quantize(module, layer)``
    selects with its :class:`QuantLinear` (``absmax[key]`` is the ``(d_in,)``
    calibrated activation absmax; keys, modules and layers as
    :func:`projection_sites` gives them), keeping its Amber scale and bias,
    and free the float weight; the int8 weights are stored K-major
    (``quant.k_major``), one buffer each.  Amber scales are computed from
    the float weights, so run ``precompute_scales`` first.  In place;
    returns ``model``.

    In an MoE block the routed experts stay in the model dtype, as the
    reference's do (``repro/models/moe.py`` has no quantized grouped
    product).  Under ``QuantConfig()`` (``down_proj`` skipped) an RWKV6
    layer keeps its channel mix's value projection and the encoder-decoder
    its fc2 in the model dtype.  ``skip_layers``: the reference's recurrent
    and encoder-decoder calls pass no layer index, so its stacked trees
    give every layer the same choice and only ``skip_layers=()`` has a
    reference there.  The port honours a non-empty one by block index in the
    RWKV6 and RG-LRU models, as in the dense family; in the encoder-decoder,
    where a layer index names nothing (two stacks, each numbered from 0), a
    non-empty one raises ``ValueError``."""
    if model.cfg.is_encdec and qcfg.skip_layers:
        raise ValueError(f"{model.cfg.name}: skip_layers {qcfg.skip_layers} names no layer of "
                         "the encoder-decoder's two stacks")
    for key, owner, name, module, layer in list(projection_sites(model)):
        lin = getattr(owner, name)
        if not isinstance(lin, Linear) or not qcfg.should_quantize(module, layer):
            continue
        am = torch.as_tensor(absmax[key], device=lin.w.device)
        ql = quant.make_quantized_linear(lin.w, am, qcfg)
        setattr(owner, name, QuantLinear(
            ql, lin.amber_scale, None if lin.b is None else lin.b.detach()))
    return model
