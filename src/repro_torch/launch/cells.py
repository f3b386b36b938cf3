"""Sharded cells: (arch × shape) → a step on a mesh (port of
``repro/launch/cells.py``).

:func:`build_cell` assembles, for one architecture and one input-shape
cell, the step (the train step, the one-shot prefill or one decode step),
``meta`` stand-ins for every argument (the counterpart of
``ShapeDtypeStruct``: nothing allocated) and their shardings from the
partition rules (``distributed/sharding.py``): train cells shard their
weights FSDP-style (``param_specs(fsdp=True)``) with ZeRO-1 moments
(``opt_state_specs``); prefill and decode cells keep TP-only weights
(``param_specs``) and shard their cache (``cache_specs``).  The default
policy is ``paper_policy(8, 16, cfg.qgate_skip_layers)``, which is not
active in ``"train"``: train cells run dense.

JAX only lowers a cell; the port runs one, or counts one (below).  On a
mesh bound to ranks (``launch.mesh.make_cell_mesh``; ``spawn(...,
grid=...)`` starts them) :meth:`Cell.materialize` builds this rank's
shards: each tensor is made whole from a generator of its own, seeded by
``(seed, name)``, and cut to the rank's slice, so a shard equals the same
slice of the unsharded tensor and a cell at any degree holds the same
model.  :meth:`Cell.run`
executes the step under ``sharding.mesh_scope`` (and, with ``model`` over
1, the TP scope on the ``model`` subgroup, where the kernel projections
run column-parallel): each layer's shards are gathered whole for that
layer alone (``models/transformer.py``), the experts stay shards
(``models/moe._moe_shard_map``), the cache is read on the rank's heads.
A run may take a smaller :class:`ShapeCell` of the same kind than
``SHAPE_CELLS``' (``build_cell(..., shape=)``): a cut the caller states.

The counterpart of the reference's lowering is the **dry rank**
(``sharding.Mesh.at(rank)``: a description given one rank's coordinates):
``materialize(device="meta")`` makes that rank's shards as shapes only (no
generator runs), and :meth:`Cell.run` executes the rank's share of the step
on them, every collective recorded and none run, so ``launch/dryrun.py`` can
count the step (``launch/roofline.count_step``) on the production meshes.

Every family serves sharded: the decoder-only attention families (dense,
MoE, VLM text), the recurrent ones (RWKV6's ``S`` held on its heads,
``models/rwkv6.py``; every other recurrent state on its batch rows;
RecurrentGemma-2B's one-KV-head ring on its sequence) and the
encoder-decoder (an encoder-decoder prefill or train cell's
``frame_embeds`` are seeded from ``(seed, "frame_embeds")`` and cut to the
rank's batch, as ``tokens`` are; its self and cross K/V held on heads).
Every family trains sharded: an MoE train cell holds each expert stack
FSDP-style (``D`` on the DP axes, ``d_ff`` on ``model``), which
``_moe_shard_map`` gathers over the DP axes alone
(``sharding.gather_data``), its backward paying the rank's slice into the
ZeRO-2 accumulator; an RWKV6 train cell runs each layer's recurrence on the
rank's heads from a zero state held on them
(``sharding.fresh_head_state``), its output's gather passing back the
rank's heads' cotangent; RecurrentGemma-2B's attention, whose 10 query
heads and one KV head ``model`` does not divide, runs whole on every rank,
as its serving cell's does; an encoder-decoder train cell draws its tokens
from ``lm_batch`` each step beside the frames it holds.  A W8A8 model does
not train (``transformer.check_trainable``).  A cell the port refuses with
``NotImplementedError`` would be reported ``unported`` by the dry-run; none
is today.  A mesh of more than one rank that is neither bound nor a dry
rank raises: a cell never runs on one rank in place of its mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import SHAPE_CELLS, ModelConfig, ShapeCell, get_config
from repro_torch.core.policy import SparsityPolicy, paper_policy
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp
from repro_torch.models import build_model, common
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import make_train_step, trainable_params

__all__ = ["Cell", "build_cell", "input_specs", "cell_by_name", "is_runnable", "meta_params"]


def cell_by_name(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)


def is_runnable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch at 524k context (skip per spec)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for the model inputs of one cell."""
    b = shape.global_batch
    meta = dict(device="meta")
    if shape.kind == "train":
        batch = {"tokens": torch.empty(b, shape.seq_len + 1, dtype=torch.int32, **meta)}
    elif shape.kind == "prefill":
        batch = {"tokens": torch.empty(b, shape.seq_len, dtype=torch.int32, **meta)}
    else:  # decode: one new token against a seq_len-deep cache
        batch = {"tokens": torch.empty(b, 1, dtype=torch.int32, **meta)}
    if cfg.is_encdec and shape.kind != "decode":
        batch["frame_embeds"] = torch.empty(b, cfg.encoder_seq, cfg.d_model,
                                            dtype=torch.bfloat16, **meta)
    if cfg.vision_stub and shape.kind != "decode":
        batch["pixel_embeds"] = torch.empty(b, cfg.n_patches, cfg.d_model,
                                            dtype=torch.bfloat16, **meta)
    return batch


def _batch_specs(batch: Dict[str, torch.Tensor], mesh: shd.Mesh) -> Dict[str, tuple]:
    entry = shd.batch_spec(mesh)[0]
    n = shd._pieces(entry, mesh)
    return {k: ((entry if v.shape[0] % n == 0 and v.shape[0] >= n else None),)
            + (None,) * (v.dim() - 1) for k, v in batch.items()}


def _seed(seed: int, name: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(name.encode())) % 2**63


def meta_params(cfg: ModelConfig) -> nn.Module:
    """The model's module on ``meta``: every shape and dtype, no memory."""
    from repro_torch.models import encdec, transformer

    cls = encdec.EncDec if cfg.is_encdec else transformer.Transformer
    return cls(cfg, device=torch.device("meta"), generator=torch.Generator())


# the recurrent blocks' own tensors, as ``models/rwkv6.py`` and
# ``models/rglru.py`` make them: leaf → (draw, scale, shift) with draw
# "rand" (uniform), "randn" or None (a constant); RWKV6's bonus ``u`` is
# zeros there and N(0, 0.1²) here, so that each head carries its own
_RECURRENT = {"w0": (None, 0.0, -4.0), "conv_b": (None, 0.0, 0.0),
              "lam": ("rand", 3.0, 2.0), "w_A": ("randn", 0.01, 0.0),
              "w_B": ("randn", 0.01, 0.0), "u": ("randn", 0.1, 0.0)}


def _whole(name: str, owner: nn.Module, like: torch.Tensor, seed: int, device) -> torch.Tensor:
    """The whole tensor ``name`` from its own generator: norms' weights 1,
    biases 0, the embedding N(0, 0.02²), the recurrent blocks' mixes,
    decays, gates and convolution as their modules make them
    (``_RECURRENT``), every other weight N(0, 1/d_in) (``d_in`` its
    second-to-last dim), as ``models/*.init_*`` make them."""
    leaf = name.rsplit(".", 1)[-1]
    shape = tuple(like.shape)
    if isinstance(owner, (common.RMSNorm, common.LayerNorm)) or leaf == "b":
        norm_w = leaf == "w" and isinstance(owner, (common.RMSNorm, common.LayerNorm))
        return torch.full(shape, 1.0 if norm_w else 0.0, dtype=like.dtype, device=device)
    draw, scale, shift = _RECURRENT.get(leaf, ("randn", None, 0.0))
    if leaf.startswith("mix_"):
        draw, scale, shift = "rand", 0.1, 0.45
    elif leaf == "conv_w":
        scale = math.prod(shape) ** -0.25
    if draw is None:
        return torch.full(shape, shift, dtype=like.dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, name))
    w = (torch.rand if draw == "rand" else torch.randn)(shape, generator=gen, device=device)
    if scale is None:
        scale = 0.02 if isinstance(owner, common.Embedding) else shape[-2] ** -0.5
    return (w * scale + shift).to(like.dtype)


@dataclasses.dataclass
class Cell:
    """One (arch × shape) step on ``mesh``: ``args`` are ``meta`` stand-ins
    (params, opt state, batch / params, batch, cache / params, tokens,
    cache), ``in_shardings`` their ``NamedSharding`` trees, ``step`` the
    train step (train cells)."""
    arch: str
    cfg: ModelConfig
    shape: ShapeCell
    mesh: shd.Mesh
    policy: SparsityPolicy
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...] = ()
    grad_accum: int = 1
    step: Any = None

    @property
    def pspecs(self) -> Dict[str, tuple]:
        return {k: s.spec for k, s in self.in_shardings[0].items()}

    def _check_mesh(self) -> None:
        if self.mesh.size > 1 and not (self.mesh.bound or self.mesh.dry):
            raise ValueError(f"{self.arch} × {self.shape.name}: mesh {self.mesh.shape} is not "
                             "bound to ranks (repro_torch.launch.mesh.make_cell_mesh) nor a "
                             "dry rank (mesh.at(rank)); a cell does not run on one rank in "
                             "place of its mesh")

    def _local(self, t: torch.Tensor, spec) -> torch.Tensor:
        return shd.local(t, spec, self.mesh).contiguous() if self.mesh.bound else t

    def _hold(self, t: torch.Tensor, spec, shape) -> torch.Tensor:
        if self.mesh.bound and shd.sharded(spec, self.mesh):
            shd.tag(t, spec, self.mesh, shape)
        return t

    @torch.no_grad()
    def materialize(self, seed: int = 0, device=None, filled: Optional[int] = None,
                    weights: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """This rank's state on ``device``: ``params`` (the model's module,
        every tensor this rank's shard, tagged; cut from ``weights[name]``,
        whole tensors or arrays, where given, else made from ``(seed,
        name)``), and ``opt`` (train),
        ``cache`` (prefill: zeros; decode: every leaf seeded from its own
        ``(seed, name)``, K/V rows ``>= filled`` zero, ``pos`` = ``filled``,
        default ``seq_len - 1``), ``tokens`` (prefill and decode; train
        cells draw ``lm_batch`` per step in :meth:`run`) and an
        encoder-decoder prefill's or train cell's ``frame_embeds``.  On
        ``device="meta"`` every tensor is a shape only: nothing is seeded or
        filled."""
        self._check_mesh()
        device = common.resolve_device(device)
        dry = device.type == "meta"
        params = meta_params(self.cfg)
        train = self.shape.kind == "train"
        for name, like in list(params.named_parameters()):
            *path, leaf = name.split(".")
            owner = params
            for p in path:
                owner = getattr(owner, p)
            spec = self.pspecs[name]
            if dry:
                whole = like
            elif weights is None:
                whole = _whole(name, owner, like, seed, device)
            else:
                whole = torch.as_tensor(weights[name]).to(device=device, dtype=like.dtype)
            t = self._local(whole, spec)
            t = nn.Parameter(t, requires_grad=train and t.is_floating_point())
            owner._parameters[leaf] = self._hold(t, spec, like.shape)
        params._holds_shards = self.mesh.size > 1
        state = {"params": params, "model": build_model(self.cfg, device=device)}
        at = {"train": 2, "prefill": 1}.get(self.shape.kind)
        fe = None if at is None else self.args[at].get("frame_embeds")
        if fe is not None:
            if dry:
                frames = torch.empty(tuple(fe.shape), dtype=fe.dtype, device=device)
            else:
                gen = torch.Generator(device=device).manual_seed(_seed(seed, "frame_embeds"))
                frames = torch.randn(tuple(fe.shape), generator=gen,
                                     device=device).to(fe.dtype)
            state["frame_embeds"] = self._local(frames,
                                                self.in_shardings[at]["frame_embeds"].spec)
        if train:
            with shd.mesh_scope(self.mesh) if self.mesh.bound else contextlib.nullcontext():
                state["opt"] = adamw_init(trainable_params(params))
            return state
        tok = self.args[1]["tokens"] if self.shape.kind == "prefill" else self.args[1]
        if dry:
            tokens = torch.empty(tuple(tok.shape), dtype=torch.int32, device=device)
        else:
            gen = torch.Generator(device=device).manual_seed(_seed(seed, "tokens"))
            tokens = torch.randint(0, self.cfg.vocab_size, tuple(tok.shape), generator=gen,
                                   device=device, dtype=torch.int32)
        state["tokens"] = self._local(tokens, self._bspec())
        state["cache"] = self._cache(seed, device, filled)
        return state

    def _cache(self, seed: int, device, filled: Optional[int]) -> Dict[str, Any]:
        cache, cspecs = self.args[2], self.in_shardings[2]
        decode = self.shape.kind == "decode"
        pos = (self.shape.seq_len - 1 if filled is None else filled) if decode else 0
        layers = []
        for i, (layer, lspec) in enumerate(zip(cache["layers"], cspecs["layers"])):
            out = {}
            for name, like in layer.items():
                spec = lspec[name].spec
                if device.type == "meta":
                    w = torch.empty(tuple(like.shape), dtype=like.dtype, device=device)
                elif decode:
                    # K/V rows, recurrent states, cross K/V: each its own draw;
                    # a ring no longer than pos is full
                    gen = torch.Generator(device=device).manual_seed(
                        _seed(seed, f"cache.layers.{i}.{name}"))
                    w = torch.randn(tuple(like.shape), generator=gen, device=device)
                    if name in ("k", "v"):
                        w[:, pos:] = 0
                    w = w.to(like.dtype)
                else:
                    w = torch.zeros(tuple(like.shape), dtype=like.dtype, device=device)
                out[name] = self._hold(self._local(w, spec), spec, like.shape)
            layers.append(out)
        return {"pos": torch.full((), pos, dtype=torch.int32, device=device),
                "layers": layers}

    @contextlib.contextmanager
    def _scope(self, batch_shards: int):
        model_group = self.mesh.group(("model",)) if self.mesh.bound else None
        with shd.mesh_scope(self.mesh, batch_shards) if self.mesh.bound else \
                contextlib.nullcontext(), tp.scope(model_group):
            yield

    def _gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """A per-row output whole over the DP ranks that hold batch shards."""
        entry = self._bspec()[0]
        return shd.gather(x, (entry,) + (None,) * (x.dim() - 1), self.mesh) \
            if self.mesh.bound else x

    def _bspec(self) -> tuple:
        b = self.in_shardings[2 if self.shape.kind == "train" else 1]
        return (b["tokens"] if isinstance(b, dict) else b).spec

    def run(self, state: Dict[str, Any], step: int = 0, data_seed: int = 0):
        """Execute the cell's step on this rank's ``state`` (in place).
        Train: step ``step`` on ``lm_batch`` of that step (this rank's DP
        slice; an encoder-decoder's with the frames it holds) → metrics.
        Prefill: the one-shot prefill of ``tokens`` (and an
        encoder-decoder's ``frame_embeds``) →
        (last-token logits ``(B, V)``, cache).  Decode: one step of
        ``tokens`` → (logits ``(B, V)``, cache); the logits are whole over
        the batch on every rank."""
        self._check_mesh()
        params, model = state["params"], state["model"]
        shards = self._batch_shards()
        with self._scope(shards):
            if self.shape.kind == "train":
                if model.device.type == "meta":     # a dry rank: shapes only
                    batch = {"tokens": self.args[2]["tokens"]}
                else:
                    batch = lm_batch(DataConfig(self.cfg.vocab_size, self.shape.seq_len,
                                                self.shape.global_batch, data_seed), step,
                                     device=model.device)
                batch = {k: self._local(v, self._bspec()) for k, v in batch.items()}
                if "frame_embeds" in state:         # an encoder-decoder's, held
                    batch["frame_embeds"] = state["frame_embeds"]
                _, state["opt"], metrics = self.step(params, state["opt"], batch)
                return metrics
            if self.shape.kind == "prefill":
                batch = {k: state[k] for k in ("tokens", "frame_embeds") if k in state}
                logits, cache = model.prefill(params, batch, state["cache"], policy=self.policy)
            else:
                logits, cache = model.decode_step(params, state["tokens"], state["cache"],
                                                  policy=self.policy)
        state["cache"] = cache
        return self._gather_batch(logits), cache

    def _batch_shards(self) -> int:
        return shd._pieces(self._bspec()[0], self.mesh) if self.mesh.bound else 1

    def shardings(self) -> Dict[str, Any]:
        """A train cell's state shardings for ``checkpoint.save_checkpoint``
        and ``load_checkpoint`` (``{"params", "opt": {"mu", "nu"}}``)."""
        return {"params": dict(self.in_shardings[0]),
                "opt": {"mu": dict(self.in_shardings[1]["mu"]),
                        "nu": dict(self.in_shardings[1]["nu"])}}


def build_cell(arch: str, shape_name: str, mesh: shd.Mesh,
               policy: Optional[SparsityPolicy] = None, cfg: Optional[ModelConfig] = None,
               grad_accum: int = 16, shape: Optional[ShapeCell] = None,
               opt_cfg: Optional[OptConfig] = None) -> Cell:
    """The cell of ``arch`` × ``shape_name`` on ``mesh`` (a description or
    bound).  ``shape``: a smaller cell of the same kind to run in place of
    ``SHAPE_CELLS``' (its name is kept for ``is_runnable``); ``opt_cfg``:
    a train cell's AdamW settings (default ``OptConfig()``, as the
    reference's)."""
    cfg = cfg or get_config(arch)
    base = cell_by_name(shape_name)
    ok, why = is_runnable(cfg, base)
    if not ok:
        raise ValueError(f"{arch} × {shape_name} not runnable: {why}")
    if shape is not None and shape.kind != base.kind:
        raise ValueError(f"{shape} is not a {base.kind} cell")
    shape = dataclasses.replace(shape or base, name=base.name)
    if policy is None:
        policy = paper_policy(8, 16, qgate_skip_layers=cfg.qgate_skip_layers)
    model = build_model(cfg, device="meta")
    params = meta_params(cfg)
    train = shape.kind == "train"
    pspecs = shd.param_specs(params, mesh, cfg.n_experts, fsdp=train)
    pshard = shd.named(mesh, pspecs)
    batch = input_specs(cfg, shape)
    bshard = shd.named(mesh, _batch_specs(batch, mesh))

    if train:
        named = dict(params.named_parameters())
        ospecs = shd.opt_state_specs(pspecs, named, mesh)
        opt = {"mu": {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
                      for k, p in named.items()}, "step": torch.empty((), dtype=torch.int32,
                                                                      device="meta")}
        opt["nu"] = dict(opt["mu"])
        dp = math.prod(mesh.shape[a] for a in shd.data_axes(mesh))
        ga = max(grad_accum, 1)
        while ga > 1 and (shape.global_batch % ga != 0
                          or (shape.global_batch // ga) % dp != 0):
            ga -= 1
        return Cell(arch=arch, cfg=cfg, shape=shape, mesh=mesh, policy=policy,
                    args=(params, opt, batch),
                    in_shardings=(pshard, {"mu": shd.named(mesh, ospecs["mu"]),
                                           "nu": shd.named(mesh, ospecs["nu"]),
                                           "step": shd.NamedSharding(mesh, ())}, bshard),
                    out_shardings=(pshard, None, None), donate_argnums=(0, 1),
                    grad_accum=ga, step=make_train_step(model, opt_cfg or OptConfig(), policy,
                                                        grad_accum=ga))

    cache = model.init_cache(shape.global_batch, shape.seq_len, paged=False)
    cshard = shd.named(mesh, shd.cache_specs(cache, cfg, mesh))
    if shape.kind == "prefill":
        return Cell(arch=arch, cfg=cfg, shape=shape, mesh=mesh, policy=policy,
                    args=(params, batch, cache), in_shardings=(pshard, bshard, cshard),
                    out_shardings=(None, cshard), donate_argnums=(2,))
    return Cell(arch=arch, cfg=cfg, shape=shape, mesh=mesh, policy=policy,
                args=(params, batch["tokens"], cache),
                in_shardings=(pshard, bshard["tokens"], cshard), out_shardings=(None, cshard),
                donate_argnums=(2,))

