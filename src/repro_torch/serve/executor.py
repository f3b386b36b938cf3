"""Device layer of the serving engine (port of ``repro/serve/executor.py``).

The :class:`Executor` owns the cache and one step program per
:data:`STEP_BUCKETS` row, and runs the scheduler's
:class:`~repro_torch.serve.scheduler.StepPlan`s.  A step program is the JAX
package's fused step: the active request's prefill chunk first, then the
slot-batched decode, on the same in-place cache — the decode half reads
the KV the prefill half just wrote.  The cache is the paged pool, or the
dense per-slot slab (``serve/slots.py``) where the model's
``paged_kv_spec`` pools nothing (sliding-window rings) or
``cfg.paged`` is False, as the JAX package chooses; the slab's steps are
graphs of the same programs.  A sliding-window model's ``chunk_size``
must fit its ring (``min(window, max_seq)``; the JAX package asserts it,
the port raises ``ValueError``).  A model with recurrent layers
(``exact_chunks``: their scans cannot mask padded tokens) gets exact
dyadic chunks from the scheduler, every one a power of two of at most
``chunk_size`` tokens, and keeps its prefix cache off, as in the JAX
package.  Its operands are fixed-shape device buffers: the slot (a 0-d
index, :mod:`~repro_torch.serve.slots`), the chunk tokens padded to
``chunk_size`` (an exact chunk reads the first ``chunk_len`` of them),
``chunk_len``, the decode tokens and the ``active`` mask and the fault
operand, written from the host before each step in one copy.  The decode
half passes ``active`` to the model, so a slot that is empty or still
prefilling keeps its recurrent state (the JAX package selects every slab
leaf per active slot after the step).  The fault operand is a 0-d
float32 view of the buffer's last 4 bytes that the program adds to its
logits (0 on a clean step, NaN when the engine injects a ``"nonfinite"``
fault; a device operand, so a replayed graph sees it, where a Python
number would be baked in at capture).  It returns the logits and one all-finite flag (inactive
decode rows masked).

Modality extras ride with a request's first prefill chunk, as in the JAX
package: an encoder-decoder's ``frame_embeds (1, encoder_seq, d_model)``
(the chunk runs the encoder and writes the slot's cross K/V) and a VLM's
``pixel_embeds (1, n_patches, d_model)`` (they replace the chunk's first
rows; ``chunk_size`` must cover them, else ``ValueError``).  Each has a
device buffer of its own in the model dtype, at a fixed address, filled
from the host before the step; a step that carries extras runs a second
graph of its bucket's program, which reads the buffers, so
``trace_counts`` reads 2 for a prefill program that ran with and without
them, as the JAX package traces it twice.  An encoder-decoder is served on
the slab in padded chunks.

The legacy two-program split (``ContinuousConfig.fused_step=False``) runs
the prefill-only and decode-only programs of the same table through
:meth:`Executor.prefill` and :meth:`Executor.decode`, as programs of their
own under the JAX package's names: ``prefill`` (``prefill_replay`` for a
replay chunk) and ``decode``.

On the GPU each program is a CUDA graph, the counterpart of the JAX
package's jit: the first step of a bucket runs the program eagerly (the
real step; it also builds the kernels), then captures it; every later step
of the bucket copies its operands in, applies the plan's cache effects and
replays the graph.  All graphs of an executor share one memory pool (they
never run at once) and read the cache and the parameters they were
captured with: a call with another ``params`` object captures again.  A
capture that fails raises; nothing reruns eagerly.  ``trace_counts[name]``
counts the captures of each program (1 for every program a run used), as
the JAX package counts traces; on the CPU, where there are no graphs and
the program runs as it is, it counts each program's first use.  The launch
counters of the kernels count replays (``kernels/_capture.py``).

Tensor parallelism: an executor built with a ``group`` (one rank of a
``torch.distributed`` group of ``tp`` ranks, every rank running the same
host code) opens a TP scope on it around every step, so the projection
kernels run column-parallel and paged attention head-sharded
(``distributed/tp.py``); where the model's KV heads divide over the ranks,
each rank's pools hold only its share of them.  Under a gloo group (the
CPU, and ranks that share one card) every step runs eagerly, decided here
when the executor is built: a CUDA graph cannot hold a gloo collective.
``trace_counts`` then counts each program's first use, as on the CPU.

Sampling runs after the program, on its logits, with the explicit
``torch.Generator`` (temperature > 0) or ``argmax``; one device-to-host copy
then reads the tokens and the finite flag.  There is no oracle twin and no
degradation ladder: a step whose logits are non-finite raises.  Replay
chunks (re-ingesting emitted tokens after a preemption) run with the DENSE
policy, since their KV was first written by the dense decode step.
Per-bucket call counts and wall seconds (``buckets``) and ``dispatches``
are kept beside ``trace_counts``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.distributed import tp
from repro_torch.kernels import _capture
from repro_torch.models.common import dtype_of, resolve_device
from repro_torch.serve import slots as slot_ops
from repro_torch.serve.paged import init_paged_cache
from repro_torch.serve.scheduler import StepPlan

__all__ = ["Executor", "StepResult", "STEP_BUCKETS", "declared_trace_keys"]

# (replay, has_prefill, has_decode) → step name, as in the JAX package
STEP_BUCKETS: Dict[Tuple[bool, bool, bool], str] = {
    (False, True, False): "step_prefill",
    (False, True, True): "step_prefill_decode",
    (False, False, True): "step_decode",
    (True, True, False): "step_replay",
    (True, True, True): "step_replay_decode",
}

# legacy two-program split (``prefill()``/``decode()``)
_LEGACY_TRACE_KEYS = ("prefill", "prefill_replay", "decode")


def declared_trace_keys() -> Tuple[str, ...]:
    """Every ``trace_counts`` key an :class:`Executor` may record: the fused
    buckets and the legacy split (the port has no ``_oracle`` twins)."""
    return tuple(STEP_BUCKETS.values()) + _LEGACY_TRACE_KEYS


@dataclasses.dataclass
class StepResult:
    prefill_token: Optional[int] = None          # sampled iff the plan had prefill
    decode_tokens: Optional[np.ndarray] = None   # (num_slots,) iff decode


class Executor:
    """Owns the cache, the step programs and their graphs; executes plans.
    Never reads or mutates request state."""

    def __init__(self, model, policy: SparsityPolicy, cfg, group=None):
        self.model = model
        self.policy = policy
        self.cfg = cfg
        self.group = group       # the TP group (None: one rank)
        self.device = resolve_device(model.device)   # a model on the GPU needs one
        model.paged_kv_spec()        # raises for layouts the port does not model
        mcfg = model.cfg
        if (mcfg.attn_type in ("swa", "local")
                and cfg.chunk_size > min(mcfg.window, cfg.max_seq)):
            raise ValueError(f"chunk_size {cfg.chunk_size} must fit the sliding-window "
                             f"ring of min(window {mcfg.window}, max_seq {cfg.max_seq}) rows")
        # the slab where the pool would hold nothing, or where asked
        self.paged = bool(cfg.paged) and model.pools_anything()
        # recurrent scans cannot mask padded tokens out of their state
        self.exact_chunks = any(kind != "attn" for kind in model.layer_kinds())
        self.paged_kernel = self.paged and bool(policy.use_kernels)
        # the modality buffers' shapes, by batch key
        self.extras_shapes: Dict[str, Tuple[int, ...]] = {
            k: (1, *shape) for k, shape in model.stub_shapes().items()}
        if mcfg.vision_stub and cfg.chunk_size < mcfg.n_patches:
            raise ValueError(f"chunk_size {cfg.chunk_size} must cover the VLM's "
                             f"{mcfg.n_patches} patch embeddings")
        dense = DENSE.with_(use_kernels=policy.use_kernels)
        # replay and decode are dense
        self._programs: Dict[Tuple[bool, bool, bool], Callable] = {
            key: self._make_step_fn(dense if key[0] else policy, dense, key[1], key[2])
            for key in STEP_BUCKETS}
        self.cache = None
        self._operands: Optional[torch.Tensor] = None
        self._extras: Dict[str, torch.Tensor] = {}
        self._graphs = _capture.Programs(self.device, capture=tp.captures(group))
        self.buckets: Dict[str, Dict[str, float]] = {}
        self.dispatches = 0
        self._gen = None

    # ------------------------------------------------------- step programs
    def _make_step_fn(self, pf_policy: SparsityPolicy, dec_policy: SparsityPolicy,
                      has_prefill: bool, has_decode: bool) -> Callable:
        model = self.model      # not self: the executor must not hold itself in a cycle

        def step_fn(params, cache, slot, tokens, chunk_len, toks, active, fault, extras=None):
            """One fused step on the cache, updated in place.  ``slot``: 0-d
            int; ``tokens (1, C)``; ``chunk_len``: 0-d int32; ``toks``,
            ``active``: ``(num_slots,)``; ``fault``: 0-d float32 added to
            the logits; ``extras``: the modality tensors of a first chunk.
            Returns (prefill logits ``(V,)`` or None, decode logits
            ``(num_slots, V)`` or None, all-finite 0-d bool)."""
            finite = torch.ones((), dtype=torch.bool, device=cache["pos"].device)
            p_logits = d_logits = None
            if has_prefill:
                sub = slot_ops.slice_slot(cache, slot)
                p_logits, sub = model.prefill_chunk(
                    params, {"tokens": tokens, "chunk_len": chunk_len, **(extras or {})},
                    sub, policy=pf_policy)
                slot_ops.write_slot(cache, slot, sub)
                p_logits = p_logits[0] + fault
                finite = finite & torch.isfinite(p_logits).all()
            if has_decode:
                # inactive slots keep their recurrent state
                d_logits, new = model.decode_step(params, toks[:, None],
                                                  {**cache, "active": active},
                                                  policy=dec_policy)
                slot_ops.where_active(active, new, cache)
                d_logits = d_logits + fault
                # inactive slots may hold junk logits; only active rows count
                finite = finite & (torch.isfinite(d_logits).all(dim=-1) | ~active).all()
            return p_logits, d_logits, finite
        return step_fn

    @property
    def trace_counts(self) -> Dict[str, int]:
        """Captures of each program's graph (on the CPU: first uses)."""
        return self._graphs.trace_counts

    def step_program(self, bucket: Tuple[bool, bool, bool]) -> Callable:
        """The raw step program of a phase-presence bucket: ``prog(params,
        cache, slot, tokens, chunk_len, toks, active, fault, extras=None)``,
        eager on any device (what a bucket's graph captures)."""
        return self._programs[bucket]

    def step_programs(self) -> Iterator[Tuple[Tuple[bool, bool, bool], str, Callable]]:
        """``(bucket, name, program)`` for every :data:`STEP_BUCKETS` row."""
        for bucket, name in STEP_BUCKETS.items():
            yield bucket, name, self.step_program(bucket)

    # ------------------------------------------------------------ sampling
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if self._gen is None:
            self._gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[..., 0].to(torch.int32)

    def sampler_state(self) -> Optional[torch.Tensor]:
        """The sampling generator's state (None before its first draw)."""
        return None if self._gen is None else self._gen.get_state()

    def set_sampler_state(self, state: Optional[torch.Tensor]) -> None:
        """Resume sampling from :meth:`sampler_state`'s value; None restarts
        from ``cfg.seed``."""
        self._gen = None
        if state is not None:
            self._gen = torch.Generator(device=self.device)
            self._gen.set_state(state)

    # ----------------------------------------------------------- the cache
    def init_cache(self, num_blocks: Optional[int]) -> None:
        if self.cache is None:
            cfg = self.cfg
            if self.paged:
                self.cache = init_paged_cache(self.model.cfg, cfg.num_slots, cfg.max_seq,
                                              cfg.block_size, num_blocks, device=self.device,
                                              kv_heads=self.pool_heads())
            else:
                self.cache = slot_ops.init_slot_cache(self.model, cfg.num_slots, cfg.max_seq)
            # [slot, chunk_len, chunk tokens (C), decode tokens (S), active (S),
            #  fault (float32 bits)]
            self._operands = torch.zeros(3 + cfg.chunk_size + 2 * cfg.num_slots,
                                         dtype=torch.int32, device=self.device)
            dtype = dtype_of(self.model.cfg)
            self._extras = {k: torch.zeros(shape, dtype=dtype, device=self.device)
                            for k, shape in self.extras_shapes.items()}

    def pool_heads(self) -> int:
        """The KV heads this rank's pools hold: its share where the model's
        heads divide over the TP group, else all of them."""
        mcfg = self.model.cfg
        size = tp.size_of(self.group)
        if tp.shards_kv(mcfg.n_heads, mcfg.n_kv_heads, size):
            return mcfg.n_kv_heads // size
        return mcfg.n_kv_heads

    def apply_effects(self, plan: StepPlan) -> None:
        """Slot resets decided at admission and the rewritten host block
        table, applied before the step."""
        for slot, pos in plan.resets:
            slot_ops.reset_slot(self.cache, slot, pos=pos)
        if plan.table is not None:
            self.cache["block_table"].copy_(torch.from_numpy(plan.table))

    def _views(self, length: Optional[int] = None):
        """The step programs' operands: views of the operand buffer (the
        chunk tokens' first ``length``, default ``chunk_size``), ``active``
        as a mask (made inside the program, so a graph makes it at replay),
        and the fault operand, the last slot read as float32."""
        c, s = self.cfg.chunk_size, self.cfg.num_slots
        buf = self._operands
        t = c if length is None else length
        return (buf[0], buf[2:2 + t].reshape(1, t), buf[1], buf[2 + c:2 + c + s],
                buf[2 + c + s:2 + c + 2 * s] != 0, buf[-1:].view(torch.float32)[0])

    def _write_operands(self, plan: StepPlan, fault: float) -> None:
        c, s = self.cfg.chunk_size, self.cfg.num_slots
        host = np.zeros(3 + c + 2 * s, np.int32)
        if plan.prefill is not None:
            pw = plan.prefill
            host[0], host[1] = pw.req.slot, pw.chunk_len
            host[2:2 + pw.tokens.size] = pw.tokens.reshape(-1)
        if plan.decode is not None:
            host[2 + c:2 + c + s] = plan.decode.toks
            host[2 + c + s:2 + c + 2 * s] = plan.decode.active
        host[-1:] = np.float32(fault).reshape(1).view(np.int32)
        self._operands.copy_(torch.from_numpy(host))

    # ------------------------------------------------------------ dispatch
    def step(self, params, plan: StepPlan, fault: float = 0.0,
             extras: Optional[Dict] = None) -> StepResult:
        """Run a fused plan through its bucket's program.  ``fault`` is the
        value of the fault operand (0.0 clean, NaN injected); ``extras`` the
        modality arrays of the prefill chunk (the engine sends them with a
        request's first chunk only)."""
        return self._run(params, plan, STEP_BUCKETS[plan.bucket], fault, extras)

    def prefill(self, params, plan: StepPlan, fault: float = 0.0,
                extras: Optional[Dict] = None) -> int:
        """Legacy two-program split, phase 1: the chunk of a prefill-only
        plan through the ``prefill`` program (``prefill_replay`` for a
        replay chunk); returns the token sampled from its last position,
        which the engine keeps only when the chunk completed the
        sequence."""
        name = "prefill_replay" if plan.prefill.replay else "prefill"
        return self._run(params, plan, name, fault, extras).prefill_token

    def decode(self, params, plan: StepPlan, fault: float = 0.0) -> np.ndarray:
        """Legacy two-program split, phase 2: one slot-batched decode step
        of a decode-only plan through the ``decode`` program; returns the
        ``(num_slots,)`` next tokens."""
        return self._run(params, plan, "decode", fault).decode_tokens

    def _write_extras(self, extras: Dict) -> Dict[str, torch.Tensor]:
        """Copy a first chunk's modality arrays into their device buffers
        (cast to the model dtype) and return the buffers."""
        for k, arr in extras.items():
            if k not in self._extras:
                raise ValueError(f"{self.model.cfg.name} takes no {k!r} (only "
                                 f"{sorted(self._extras)})")
            buf = self._extras[k]
            src = torch.as_tensor(arr)
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(f"{k}: shape {tuple(src.shape)}, expected {tuple(buf.shape)}")
            buf.copy_(src)
        return {k: self._extras[k] for k in sorted(extras)}

    @torch.no_grad()
    def _run(self, params, plan: StepPlan, name: str, fault: float,
             extras: Optional[Dict] = None) -> StepResult:
        """Run one plan through program ``name`` (the plan's bucket's body):
        operands (and a first chunk's extras) in, the program, sampling, one
        host sync."""
        t0 = time.perf_counter()
        pw, dw = plan.prefill, plan.decode
        self._write_operands(plan, fault)
        ex = self._write_extras(extras) if extras and pw is not None else {}
        prog = self._programs[plan.bucket]
        # an exact chunk runs the program of its own length; a chunk with
        # extras the program's second graph, which reads their buffers
        length = pw.chunk_len if pw is not None and self.exact_chunks else None
        shape = (length, tuple(ex)) if ex else length
        with tp.scope(self.group):
            p_logits, d_logits, finite = self._graphs.run(
                name, lambda: prog(params, self.cache, *self._views(length), extras=ex),
                params, shape=shape)
        out = []
        if pw is not None:
            out.append(self._sample(p_logits).reshape(1))
        if dw is not None:
            out.append(self._sample(d_logits))
        host = torch.cat(out + [finite.to(torch.int32).reshape(1)]).cpu().numpy()
        if not host[-1]:
            raise FloatingPointError(f"{name}: non-finite logits")
        self.dispatches += 1
        st = self.buckets.setdefault(name, {"calls": 0, "seconds": 0.0,
                                            "prefill_tokens": 0, "decode_tokens": 0})
        st["calls"] += 1
        st["seconds"] += time.perf_counter() - t0
        st["prefill_tokens"] += pw.chunk_len if pw is not None else 0
        st["decode_tokens"] += int(dw.active.sum()) if dw is not None else 0
        return StepResult(
            prefill_token=int(host[0]) if pw is not None else None,
            # inactive slots keep their token
            decode_tokens=(np.where(dw.active, host[int(pw is not None):-1], dw.toks)
                           if dw is not None else None))
