"""Device layer of the serving engine (port of ``repro/serve/executor.py``).

The :class:`Executor` owns the paged cache and one step program per
:data:`STEP_BUCKETS` row, and runs the scheduler's
:class:`~repro_torch.serve.scheduler.StepPlan`s.  A step program is the JAX
package's fused step: the active request's prefill chunk first, then the
slot-batched decode, on the same in-place pools — the decode half reads the
KV the prefill half just wrote.  Its operands are fixed-shape device
buffers, written from the host before each step in one copy: the slot (a
0-d index, :mod:`~repro_torch.serve.slots`), the chunk tokens padded to
``chunk_size``, ``chunk_len``, the decode tokens and the ``active`` mask.
It returns the logits and one all-finite flag (inactive decode rows
masked).

On the GPU each program is a CUDA graph, the counterpart of the JAX
package's jit: the first step of a bucket runs the program eagerly (the
real step; it also builds the kernels), then captures it; every later step
of the bucket copies its operands in, applies the plan's cache effects and
replays the graph.  All graphs of an executor share one memory pool (they
never run at once) and read the cache and the parameters they were
captured with: a call with another ``params`` object captures again.  A
capture that fails raises; nothing reruns eagerly.  ``trace_counts[name]``
counts the captures of each bucket (1 for every bucket a run used), as the
JAX package counts traces; on the CPU, where there are no graphs and the
program runs as it is, it counts each bucket's first use.  The launch
counters of the kernels count replays (``kernels/_capture.py``).

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
from repro_torch.kernels import _capture
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


def declared_trace_keys() -> Tuple[str, ...]:
    """Every ``trace_counts`` key an :class:`Executor` may record: the fused
    buckets (the port has no legacy two-program split and no oracle
    twins)."""
    return tuple(STEP_BUCKETS.values())


@dataclasses.dataclass
class StepResult:
    prefill_token: Optional[int] = None          # sampled iff the plan had prefill
    decode_tokens: Optional[np.ndarray] = None   # (num_slots,) iff decode


class Executor:
    """Owns the cache, the step programs and their graphs; executes plans.
    Never reads or mutates request state."""

    def __init__(self, model, policy: SparsityPolicy, cfg):
        self.model = model
        self.policy = policy
        self.cfg = cfg
        self.device = model.device
        model.paged_kv_spec()        # raises for layouts the port has no pool for
        self.paged_kernel = bool(policy.use_kernels)
        dense = DENSE.with_(use_kernels=policy.use_kernels)
        # replay and decode are dense
        self._programs: Dict[Tuple[bool, bool, bool], Callable] = {
            key: self._make_step_fn(dense if key[0] else policy, dense, key[1], key[2])
            for key in STEP_BUCKETS}
        self.cache = None
        self._operands: Optional[torch.Tensor] = None
        self._graphs = _capture.Programs(self.device)
        self.buckets: Dict[str, Dict[str, float]] = {}
        self.dispatches = 0
        self._gen = None

    # ------------------------------------------------------- step programs
    def _make_step_fn(self, pf_policy: SparsityPolicy, dec_policy: SparsityPolicy,
                      has_prefill: bool, has_decode: bool) -> Callable:
        model = self.model      # not self: the executor must not hold itself in a cycle

        def step_fn(params, cache, slot, tokens, chunk_len, toks, active):
            """One fused step on the cache, updated in place.  ``slot``: 0-d
            int; ``tokens (1, C)``; ``chunk_len``: 0-d int32; ``toks``,
            ``active``: ``(num_slots,)``.  Returns (prefill logits ``(V,)``
            or None, decode logits ``(num_slots, V)`` or None, all-finite
            0-d bool)."""
            finite = torch.ones((), dtype=torch.bool, device=cache["pos"].device)
            p_logits = d_logits = None
            if has_prefill:
                sub = slot_ops.slice_slot(cache, slot)
                p_logits, sub = model.prefill_chunk(
                    params, {"tokens": tokens, "chunk_len": chunk_len}, sub,
                    policy=pf_policy)
                slot_ops.write_slot(cache, slot, sub)
                p_logits = p_logits[0]
                finite = finite & torch.isfinite(p_logits).all()
            if has_decode:
                d_logits, new = model.decode_step(params, toks[:, None], cache,
                                                  policy=dec_policy)
                slot_ops.where_active(active, new, cache)
                # inactive slots may hold junk logits; only active rows count
                finite = finite & (torch.isfinite(d_logits).all(dim=-1) | ~active).all()
            return p_logits, d_logits, finite
        return step_fn

    @property
    def trace_counts(self) -> Dict[str, int]:
        """Captures of each bucket's graph (on the CPU: first uses)."""
        return self._graphs.trace_counts

    def step_program(self, bucket: Tuple[bool, bool, bool]) -> Callable:
        """The raw step program of a phase-presence bucket: ``prog(params,
        cache, slot, tokens, chunk_len, toks, active)``, eager on any
        device (what a bucket's graph captures)."""
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

    # ----------------------------------------------------------- the cache
    def init_cache(self, num_blocks: int) -> None:
        if self.cache is None:
            cfg = self.cfg
            self.cache = init_paged_cache(self.model.cfg, cfg.num_slots, cfg.max_seq,
                                          cfg.block_size, num_blocks, device=self.device)
            # [slot, chunk_len, chunk tokens (C), decode tokens (S), active (S)]
            self._operands = torch.zeros(2 + cfg.chunk_size + 2 * cfg.num_slots,
                                         dtype=torch.int32, device=self.device)

    def apply_effects(self, plan: StepPlan) -> None:
        """Slot resets decided at admission and the rewritten host block
        table, applied before the step."""
        for slot, pos in plan.resets:
            slot_ops.reset_slot(self.cache, slot, pos=pos)
        if plan.table is not None:
            self.cache["block_table"].copy_(torch.from_numpy(plan.table))

    def _views(self):
        """The step programs' operands: views of the operand buffer, and
        ``active`` as a mask (made inside the program, so a graph makes it
        at replay)."""
        c, s = self.cfg.chunk_size, self.cfg.num_slots
        buf = self._operands
        return (buf[0], buf[2:2 + c].reshape(1, c), buf[1], buf[2 + c:2 + c + s],
                buf[2 + c + s:] != 0)

    def _write_operands(self, plan: StepPlan) -> None:
        c, s = self.cfg.chunk_size, self.cfg.num_slots
        host = np.zeros(2 + c + 2 * s, np.int32)
        if plan.prefill is not None:
            pw = plan.prefill
            host[0], host[1] = pw.req.slot, pw.chunk_len
            host[2:2 + c] = pw.tokens.reshape(-1)
        if plan.decode is not None:
            host[2 + c:2 + c + s] = plan.decode.toks
            host[2 + c + s:] = plan.decode.active
        self._operands.copy_(torch.from_numpy(host))

    # ------------------------------------------------------------ dispatch
    @torch.no_grad()
    def step(self, params, plan: StepPlan) -> StepResult:
        """Run one plan: operands in, the bucket's program, sampling, one
        host sync."""
        name = STEP_BUCKETS[plan.bucket]
        t0 = time.perf_counter()
        pw, dw = plan.prefill, plan.decode
        self._write_operands(plan)
        prog = self._programs[plan.bucket]
        p_logits, d_logits, finite = self._graphs.run(
            name, lambda: prog(params, self.cache, *self._views()), params)
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
