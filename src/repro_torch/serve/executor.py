"""Device layer of the serving engine (port of ``repro/serve/executor.py``).

The :class:`Executor` owns the paged cache and one step function per
:data:`STEP_BUCKETS` row, and runs the scheduler's
:class:`~repro_torch.serve.scheduler.StepPlan`s.  A step is eager PyTorch:
the active request's prefill chunk first, then the slot-batched decode, on
the same in-place pools — the decode half reads the KV the prefill half
just wrote, as in the JAX package's fused program.  Per-bucket call counts
(``buckets[name]["calls"]``, beside the bucket's wall seconds and the
prefill/decode tokens it ran) and ``dispatches`` stand in for the JAX
package's ``trace_counts``.

There is no oracle twin and no degradation ladder: a step whose logits are
non-finite raises.  Replay chunks (re-ingesting emitted tokens after a
preemption) run with the DENSE policy, since their KV was first written by
the dense decode step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.serve import slots as slot_ops
from repro_torch.serve.paged import init_paged_cache
from repro_torch.serve.scheduler import StepPlan

__all__ = ["Executor", "StepResult", "STEP_BUCKETS"]

# (replay, has_prefill, has_decode) → step name, as in the JAX package
STEP_BUCKETS: Dict[Tuple[bool, bool, bool], str] = {
    (False, True, False): "step_prefill",
    (False, True, True): "step_prefill_decode",
    (False, False, True): "step_decode",
    (True, True, False): "step_replay",
    (True, True, True): "step_replay_decode",
}


@dataclasses.dataclass
class StepResult:
    prefill_token: Optional[int] = None          # sampled iff the plan had prefill
    decode_tokens: Optional[np.ndarray] = None   # (num_slots,) iff decode


class Executor:
    """Owns the cache and the step functions; executes plans.  Never reads
    or mutates request state."""

    def __init__(self, model, policy: SparsityPolicy, cfg):
        self.model = model
        self.policy = policy
        self.cfg = cfg
        self.device = model.device
        model.paged_kv_spec()        # raises for layouts the port has no pool for
        self.paged_kernel = bool(policy.use_kernels)
        dense = DENSE.with_(use_kernels=policy.use_kernels)
        # (prefill policy, decode policy) per bucket: replay and decode are dense
        self._policies = {key: (dense if key[0] else policy, dense)
                          for key in STEP_BUCKETS}
        self.cache = None
        self.buckets: Dict[str, Dict[str, float]] = {}
        self.dispatches = 0
        self._gen = None

    # ------------------------------------------------------------- sampling
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if self._gen is None:
            self._gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[..., 0].to(torch.int32)

    # ------------------------------------------------------------ the cache
    def init_cache(self, num_blocks: int) -> None:
        if self.cache is None:
            self.cache = init_paged_cache(self.model.cfg, self.cfg.num_slots,
                                          self.cfg.max_seq, self.cfg.block_size,
                                          num_blocks, device=self.device)

    def apply_effects(self, plan: StepPlan) -> None:
        """Slot resets decided at admission and the rewritten host block
        table, applied before the step."""
        for slot, pos in plan.resets:
            slot_ops.reset_slot(self.cache, slot, pos=pos)
        if plan.table is not None:
            self.cache["block_table"].copy_(torch.from_numpy(plan.table))

    # ----------------------------------------------------------- dispatch
    @torch.no_grad()
    def step(self, params, plan: StepPlan) -> StepResult:
        """Run one plan: prefill half, then decode half; one host sync."""
        name = STEP_BUCKETS[plan.bucket]
        pf_policy, dec_policy = self._policies[plan.bucket]
        t0 = time.perf_counter()
        pw, dw = plan.prefill, plan.decode
        dev = self.device
        out = []
        finite = torch.ones((), dtype=torch.bool, device=dev)
        if pw is not None:
            sub = slot_ops.slice_slot(self.cache, pw.req.slot)
            batch = {"tokens": torch.from_numpy(pw.tokens).to(dev),
                     "chunk_len": torch.tensor(pw.chunk_len, dtype=torch.int32,
                                               device=dev)}
            logits, sub = self.model.prefill_chunk(params, batch, sub,
                                                   policy=pf_policy)
            slot_ops.write_slot(self.cache, pw.req.slot, sub)
            finite &= torch.isfinite(logits).all()
            out.append(self._sample(logits[0]).reshape(1))
        if dw is not None:
            toks = torch.from_numpy(dw.toks).to(dev)
            active = torch.from_numpy(dw.active).to(dev)
            logits, new = self.model.decode_step(params, toks[:, None], self.cache,
                                                 policy=dec_policy)
            self.cache = slot_ops.where_active(active, new, self.cache)
            # inactive slots may hold junk logits; only active rows count
            finite &= (torch.isfinite(logits).all(dim=-1) | ~active).all()
            out.append(torch.where(active, self._sample(logits), toks))
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
            decode_tokens=host[int(pw is not None):-1] if dw is not None else None)
