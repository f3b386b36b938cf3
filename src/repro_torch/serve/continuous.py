"""Continuous-batching serving engine (port of ``repro/serve/continuous.py``):
chunked Amber-sparse prefill interleaved with slot-batched dense decode
over a paged KV cache.

Each scheduler iteration: reap cancellations and deadlines, admit waiting
requests FCFS by block budget (reusing prefix-cached blocks), grab decode
blocks (preempting the youngest request when the pool is dry), then run ONE
fused step — the oldest prefilling request's next chunk and the frozen
decode roster — through the :class:`~repro_torch.serve.executor.Executor`,
which on the GPU replays one CUDA graph per step bucket, captured at the
bucket's first step.  ``trace_counts`` (also in ``metrics``) counts those
captures per bucket, as the JAX package counts its step programs' traces:
every bucket a run used reads 1.  With greedy decoding the per-request
token streams are identical to the JAX package's engine on the same
weights.

Not ported: fault injection and the degradation ladder (a non-finite step
raises instead), snapshot/restore, the legacy two-program split, TP, and
modality extras.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.serve.executor import Executor
from repro_torch.serve.scheduler import TERMINAL, Scheduler

__all__ = ["ContinuousConfig", "ContinuousServingEngine"]


@dataclasses.dataclass(frozen=True)
class ContinuousConfig:
    max_seq: int = 512        # per-slot KV capacity (prompt + new tokens)
    num_slots: int = 4        # decode batch width
    chunk_size: int = 64      # prefill chunk (tokens per chunk)
    temperature: float = 0.0  # 0 → greedy
    eos_token: int = -1       # -1 → never stop early
    seed: int = 0             # temperature-sampling generator seed
    max_iters: int = 100_000  # scheduler-loop safety valve
    block_size: int = 16      # KV rows per block
    num_blocks: Optional[int] = None   # None → num_slots * ceil(max_seq / block_size)
    prefix_cache: bool = True
    validate_pool: bool = False        # audit pool invariants every iteration
    ttl_default: Optional[int] = None  # default per-request deadline (iterations)
    watchdog_iters: int = 64           # no-progress window before a forced reject


class ContinuousServingEngine:
    """Scheduler + Executor driver over a paged slot cache (one replica)."""

    def __init__(self, model, policy: SparsityPolicy = DENSE,
                 cfg: ContinuousConfig = ContinuousConfig()):
        self.model = model
        self.policy = policy
        self.cfg = cfg
        self._validate = (cfg.validate_pool
                          or os.environ.get("REPRO_VALIDATE_POOL") == "1")
        self.exec = Executor(model, policy, cfg)
        self.sched = Scheduler(cfg, policy_enabled=policy.enabled,
                               prefix_cache=cfg.prefix_cache)
        self.work_iterations = 0
        self.metrics: Dict[str, Any] = {}

    @property
    def requests(self):
        return self.sched.requests

    @property
    def pool(self):
        return self.sched.pool

    @property
    def trace_counts(self) -> Dict[str, int]:
        return self.exec.trace_counts

    def submit(self, tokens, max_new_tokens: int = 32, arrival: int = 0,
               ttl: Optional[int] = None) -> int:
        """Queue a request visible from scheduler iteration ``arrival``."""
        return self.sched.submit(tokens, max_new_tokens, arrival, ttl)

    def cancel(self, rid: int) -> bool:
        return self.sched.cancel(rid)

    def clear(self) -> None:
        """Drop completed requests (e.g. after a warm-up pass) so a fresh
        stream can be measured; the prefix index survives."""
        self.sched.clear()

    def _step(self, params, it: int, t0: float) -> bool:
        plan = self.sched.plan_step()
        if not plan.has_work:
            return False
        self.exec.apply_effects(plan)
        res = self.exec.step(params, plan)
        pw = plan.prefill
        if pw is not None:
            self.sched.commit_chunk(pw.req, pw.chunk_len)
            if self.sched.seq_complete(pw.req):
                self.sched.emit_prefill_token(pw.req, res.prefill_token, it, t0)
        if plan.decode is not None:
            self.sched.emit_decode_tokens(plan.decode, res.decode_tokens, it, t0)
        return True

    def run(self, params) -> Dict:
        """Drive the scheduler until every submitted request is terminal.
        Returns ``{"outputs": {rid: tokens}, "metrics": {...}}``."""
        sched, ex = self.sched, self.exec
        ex.init_cache(sched.pool.num_blocks)
        t0 = time.perf_counter()
        it0 = sched.it
        counters0 = {k: getattr(sched, k) for k in (
            "preemptions", "rejections", "prefix_hits", "blocks_reused",
            "tokens_skipped", "prefill_demand", "watchdog_trips", "timeouts",
            "cancellations")}
        disp0, work0 = ex.dispatches, self.work_iterations
        buckets0 = {k: dict(v) for k, v in ex.buckets.items()}
        sched.pool.peak_in_use = sched.pool.in_use
        evict0 = sched.pool.evictions
        while sched.live():
            it = sched.it
            if it - it0 >= self.cfg.max_iters:
                raise RuntimeError("scheduler stuck: max_iters reached")
            sched.stamp_arrivals(it, time.perf_counter())
            reaped = sched.reap(it)
            admitted = sched.admit(it)
            sched.ensure_decode_blocks()
            worked = self._step(params, it, t0)
            if worked:
                self.work_iterations += 1
            if self._validate:
                sched.audit_pool()
            sched.observe_progress(it, bool(reaped or admitted or worked))
            sched.it += 1
        wall = time.perf_counter() - t0
        gen = sum(len(r.out) for r in sched.requests)
        d = {k: getattr(sched, k) - v for k, v in counters0.items()}
        self.metrics = {
            "iterations": sched.it - it0,
            "wall_s": wall,
            "generated_tokens": gen,
            "tokens_per_s": gen / max(wall, 1e-9),
            "trace_counts": dict(ex.trace_counts),
            "buckets": {k: {f: x - buckets0.get(k, {}).get(f, 0) for f, x in v.items()}
                        for k, v in ex.buckets.items()
                        if v["calls"] > buckets0.get(k, {}).get("calls", 0)},
            "dispatches": ex.dispatches - disp0,
            "dispatches_per_iteration": ((ex.dispatches - disp0)
                                         / max(self.work_iterations - work0, 1)),
            "lifecycle": {
                "terminal_states": {s: sum(1 for r in sched.requests if r.state == s)
                                    for s in TERMINAL},
                "watchdog_trips": d["watchdog_trips"],
                "timeouts": d["timeouts"],
                "cancellations": d["cancellations"],
            },
            "paged": {
                "enabled": True,
                "block_size": sched.pool.block_size,
                "num_blocks": sched.pool.num_blocks,
                "peak_blocks_in_use": sched.pool.peak_in_use,
                "preemptions": d["preemptions"],
                "rejections": d["rejections"],
                "attention_kernel": ex.paged_kernel,
                "prefix_cache": sched.prefix_cache,
                "prefix_hits": d["prefix_hits"],
                "blocks_reused": d["blocks_reused"],
                "tokens_skipped": d["tokens_skipped"],
                "prefill_tokens": d["prefill_demand"],
                "cached_blocks": sched.pool.cached_blocks,
                "evictions": sched.pool.evictions - evict0,
            },
            "requests": [{
                "rid": r.rid, "prompt_len": int(len(r.tokens)), "arrival": r.arrival,
                "state": r.state, "admitted_iter": r.admitted_iter,
                "first_token_iter": r.first_token_iter, "done_iter": r.done_iter,
                "latency_iters": r.done_iter - r.arrival, "latency_s": r.done_time,
                "n_out": len(r.out), "preemptions": r.preempted,
                "cached_tokens": r.cached_tokens, "deadline": r.deadline,
            } for r in sched.requests],
        }
        return {"outputs": {r.rid: list(r.out) for r in sched.requests},
                "metrics": self.metrics}
