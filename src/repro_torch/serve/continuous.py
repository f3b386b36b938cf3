"""Continuous-batching serving engine (port of ``repro/serve/continuous.py``):
chunked Amber-sparse prefill interleaved with slot-batched dense decode
over a paged KV cache, or over the dense per-slot slab where the model's
attention keeps sliding-window rings or ``ContinuousConfig.paged`` is
False (no block pool, no preemption, no prefix cache; ``metrics["paged"]``
reads ``{"enabled": False}``).

Each scheduler iteration: reap cancellations and deadlines, admit waiting
requests FCFS (paged: by block budget, reusing prefix-cached blocks), grab
decode blocks (preempting the youngest request when the pool is dry), then
run ONE
fused step — the oldest prefilling request's next chunk and the frozen
decode roster — through the :class:`~repro_torch.serve.executor.Executor`,
which on the GPU replays one CUDA graph per step bucket, captured at the
bucket's first step.  ``trace_counts`` (also in ``metrics``) counts those
captures per bucket, as the JAX package counts its step programs' traces:
every bucket a run used reads 1.  ``ContinuousConfig.fused_step=False``
runs the legacy two-program split instead: a prefill program, then the
decode roster recomputed after it, each its own graph (``prefill``,
``prefill_replay``, ``decode``).  With greedy decoding the per-request
token streams are identical to the JAX package's engine on the same
weights, on either path.

Lifecycle hardening, as in the JAX package: a
:class:`~repro_torch.serve.faults.FaultInjector` (``faults=``) is consulted
at the engine's ``prefill``/``decode`` sites and the scheduler's ``admit``
site, and is activated globally for the duration of :meth:`run` so the
``pool.alloc`` and ``kernel.*`` sites see it; transient admission failures
retry with backoff; :meth:`ContinuousServingEngine.snapshot` and
:meth:`ContinuousServingEngine.restore` (``snapshot_every`` keeps
``last_snapshot`` fresh) rebuild a crashed engine's stream in a new engine,
which allocates its own pool and captures its own graphs; ``iteration_hook``
is called at the top of every iteration.  Where the JAX package degrades
to its oracle programs, the port raises: a ``"nonfinite"`` fault reaches
the step as its fault operand (on the GPU also in a replayed graph) and
the step raises ``FloatingPointError``; a ``kernel.*`` fault raises
:class:`~repro_torch.serve.faults.KernelFault`.  Kernel sites are consulted
where a kernel wrapper is called from Python: every step on the CPU; on the
GPU a bucket's eager first step and its capture, never a replay — the
port's counterpart of the JAX package consulting them while it traces.

Modality extras (:meth:`ContinuousServingEngine.run`'s ``extras``: request
id → ``{name: array}``, ``frame_embeds`` for the encoder-decoder,
``pixel_embeds`` for the VLM) go with a request's first prefill chunk,
again on a preempted or restored request's replay; such requests keep out
of the prefix cache.

Not ported: TP.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.serve import faults as fault_mod
from repro_torch.serve.executor import Executor
from repro_torch.serve.faults import EngineCrash, FaultInjector
from repro_torch.serve.metrics import (LifecycleMetrics, MetricsSnapshot,
                                       PagedMetrics, RequestMetrics)
from repro_torch.serve.scheduler import PREFILL, TERMINAL, Scheduler

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
    fused_step: bool = True   # False → the legacy two-program split
    paged: bool = True        # False → the dense per-slot slab (also where
    #                           the model pools nothing: sliding windows)
    block_size: int = 16      # KV rows per block
    num_blocks: Optional[int] = None   # None → num_slots * ceil(max_seq / block_size)
    prefix_cache: bool = True
    validate_pool: bool = False        # audit pool invariants every iteration
    ttl_default: Optional[int] = None  # default per-request deadline (iterations)
    admission_retries: int = 8         # transient admission failures per request
    retry_backoff: int = 2             # retry no earlier than it + min(backoff**k, 64)
    watchdog_iters: int = 64           # no-progress window before a forced reject
    snapshot_every: int = 0            # >0: refresh last_snapshot every k iterations


class ContinuousServingEngine:
    """Scheduler + Executor driver over a paged slot cache (one replica)."""

    def __init__(self, model, policy: SparsityPolicy = DENSE,
                 cfg: ContinuousConfig = ContinuousConfig(),
                 faults: Optional[FaultInjector] = None, group=None):
        self.model = model
        self.policy = policy
        self.cfg = cfg
        self.faults = faults
        # called at the top of every iteration as hook(engine, it): an
        # external control plane (cancel(), monitoring, load shedding)
        self.iteration_hook: Optional[Callable] = None
        self._validate = (cfg.validate_pool
                          or os.environ.get("REPRO_VALIDATE_POOL") == "1")
        # group: this replica's tensor-parallel group (distributed/tp.py)
        self.exec = Executor(model, policy, cfg, group=group)
        self.sched = Scheduler(cfg, policy_enabled=policy.enabled,
                               prefix_cache=cfg.prefix_cache, paged=self.exec.paged,
                               exact_chunks=self.exec.exact_chunks, faults=faults)
        self.work_iterations = 0  # iterations that dispatched any program
        self.restores = 0         # times restore() rebuilt this engine
        self.metrics: Dict[str, Any] = {}
        self.metrics_snapshot: Optional[MetricsSnapshot] = None
        self.last_snapshot: Optional[Dict[str, Any]] = None

    @property
    def requests(self):
        return self.sched.requests

    @property
    def pool(self):
        return self.sched.pool

    @property
    def paged(self) -> bool:
        return self.exec.paged

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
        stream can be measured; the prefix index survives, and sampling
        restarts from the seed."""
        self.sched.clear()
        self.exec.set_sampler_state(None)

    # ------------------------------------------------------------- phases
    def _crash_fire(self, site: str, it: int) -> float:
        """Consult a fault site; raise on "crash", return the fault operand
        ("nonfinite" → NaN, clean → 0)."""
        kind = self.sched._fire(site)
        if kind == "crash":
            raise EngineCrash(f"injected crash in {site} (it={it})")
        return float("nan") if kind == "nonfinite" else 0.0

    def _step_fused(self, params, extras: Dict[int, Dict], it: int, t0: float) -> bool:
        """One-dispatch iteration: the scheduler's fused plan through its
        bucket's program.  Returns whether any model work ran.  A request
        whose final chunk lands this iteration decodes from the next one
        (the decode roster is frozen before dispatch)."""
        plan = self.sched.plan_step()
        if not plan.has_work:
            return False
        self.exec.apply_effects(plan)
        # both phase sites fire; either hit goes into the step's one fault
        # operand, the blast radius of one program
        fault = 0.0
        if plan.prefill is not None:
            fault += self._crash_fire("prefill", it)
        if plan.decode is not None:
            fault += self._crash_fire("decode", it)
        pw = plan.prefill
        ex = extras.get(pw.req.rid, {}) if pw is not None and pw.first else {}
        res = self.exec.step(params, plan, fault, ex)
        if pw is not None:
            self.sched.commit_chunk(pw.req, pw.chunk_len)
            if self.sched.seq_complete(pw.req):
                self.sched.emit_prefill_token(pw.req, res.prefill_token, it, t0)
        if plan.decode is not None:
            self.sched.emit_decode_tokens(plan.decode, res.decode_tokens, it, t0)
        return True

    def _step_prefill(self, params, extras: Dict[int, Dict], it: int, t0: float) -> bool:
        """Legacy two-program split, phase 1: one chunk for the oldest
        prefilling request.  Returns whether the PREFILL roster was
        non-empty (a fully-ingested request parked in PREFILL counts as
        work though nothing runs, as in the JAX package)."""
        if not any(r.state == PREFILL for r in self.sched.requests):
            return False
        plan = self.sched.plan_prefill()
        pw = plan.prefill
        if pw is None:     # fully ingested, parked — nothing to run
            return True
        self.exec.apply_effects(plan)
        ex = extras.get(pw.req.rid, {}) if pw.first else {}
        tok = self.exec.prefill(params, plan, self._crash_fire("prefill", it), ex)
        self.sched.commit_chunk(pw.req, pw.chunk_len)
        if self.sched.seq_complete(pw.req):
            self.sched.emit_prefill_token(pw.req, tok, it, t0)
        return True

    def _step_decode(self, params, it: int, t0: float) -> bool:
        """Legacy two-program split, phase 2: one slot-batched decode step
        (roster computed AFTER prefill, so a request finishing prefill
        this iteration decodes the same iteration)."""
        plan = self.sched.plan_decode()
        if plan.decode is None:
            return False
        self.exec.apply_effects(plan)
        nxt = self.exec.decode(params, plan, self._crash_fire("decode", it))
        self.sched.emit_decode_tokens(plan.decode, nxt, it, t0)
        return True

    # ------------------------------------------------------------ main loop
    def run(self, params, extras: Optional[Dict[int, Dict]] = None) -> Dict:
        """Drive the scheduler until every submitted request is terminal.
        ``extras`` maps request id → modality arrays (``{"frame_embeds":
        (1, encoder_seq, d_model)}`` or ``{"pixel_embeds": (1, n_patches,
        d_model)}``, numpy or tensors) sent with the request's first prefill
        chunk.  Returns ``{"outputs": {rid: tokens}, "metrics": ...}``, the
        metrics as :meth:`MetricsSnapshot.to_dict` (the snapshot itself is
        ``metrics_snapshot``)."""
        extras = extras or {}
        sched, ex = self.sched, self.exec
        ex.init_cache(sched.pool.num_blocks if self.paged else None)
        sched.mark_extras(extras)
        t0 = time.perf_counter()
        it0 = sched.it
        counters0 = {k: getattr(sched, k) for k in (
            "preemptions", "rejections", "prefix_hits", "blocks_reused",
            "tokens_skipped", "prefill_demand", "admission_retries",
            "watchdog_trips", "timeouts", "cancellations")}
        disp0, work0 = ex.dispatches, self.work_iterations
        buckets0 = {k: dict(v) for k, v in ex.buckets.items()}
        if self.paged:
            sched.pool.peak_in_use = sched.pool.in_use   # per-run peak
            evict0 = sched.pool.evictions
        # the pool and kernel sites cannot see this engine: the injector is
        # active globally for the duration of the loop
        fault_mod.activate(self.faults)
        try:
            while sched.live():
                it = sched.it
                if it - it0 >= self.cfg.max_iters:
                    raise RuntimeError("scheduler stuck: max_iters reached")
                if self.faults is not None:
                    self.faults.tick(it)
                if self.iteration_hook is not None:
                    self.iteration_hook(self, it)
                if self.cfg.snapshot_every and it % self.cfg.snapshot_every == 0:
                    # iteration boundary = consistent state: a crash later
                    # this iteration resumes here through restore()
                    self.last_snapshot = self.snapshot()
                sched.stamp_arrivals(it, time.perf_counter())
                reaped = sched.reap(it)
                admitted = sched.admit(it)
                if self.cfg.fused_step:
                    # block grab BEFORE the dispatch: the fused program reads
                    # the final roster and table
                    sched.ensure_decode_blocks()
                    worked = self._step_fused(params, extras, it, t0)
                else:
                    worked = self._step_prefill(params, extras, it, t0)
                    sched.ensure_decode_blocks()
                    worked = self._step_decode(params, it, t0) or worked
                if worked:
                    self.work_iterations += 1
                if self.paged and self._validate:
                    sched.audit_pool()
                sched.observe_progress(it, bool(reaped or admitted or worked))
                sched.it += 1
        finally:
            fault_mod.deactivate()
        wall = time.perf_counter() - t0
        gen = sum(len(r.out) for r in sched.requests)
        d = {k: getattr(sched, k) - v for k, v in counters0.items()}
        snap = MetricsSnapshot(
            iterations=sched.it - it0,
            wall_s=wall,
            generated_tokens=gen,
            tokens_per_s=gen / max(wall, 1e-9),
            trace_counts=dict(ex.trace_counts),
            buckets={k: {f: x - buckets0.get(k, {}).get(f, 0) for f, x in v.items()}
                     for k, v in ex.buckets.items()
                     if v["calls"] > buckets0.get(k, {}).get("calls", 0)},
            # programs run per iteration that ran model work: 1.0 on the
            # fused path, above 1 on the legacy split when phases overlap
            dispatches=ex.dispatches - disp0,
            dispatches_per_iteration=((ex.dispatches - disp0)
                                      / max(self.work_iterations - work0, 1)),
            lifecycle=LifecycleMetrics(
                terminal_states={s: sum(1 for r in sched.requests if r.state == s)
                                 for s in TERMINAL},
                admission_retries=d["admission_retries"],
                watchdog_trips=d["watchdog_trips"],
                timeouts=d["timeouts"],
                cancellations=d["cancellations"],
                restores=self.restores,
                faults_fired=self.faults.total_fired if self.faults is not None else 0,
            ),
            paged=(PagedMetrics(
                enabled=True,
                block_size=sched.pool.block_size,
                num_blocks=sched.pool.num_blocks,
                peak_blocks_in_use=sched.pool.peak_in_use,
                preemptions=d["preemptions"],
                rejections=d["rejections"],
                attention_kernel=ex.paged_kernel,
                prefix_cache=sched.prefix_cache,
                prefix_hits=d["prefix_hits"],
                blocks_reused=d["blocks_reused"],
                tokens_skipped=d["tokens_skipped"],
                prefill_tokens=d["prefill_demand"],
                cached_blocks=sched.pool.cached_blocks,
                evictions=sched.pool.evictions - evict0,
            ) if self.paged else PagedMetrics(enabled=False)),
            requests=[RequestMetrics(
                rid=r.rid, prompt_len=int(len(r.tokens)), arrival=r.arrival,
                state=r.state, admitted_iter=r.admitted_iter,
                first_token_iter=r.first_token_iter, done_iter=r.done_iter,
                latency_iters=r.done_iter - r.arrival, latency_s=r.done_time,
                n_out=len(r.out), preemptions=r.preempted,
                cached_tokens=r.cached_tokens, retries=r.retries,
                deadline=r.deadline,
            ) for r in sched.requests],
        )
        self.metrics_snapshot = snap
        self.metrics = snap.to_dict()
        return {"outputs": {r.rid: list(r.out) for r in sched.requests},
                "metrics": self.metrics}

    # ------------------------------------------------------ crash recovery
    def snapshot(self) -> Dict[str, Any]:
        """Copy of all host-side engine state at an iteration boundary:
        request lifecycles (emitted tokens and memoized hash chains
        included), slot assignment, the block pool, the iteration clock,
        the counters and the sampling generator's state (where the JAX
        package keeps its PRNG key).  Process-local: chain hashes use
        Python's per-process salted ``hash()``."""
        snap = self.sched.host_snapshot()
        snap["key"] = self.exec.sampler_state()
        snap["counters"]["restores"] = self.restores
        return snap

    def restore(self, snap: Dict[str, Any]) -> None:
        """Rebuild host-side state from a :meth:`snapshot` taken in this
        process, as a rule by another, crashed engine over the same model
        and config; build the new engine after dropping the crashed one,
        whose pool and graphs are then freed.  The KV the snapshot's blocks
        pointed at is treated as lost: in-flight requests go back to
        ``WAITING`` with a fresh block pool and an empty prefix index, and
        replay through prefill on re-admission — the recompute path
        preemption uses — so greedy outputs resume token-identically.
        Whatever this engine's own cache holds is never read again: every
        block is allocated afresh and written before it is read."""
        counters = dict(snap["counters"])
        self.restores = counters.pop("restores") + 1
        self.sched.host_restore({**snap, "counters": counters})
        self.exec.set_sampler_state(snap["key"])
