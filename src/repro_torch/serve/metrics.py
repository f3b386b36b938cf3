"""Versioned serving-metrics schema (port of ``repro/serve/metrics.py``).

:class:`MetricsSnapshot` is the typed container the engine builds at the
end of ``run()``; ``run()["metrics"]`` is its :meth:`~MetricsSnapshot.to_dict`
and ``python -m repro_torch.launch.serve --trace`` reads its attributes.
The schema is the JAX package's (``SCHEMA_VERSION`` 1, the same four
dataclasses, ``to_dict``/``to_json``/``from_dict``/``merge``) plus one field
the port reports and the JAX package does not: ``buckets``, the calls, wall
seconds and prefill/decode tokens of each step program a run used.  Apart
from ``buckets``, ``to_dict()`` emits the key set of the JAX engine's
``run()["metrics"]``.  ``degraded_iterations`` is always 0 in the port,
which raises where the JAX package degrades; it is kept so the shapes
match.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

__all__ = ["SCHEMA_VERSION", "LifecycleMetrics", "PagedMetrics",
           "RequestMetrics", "MetricsSnapshot"]

SCHEMA_VERSION = 1


@dataclasses.dataclass
class LifecycleMetrics:
    terminal_states: Dict[str, int]
    admission_retries: int = 0
    watchdog_trips: int = 0
    timeouts: int = 0
    cancellations: int = 0
    restores: int = 0
    faults_fired: int = 0


@dataclasses.dataclass
class PagedMetrics:
    enabled: bool = False
    block_size: int = 0
    num_blocks: int = 0
    peak_blocks_in_use: int = 0
    preemptions: int = 0
    rejections: int = 0
    attention_kernel: bool = False
    prefix_cache: bool = False
    prefix_hits: int = 0
    blocks_reused: int = 0
    tokens_skipped: int = 0
    prefill_tokens: int = 0
    cached_blocks: int = 0
    evictions: int = 0

    def to_dict(self) -> Dict[str, Any]:
        # legacy shape: a paging-disabled engine reported the bare
        # ``{"enabled": False}`` marker, not a zeroed record
        if not self.enabled:
            return {"enabled": False}
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    prompt_len: int
    arrival: int
    state: str
    admitted_iter: int
    first_token_iter: int
    done_iter: int
    latency_iters: int
    latency_s: float
    n_out: int
    preemptions: int
    cached_tokens: int
    retries: int
    deadline: Optional[int]


@dataclasses.dataclass
class MetricsSnapshot:
    """One engine run's metrics.  A merged snapshot (:meth:`merge`)
    additionally carries ``replicas`` (the per-replica snapshots it was
    merged from) and reports ``dispatches_per_iteration`` as the MAX across
    replicas (the acceptance gate is per replica, not amortized)."""
    iterations: int = 0
    wall_s: float = 0.0
    generated_tokens: int = 0
    tokens_per_s: float = 0.0
    trace_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per step program: calls, seconds, prefill_tokens, decode_tokens
    buckets: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    dispatches: int = 0
    dispatches_per_iteration: float = 0.0
    degraded_iterations: int = 0
    lifecycle: LifecycleMetrics = dataclasses.field(
        default_factory=lambda: LifecycleMetrics(terminal_states={}))
    paged: PagedMetrics = dataclasses.field(default_factory=PagedMetrics)
    requests: List[RequestMetrics] = dataclasses.field(default_factory=list)
    replicas: Optional[List["MetricsSnapshot"]] = None
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "schema_version": self.schema_version,
            "iterations": self.iterations,
            "wall_s": self.wall_s,
            "generated_tokens": self.generated_tokens,
            "tokens_per_s": self.tokens_per_s,
            "trace_counts": dict(self.trace_counts),
            "buckets": {k: dict(v) for k, v in self.buckets.items()},
            "dispatches": self.dispatches,
            "dispatches_per_iteration": self.dispatches_per_iteration,
            "degraded_iterations": self.degraded_iterations,
            "lifecycle": dataclasses.asdict(self.lifecycle),
            "paged": self.paged.to_dict(),
            "requests": [dataclasses.asdict(r) for r in self.requests],
        }
        if self.replicas is not None:
            d["replicas"] = [r.to_dict() for r in self.replicas]
        return d

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MetricsSnapshot":
        pg = dict(d.get("paged", {}))
        paged = (PagedMetrics(**pg) if pg.get("enabled")
                 else PagedMetrics(enabled=False))
        return cls(
            iterations=d.get("iterations", 0),
            wall_s=d.get("wall_s", 0.0),
            generated_tokens=d.get("generated_tokens", 0),
            tokens_per_s=d.get("tokens_per_s", 0.0),
            trace_counts=dict(d.get("trace_counts", {})),
            buckets={k: dict(v) for k, v in d.get("buckets", {}).items()},
            dispatches=d.get("dispatches", 0),
            dispatches_per_iteration=d.get("dispatches_per_iteration", 0.0),
            degraded_iterations=d.get("degraded_iterations", 0),
            lifecycle=LifecycleMetrics(**d.get(
                "lifecycle", {"terminal_states": {}})),
            paged=paged,
            requests=[RequestMetrics(**r) for r in d.get("requests", [])],
            replicas=([cls.from_dict(r) for r in d["replicas"]]
                      if d.get("replicas") is not None else None),
            schema_version=d.get("schema_version", SCHEMA_VERSION),
        )

    # ----------------------------------------------------------- merging
    @classmethod
    def merge(cls, parts: List["MetricsSnapshot"],
              wall_s: Optional[float] = None) -> "MetricsSnapshot":
        """Merge of per-replica snapshots (``serve.router.Router.run``):
        counters, trace counts and buckets sum, request records
        concatenate (already relabeled to global rids),
        ``dispatches_per_iteration`` is the max across replicas, and the
        parts are kept under ``replicas``."""
        assert parts, "nothing to merge"
        wall = wall_s if wall_s is not None else max(
            p.wall_s for p in parts)
        gen = sum(p.generated_tokens for p in parts)
        term: Dict[str, int] = {}
        for p in parts:
            for k, v in p.lifecycle.terminal_states.items():
                term[k] = term.get(k, 0) + v
        traces: Dict[str, int] = {}
        for p in parts:
            for k, v in p.trace_counts.items():
                traces[k] = traces.get(k, 0) + v
        buckets: Dict[str, Dict[str, float]] = {}
        for p in parts:
            for k, v in p.buckets.items():
                acc = buckets.setdefault(k, {})
                for f, x in v.items():
                    acc[f] = acc.get(f, 0) + x
        paged_parts = [p.paged for p in parts if p.paged.enabled]
        if paged_parts:
            paged = PagedMetrics(
                enabled=True,
                block_size=paged_parts[0].block_size,
                num_blocks=sum(p.num_blocks for p in paged_parts),
                peak_blocks_in_use=sum(p.peak_blocks_in_use
                                       for p in paged_parts),
                preemptions=sum(p.preemptions for p in paged_parts),
                rejections=sum(p.rejections for p in paged_parts),
                attention_kernel=paged_parts[0].attention_kernel,
                prefix_cache=paged_parts[0].prefix_cache,
                prefix_hits=sum(p.prefix_hits for p in paged_parts),
                blocks_reused=sum(p.blocks_reused for p in paged_parts),
                tokens_skipped=sum(p.tokens_skipped for p in paged_parts),
                prefill_tokens=sum(p.prefill_tokens for p in paged_parts),
                cached_blocks=sum(p.cached_blocks for p in paged_parts),
                evictions=sum(p.evictions for p in paged_parts),
            )
        else:
            paged = PagedMetrics(enabled=False)
        return cls(
            iterations=max(p.iterations for p in parts),
            wall_s=wall,
            generated_tokens=gen,
            tokens_per_s=gen / max(wall, 1e-9),
            trace_counts=traces,
            buckets=buckets,
            dispatches=sum(p.dispatches for p in parts),
            dispatches_per_iteration=max(
                p.dispatches_per_iteration for p in parts),
            degraded_iterations=sum(p.degraded_iterations for p in parts),
            lifecycle=LifecycleMetrics(
                terminal_states=term,
                admission_retries=sum(p.lifecycle.admission_retries
                                      for p in parts),
                watchdog_trips=sum(p.lifecycle.watchdog_trips
                                   for p in parts),
                timeouts=sum(p.lifecycle.timeouts for p in parts),
                cancellations=sum(p.lifecycle.cancellations for p in parts),
                restores=sum(p.lifecycle.restores for p in parts),
                faults_fired=max(p.lifecycle.faults_fired for p in parts),
            ),
            paged=paged,
            requests=[r for p in parts for r in p.requests],
            replicas=list(parts),
        )
