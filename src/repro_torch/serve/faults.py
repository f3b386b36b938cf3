"""Deterministic fault injection for the continuous serving engine (port
of ``repro/serve/faults.py``).

A :class:`FaultInjector` is a seeded, replayable source of simulated
failures that the serving stack consults at named sites, the JAX
package's :data:`SITES`, with the same :class:`FaultSpec` fields and the
same per-spec generators, so one ``(seed, schedule)`` fires the same
sequence against the same sequence of consults.  What a fault does differs
in one rule: **the port raises wherever the JAX package degrades** (it has
no oracle programs and no silent fallback branch).

  ==========================  ==================================================
  site                        consulted at / kinds
  ==========================  ==================================================
  ``pool.alloc``              :meth:`repro_torch.serve.paged.BlockPool.alloc`
                              — ``"exhausted"`` raises the pool's own
                              exhaustion ``RuntimeError`` (admission retries
                              with backoff, decode growth preempts);
                              ``"evict_storm"`` flushes the zero-ref prefix
                              LRU before allocating.
  ``admit``                   the scheduler's admission — ``"transient"``:
                              the request retries with bounded exponential
                              backoff before its ``REJECTED`` backstop.
  ``prefill`` / ``decode``    the engine, before it runs a step that holds
                              that phase — ``"nonfinite"`` writes NaN into the
                              step's fault operand, a device buffer the step
                              program adds to its logits (so a replayed CUDA
                              graph sees it too), and the executor's
                              finiteness check raises ``FloatingPointError``;
                              ``"crash"`` raises :class:`EngineCrash`
                              (recovered through ``snapshot()``/``restore()``
                              into a new engine).
  ``kernel.projection``       ``repro_torch.core.pruner.sparse_matmul`` under
                              ``use_kernels`` — ``"compile_error"`` and
                              ``"fallback"`` both raise :class:`KernelFault`.
  ``kernel.paged_attention``  ``repro_torch.models.attention.paged_attention``
                              under ``use_kernel`` — as above.
  ``kernel.paged_scatter``    ``repro_torch.models.attention.paged_kv_update``
                              under ``use_kernel`` — as above.
  ==========================  ==================================================

The kernel sites are consulted where a kernel wrapper is called from
Python: on the CPU at every step, on the GPU at a bucket's eager first
step and at its capture, never at a replay (a graph launches its kernels
without Python).  That is the port's counterpart of the JAX package
consulting them while it traces.

Determinism and replay: a schedule is a list of :class:`FaultSpec`
entries, each firing at explicit engine ``iters``, at the n-th ``calls`` of
its site, or with probability ``p`` from a per-spec ``numpy`` generator
derived from the injector seed.  The ``fired`` log (and
:meth:`FaultInjector.to_json`) records what fired where, so a failing
schedule replays with :meth:`FaultInjector.from_json`.

The kernel sites consult the hook in ``repro_torch/kernels/_faults.py``
(:func:`activate`, :func:`fire`, :func:`kernel_site`, :class:`KernelFault`),
which this module re-exports, so the model and core layers import nothing
of the serving layer.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels._faults import (KernelFault, activate, active, deactivate, fire,
                                         kernel_site)

__all__ = ["FaultSpec", "FaultInjector", "KernelFault", "EngineCrash",
           "SITES", "activate", "deactivate", "active", "fire", "kernel_site"]

SITES: Tuple[str, ...] = (
    "pool.alloc",
    "admit",
    "prefill",
    "decode",
    "kernel.projection",
    "kernel.paged_attention",
    "kernel.paged_scatter",
)


class EngineCrash(RuntimeError):
    """Simulated hard mid-iteration crash of the serving engine."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  Exactly one trigger should be set:

    * ``iters`` — fire on every consult of ``site`` during those engine
      iterations (an iteration-long storm at a multi-consult site);
    * ``calls`` — fire on the n-th consult of ``site`` (0-based, counted
      over the injector's lifetime);
    * ``p``     — fire each consult with probability ``p`` (deterministic
      given the injector seed and consult order).

    ``limit`` caps total fires of this spec (``None`` = unbounded)."""
    site: str
    kind: str
    iters: Optional[Sequence[int]] = None
    calls: Optional[Sequence[int]] = None
    p: float = 0.0
    limit: Optional[int] = None

    def __post_init__(self):
        assert self.site in SITES, f"unknown fault site {self.site!r}"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: (list(v) if isinstance(v, (tuple, list)) else v)
                for k, v in d.items() if v not in (None, 0.0)}


class FaultInjector:
    """Seeded, schedule-driven fault source (see module docstring).

    The engine calls :meth:`tick` at the top of every scheduler iteration
    and each instrumented site calls :meth:`fire`; the first matching
    spec wins and its ``kind`` is returned (``None`` = no fault)."""

    def __init__(self, seed: int = 0,
                 schedule: Sequence[Any] = ()):
        self.seed = int(seed)
        self.schedule: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s)
            for s in schedule]
        # independent per-spec generators: adding a spec never perturbs
        # the draws of the others (schedules compose reproducibly)
        self._rng = [np.random.default_rng(self.seed * 1_000_003 + i)
                     for i in range(len(self.schedule))]
        self.it = -1                      # last ticked engine iteration
        self._site_calls: Counter = Counter()
        self._spec_fires: Counter = Counter()
        self.fired: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- driving
    def tick(self, it: int) -> None:
        """Advance to engine iteration ``it`` (engine calls this once per
        scheduler iteration, before any site is consulted)."""
        self.it = it

    def fire(self, site: str) -> Optional[str]:
        """Consult ``site``: returns the fault kind to inject, or None."""
        n = self._site_calls[site]
        self._site_calls[site] = n + 1
        for idx, spec in enumerate(self.schedule):
            if spec.site != site:
                continue
            if spec.limit is not None and self._spec_fires[idx] >= spec.limit:
                continue
            if spec.iters is not None:
                hit = self.it in spec.iters
            elif spec.calls is not None:
                hit = n in spec.calls
            else:
                hit = spec.p > 0.0 and self._rng[idx].random() < spec.p
            if hit:
                self._spec_fires[idx] += 1
                self.fired.append({"it": self.it, "site": site,
                                   "kind": spec.kind, "call": n})
                return spec.kind
        return None

    @property
    def total_fired(self) -> int:
        return len(self.fired)

    def fired_kinds(self, site: Optional[str] = None) -> List[str]:
        return [f["kind"] for f in self.fired
                if site is None or f["site"] == site]

    # -------------------------------------------------------------- replay
    def to_json(self) -> str:
        """Serialize ``(seed, schedule)`` + the fired log — enough to
        replay the scenario locally (CI uploads this on chaos failures)."""
        return json.dumps({
            "seed": self.seed,
            "schedule": [s.to_dict() for s in self.schedule],
            "fired": self.fired,
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultInjector":
        d = json.loads(text)
        return cls(seed=d.get("seed", 0), schedule=d.get("schedule", ()))
