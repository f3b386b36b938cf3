"""CUDA graphs of the port's step programs, and what a replay must carry.

A replay launches a graph's kernels without calling their wrappers, so the
wrappers' launch counters would not see it.  :class:`Graph` records what
its capture added to every counter (:func:`repro_torch.kernels.counters`),
takes that back (a capture launches nothing), and adds it again at each
replay: after a graphed run the counters read what an eager run of the
same steps reads.

A graph also owns the scratch that no other launch may share: the ticket
counters of ``paged_attention``'s split walk, zeroed before the capture
(every launch leaves them 0 again).  :func:`current` is the graph being
captured on the calling thread, or ``None``; the ``paged_attention``
wrapper takes that graph's counters while it is captured.

:class:`Programs` is what the serving engines run their steps through: one
graph per named program, captured after the program's first (eager) call
and replayed from then on, with ``trace_counts`` of the captures.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch

__all__ = ["Graph", "Programs", "current", "TICKETS"]

TICKETS = 1024          # int32 ticket counters a graph owns (decode uses B * Hkv)

_local = threading.local()


def current() -> Optional["Graph"]:
    """The :class:`Graph` being captured on this thread, if any."""
    return getattr(_local, "graph", None)


class Graph:
    """One captured CUDA graph in a memory pool that several graphs may
    share (graphs of one owner never run at once), with its own ticket
    counters and the launch counts of one replay."""

    def __init__(self, device: torch.device, pool):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()
        self.tickets = torch.zeros(TICKETS, dtype=torch.int32, device=device)
        self.launches: Dict[str, int] = {}

    def capture(self, fn: Callable):
        """Capture ``fn()`` (on PyTorch's capture stream) and return what it
        returns: tensors at fixed addresses that every replay rewrites.  A
        capture that fails raises; nothing runs in its place."""
        from repro_torch import kernels

        before = kernels.counters()
        _local.graph = self
        try:
            with torch.cuda.graph(self.graph, pool=self.pool):
                out = fn()
        finally:
            _local.graph = None
            after = kernels.counters()
            kernels.set_counters(before)
        self.launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
        return out

    def replay(self) -> None:
        from repro_torch import kernels

        self.graph.replay()
        kernels.add_counters(self.launches)


class Programs:
    """Step programs by name, as CUDA graphs on ``device``.

    :meth:`run` calls a program: the first call of a name runs ``fn()``
    eagerly (the real step, which also builds the kernels) and then
    captures it; later calls replay the graph and return the tensors its
    capture returned (fixed addresses, rewritten by every replay: read them
    before the next call).  ``fn`` must read its inputs from, and keep its
    state in, tensors that outlive the graph.  The graphs share one memory
    pool, since they never run at once, and hold the ``params`` they were
    captured with: a call with another ``params`` object drops them all and
    captures again.  ``trace_counts[name]`` counts the captures.  On the
    CPU there are no graphs: ``fn()`` runs every time, and ``trace_counts``
    counts each name's first call, so a name used reads 1 on either
    device."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.trace_counts: Dict[str, int] = {}
        self._graphs: Dict[str, tuple] = {}
        self._params = None
        self._pool = None

    def run(self, name: str, fn: Callable, params):
        if self.device.type != "cuda":
            self.trace_counts.setdefault(name, 1)
            return fn()
        if params is not self._params:
            self._graphs.clear()
            self._params = params
        if name in self._graphs:
            graph, out = self._graphs[name]
            graph.replay()
            return out
        result = fn()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = Graph(self.device, self._pool)
        self._graphs[name] = (graph, graph.capture(fn))
        self.trace_counts[name] = self.trace_counts.get(name, 0) + 1
        return result
