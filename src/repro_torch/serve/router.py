"""Data-parallel serving router (port of ``repro/serve/router.py``): ``dp``
continuous-serving replicas behind one submit/run surface.

The :class:`Router` owns ``dp`` independent
:class:`~repro_torch.serve.continuous.ContinuousServingEngine` replicas on
the model's device, each a full Scheduler + Executor pair with its own
slots, block pool or slab, prefix index and CUDA graphs
(``kernels/_capture.Programs``); they share the model's weights.  dp
replication is host-level: no replica ever reads another's activations or
cache, so the replicas run one after another on one card.

Tensor parallelism (the reference's ``mesh``): a
:class:`~repro_torch.launch.mesh.ServingMesh` gives every replica the TP
group of its shard (``distributed/tp.replica_groups``).  Each of the mesh's
``tp`` ranks is a process that runs this same router, whose host decisions
are deterministic, so every rank makes the same plans; rank ``t`` holds
shard ``t`` of every replica, and since the replicas run one after another,
one group serves them all.  Under a gloo group every step runs eagerly
(``serve/executor.py``).  At the end of :meth:`Router.run` the ranks compare
a digest of their outputs and raise if any rank's differs.

Routing is least-loaded (a replica's load is the tokens it still owes)
with prefix affinity: a prompt whose first ``block_size`` tokens match an
earlier request's lands on that request's replica while the prefix cache
is on, because the block-level prefix index is replica-local.

Token identity: greedy outputs do not depend on batch composition or
chunking, so where a request lands never changes what it generates:
``dp=N`` outputs are token-identical per request to a one-replica run.

Failover: a replica that raises :class:`~repro_torch.serve.faults.
EngineCrash` is drained.  Its terminal requests keep their outputs; every
other request moves to the least-loaded survivor, demoted to ``WAITING``
with its emitted tokens, which replay through prefill there (the
preemption recompute path), so resumed greedy outputs stay identical.  A
moved request's modality extras are sent again with its first chunk on the
survivor.  With ``dp=1`` there is no survivor and the crash propagates to
the caller (the one-engine snapshot/restore contract).
"""
from __future__ import annotations

import copy
import hashlib
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.distributed import tp as tp_mod
from repro_torch.serve.continuous import ContinuousConfig, ContinuousServingEngine
from repro_torch.serve.faults import EngineCrash, FaultInjector
from repro_torch.serve.metrics import MetricsSnapshot
from repro_torch.serve.scheduler import TERMINAL, WAITING

__all__ = ["Router", "outputs_digest"]


def outputs_digest(outputs: Dict[int, List[int]]) -> str:
    """A SHA-256 of every request's tokens, by request id."""
    return hashlib.sha256(repr(sorted((int(g), [int(t) for t in o])
                                      for g, o in outputs.items())).encode()).hexdigest()


class Router:
    """dp-replicated continuous serving behind one request surface."""

    def __init__(self, model, policy: SparsityPolicy = DENSE,
                 cfg: ContinuousConfig = ContinuousConfig(), *, dp: int = 1, mesh=None,
                 faults: Optional[FaultInjector] = None):
        assert dp >= 1, "need at least one replica"
        self.cfg = cfg
        self.dp = dp
        self.mesh = mesh
        groups = tp_mod.replica_groups(mesh, dp)
        # the injector is shared: site schedules (and their limits) apply
        # across the whole fleet, wherever the site happens to fire
        self.replicas: List[ContinuousServingEngine] = [
            ContinuousServingEngine(model, policy, cfg, faults=faults, group=groups[i])
            for i in range(dp)]
        self.alive = [True] * dp
        self.crashes = 0                  # replicas lost to EngineCrash
        self.transplants = 0              # requests re-admitted to survivors
        self._rid_map: Dict[int, Tuple[int, int]] = {}  # global rid → (replica, local rid)
        self._affinity: Dict[bytes, int] = {}           # first block → replica
        self._outputs: Dict[int, List[int]] = {}        # harvested from the dead
        self.metrics_snapshot: Optional[MetricsSnapshot] = None
        self.metrics: Dict[str, Any] = {}

    # ------------------------------------------------------------- routing
    def _load(self, i: int) -> int:
        """Outstanding KV demand of a replica (tokens it still owes)."""
        return sum(len(r.tokens) + r.max_new_tokens for r in self.replicas[i].requests
                   if r.state not in TERMINAL)

    def _route(self, tokens: np.ndarray) -> int:
        """Least-loaded admission with prefix affinity on the first block."""
        alive = [i for i in range(self.dp) if self.alive[i]]
        assert alive, "no live replicas"
        key = None
        if self.cfg.prefix_cache and len(tokens) >= self.cfg.block_size:
            key = tokens[:self.cfg.block_size].tobytes()
            hit = self._affinity.get(key)
            if hit is not None and self.alive[hit]:
                return hit
        best = min(alive, key=lambda i: (self._load(i), i))
        if key is not None:
            self._affinity[key] = best
        return best

    def submit(self, tokens, max_new_tokens: int = 32, arrival: int = 0,
               ttl: Optional[int] = None) -> int:
        """Queue a request on the best replica; returns a global request id,
        stable across failover transplants."""
        tokens = np.asarray(tokens).reshape(-1).astype(np.int32)
        rep = self._route(tokens)
        lrid = self.replicas[rep].submit(tokens, max_new_tokens, arrival, ttl)
        grid = len(self._rid_map)
        self._rid_map[grid] = (rep, lrid)
        return grid

    def cancel(self, grid: int) -> bool:
        if grid not in self._rid_map:
            return False
        rep, lrid = self._rid_map[grid]
        return self.replicas[rep].cancel(lrid)

    def request_state(self, grid: int) -> str:
        rep, lrid = self._rid_map[grid]
        return self.replicas[rep].requests[lrid].state

    # ------------------------------------------------------------ failover
    def _transplant(self, dead: int, dst: int) -> None:
        """Drain a dead replica: keep terminal outputs, re-admit everything
        else to ``dst`` demoted to ``WAITING`` with its emitted tokens."""
        src, dst_eng = self.replicas[dead], self.replicas[dst]
        for grid, (rep, lrid) in list(self._rid_map.items()):
            if rep != dead:
                continue
            req = src.requests[lrid]
            if req.state in TERMINAL:
                self._outputs[grid] = list(req.out)
                continue
            moved = copy.deepcopy(req)
            moved.rid = len(dst_eng.requests)
            moved.state = WAITING
            moved.slot = -1
            moved.blocks = []
            moved.shared = moved.registered = 0
            moved.filled = 0
            moved.kv_len = 0
            # hash_chain survives: chain hashes are content-addressed, so
            # they hold against the survivor's index too
            dst_eng.sched.requests.append(moved)
            self._rid_map[grid] = (dst, moved.rid)
            self.transplants += 1
        self.alive[dead] = False
        self.crashes += 1

    def _survivor(self, dead: int) -> Optional[int]:
        alive = [i for i in range(self.dp) if self.alive[i] and i != dead]
        if not alive:
            return None
        return min(alive, key=lambda i: (self._load(i), i))

    # ------------------------------------------------------------ main loop
    def run(self, params, extras: Optional[Dict[int, Dict]] = None) -> Dict:
        """Drive every replica to completion, one after another; a replica
        that crashes is drained to a survivor, which is then driven again.
        ``extras`` maps global request id → modality arrays, handed to each
        replica under its local ids (rebuilt after a transplant).  Returns
        ``{"outputs": {global rid: tokens}, "metrics": ...}``, the metrics
        merged over the live replicas' last runs
        (:meth:`MetricsSnapshot.merge`, request records under global ids)."""
        extras = extras or {}
        t0 = time.perf_counter()
        parts: Dict[int, MetricsSnapshot] = {}
        work = [i for i in range(self.dp) if self.alive[i]]
        while work:
            i = work.pop(0)
            if not self.alive[i]:
                continue
            eng = self.replicas[i]
            local_extras = {lrid: extras[g] for g, (rep, lrid) in self._rid_map.items()
                            if rep == i and g in extras}
            try:
                eng.run(params, extras=local_extras)
                parts[i] = eng.metrics_snapshot
            except EngineCrash:
                dst = self._survivor(i)
                if dst is None:
                    raise              # dp=1: the caller owns recovery
                self._transplant(i, dst)
                parts.pop(i, None)
                if dst not in work:
                    work.append(dst)
        wall = time.perf_counter() - t0
        # a dead replica's partial run contributes no counters: its work was
        # done again where its requests finished
        back = {(rep, lrid): g for g, (rep, lrid) in self._rid_map.items()}
        merged = []
        for i, p in sorted(parts.items()):
            p = MetricsSnapshot.from_dict(p.to_dict())    # private copy
            for r in p.requests:
                r.rid = back.get((i, r.rid), r.rid)
            merged.append(p)
        self.metrics_snapshot = MetricsSnapshot.merge(merged, wall_s=wall)
        self.metrics = self.metrics_snapshot.to_dict()
        outputs = dict(self._outputs)
        for g, (rep, lrid) in self._rid_map.items():
            if g not in outputs:
                outputs[g] = list(self.replicas[rep].requests[lrid].out)
        if self.mesh is not None:
            self._check_ranks_agree(outputs)
        return {"outputs": outputs, "metrics": self.metrics}

    def _check_ranks_agree(self, outputs: Dict[int, List[int]]) -> None:
        """Every rank of the mesh must have emitted the same tokens: compare
        a digest of the outputs across the group, and raise if one differs."""
        import torch.distributed as dist

        digest = outputs_digest(outputs)
        digests = [None] * dist.get_world_size(self.mesh.group)
        dist.all_gather_object(digests, digest, group=self.mesh.group)
        if len(set(digests)) != 1:
            raise RuntimeError(f"tensor-parallel ranks emitted different tokens: output "
                               f"digests by rank {digests}")

    # ------------------------------------------------------ crash recovery
    def snapshot(self) -> Dict[str, Any]:
        """Host-state snapshot of the whole fleet, only while every replica
        is alive (after a failover the fleet's shape changed)."""
        assert all(self.alive), "cannot snapshot a degraded fleet"
        return {
            "replicas": [e.snapshot() for e in self.replicas],
            "rid_map": dict(self._rid_map),
            "affinity": dict(self._affinity),
            "outputs": {g: list(o) for g, o in self._outputs.items()},
        }

    @property
    def last_snapshot(self) -> Optional[Dict[str, Any]]:
        """A fleet snapshot, in :meth:`snapshot`'s form, of every replica's
        last periodic one (``ContinuousConfig.snapshot_every``), to restore
        into a new fleet after an ``EngineCrash`` propagated (``dp=1``);
        None until every replica has taken one."""
        assert all(self.alive), "cannot snapshot a degraded fleet"
        snaps = [e.last_snapshot for e in self.replicas]
        if any(s is None for s in snaps):
            return None
        held = {(i, r.rid) for i, s in enumerate(snaps) for r in s["requests"]}
        return {
            "replicas": snaps,
            "rid_map": {g: at for g, at in self._rid_map.items() if at in held},
            "affinity": dict(self._affinity),
            "outputs": {g: list(o) for g, o in self._outputs.items()},
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        assert len(snap["replicas"]) == self.dp, \
            "snapshot replica count does not match this router"
        for eng, s in zip(self.replicas, snap["replicas"]):
            eng.restore(s)
        self.alive = [True] * self.dp
        self._rid_map = dict(snap["rid_map"])
        self._affinity = dict(snap["affinity"])
        self._outputs = {g: list(o) for g, o in snap["outputs"].items()}

    def clear(self) -> None:
        """Drop the completed requests of every live replica (see
        :meth:`ContinuousServingEngine.clear`) and the id map; the affinity
        table survives, as the replicas' prefix indexes do."""
        for i, e in enumerate(self.replicas):
            if self.alive[i]:
                e.clear()
        self._rid_map = {}
        self._outputs = {}
