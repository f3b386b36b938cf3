"""Public serving facade (port of ``repro/serve/api.py``)::

    from repro_torch.serve.api import Engine, EngineConfig

    eng = Engine.from_config(model, EngineConfig(dp=2, serving=...), policy=...)
    rid = eng.submit(prompt_tokens, max_new_tokens=32)
    res = eng.run(params)                # res["outputs"][rid]
    print(eng.metrics.to_json(indent=2))

``EngineConfig`` holds the per-replica :class:`ContinuousConfig` and the
parallel layout.  ``dp`` replicas sit behind a
:class:`~repro_torch.serve.router.Router` at every ``dp``, as in the
reference: each an independent Scheduler + Executor with its own slots,
block pool and CUDA graphs, all on the model's device (one card), sharing
its weights.  ``tp > 1`` shards each replica's kernels over a
``torch.distributed`` group of ``tp`` ranks (``distributed/tp.py``): the
calling process is one rank, every rank builds the same engine, and
:func:`repro_torch.launch.mesh.spawn` starts them.  Outside an initialised
group of world size ``tp`` it raises ``ValueError`` up front.  Under a gloo
group (the CPU, and ranks that share one card) every step runs eagerly,
since a CUDA graph cannot hold a gloo collective.  The engine runs on the
model's device, which is the GPU unless ``device="cpu"`` is named.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.models.model import resolve_device
from repro_torch.serve.continuous import ContinuousConfig, ContinuousServingEngine
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.metrics import MetricsSnapshot
from repro_torch.serve.router import Router

__all__ = ["EngineConfig", "Engine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-wide configuration: parallel layout + per-replica knobs."""
    dp: int = 1                    # data-parallel engine replicas
    tp: int = 1                    # tensor-parallel shards per replica (ranks)
    serving: ContinuousConfig = ContinuousConfig()

    def __post_init__(self):
        assert self.dp >= 1 and self.tp >= 1, "dp/tp must be positive"


class Engine:
    """User-facing serving engine: a :class:`Router` with a typed config and
    a :class:`MetricsSnapshot`-returning metrics surface."""

    def __init__(self, router: Router, cfg: EngineConfig):
        self._router = router
        self.cfg = cfg

    @classmethod
    def from_config(cls, model, cfg: EngineConfig = EngineConfig(), *,
                    policy: SparsityPolicy = DENSE,
                    faults: Optional[FaultInjector] = None,
                    device=None, mesh=None) -> "Engine":
        """Build ``cfg.dp`` replicas for ``model`` on ``device`` (default: the
        GPU, raising if there is none); the model must live there.
        ``faults`` is consulted at the fault sites (``serve/faults.py``),
        one injector for the whole fleet.  ``mesh`` overrides the one that
        ``tp > 1`` builds from the initialised group
        (``launch.mesh.make_serving_mesh``, which raises ``ValueError`` when
        there is none or its world size is not ``tp``)."""
        if mesh is None and cfg.tp > 1:
            from repro_torch.launch.mesh import make_serving_mesh

            mesh = make_serving_mesh(cfg.dp, cfg.tp)
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model is on {model.device}, engine asked for {dev}")
        return cls(Router(model, policy, cfg.serving, dp=cfg.dp, mesh=mesh, faults=faults),
                   cfg)

    # ------------------------------------------------------------ requests
    def submit(self, tokens, max_new_tokens: int = 32, arrival: int = 0,
               ttl: Optional[int] = None) -> int:
        return self._router.submit(tokens, max_new_tokens, arrival, ttl)

    def cancel(self, rid: int) -> bool:
        return self._router.cancel(rid)

    def run(self, params, extras: Optional[Dict[int, Dict]] = None) -> Dict:
        """Serve every submitted request; ``extras`` maps request id →
        modality arrays sent with its first prefill chunk."""
        return self._router.run(params, extras=extras)

    def generate(self, params, prompts: Sequence, max_new_tokens: int = 32
                 ) -> List[List[int]]:
        """Submit the whole batch at arrival 0, run to completion, return
        outputs in submission order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        res = self.run(params)
        return [res["outputs"][r] for r in rids]

    # ------------------------------------------------------------- observe
    @property
    def metrics(self) -> Optional[MetricsSnapshot]:
        """Merged fleet metrics of the last ``run()`` (None before one);
        the replicas' own under ``replicas``."""
        return self._router.metrics_snapshot

    def request_state(self, rid: int) -> str:
        return self._router.request_state(rid)

    @property
    def replicas(self) -> Tuple[ContinuousServingEngine, ...]:
        """The per-replica engines (read-only introspection)."""
        return tuple(self._router.replicas)

    @property
    def replica(self) -> ContinuousServingEngine:
        """The one replica of a ``dp == 1`` engine (``replicas`` at any dp)."""
        if self.cfg.dp != 1:
            raise ValueError(f"dp={self.cfg.dp}: Engine.replicas holds the replicas")
        return self._router.replicas[0]

    # ---------------------------------------------------- state management
    def snapshot(self) -> Dict[str, Any]:
        return self._router.snapshot()

    @property
    def last_snapshot(self) -> Optional[Dict[str, Any]]:
        """The fleet's last periodic snapshot (``snapshot_every``), for
        :meth:`restore` into a new engine after an ``EngineCrash``."""
        return self._router.last_snapshot

    def restore(self, snap: Dict[str, Any]) -> None:
        self._router.restore(snap)

    def clear(self) -> None:
        self._router.clear()
