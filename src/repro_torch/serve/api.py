"""Public serving facade (port of ``repro/serve/api.py``)::

    from repro_torch.serve.api import Engine, EngineConfig

    eng = Engine.from_config(model, EngineConfig(serving=...), policy=...)
    rid = eng.submit(prompt_tokens, max_new_tokens=32)
    res = eng.run(params)                # res["outputs"][rid]
    print(eng.metrics.to_json(indent=2))

One replica on one device: ``dp == tp == 1``; the router and tensor
parallelism are not ported yet and raise ``NotImplementedError``.  The
engine runs on the model's device, which is the GPU unless ``device="cpu"``
is named.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.models.model import resolve_device
from repro_torch.serve.continuous import ContinuousConfig, ContinuousServingEngine
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.metrics import MetricsSnapshot

__all__ = ["EngineConfig", "Engine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dp: int = 1
    tp: int = 1
    serving: ContinuousConfig = ContinuousConfig()


class Engine:
    def __init__(self, replica: ContinuousServingEngine, cfg: EngineConfig):
        self._replica = replica
        self.cfg = cfg

    @classmethod
    def from_config(cls, model, cfg: EngineConfig = EngineConfig(), *,
                    policy: SparsityPolicy = DENSE,
                    faults: Optional[FaultInjector] = None,
                    device=None) -> "Engine":
        """Build the serving stack for ``model`` on ``device`` (default: the
        GPU, raising if there is none); the model must live there.
        ``faults`` is consulted at the fault sites (``serve/faults.py``)."""
        if cfg.dp != 1 or cfg.tp != 1:
            raise NotImplementedError("dp/tp > 1 (router, tensor parallelism) "
                                      "is not ported yet")
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model is on {model.device}, engine asked for {dev}")
        return cls(ContinuousServingEngine(model, policy, cfg.serving, faults=faults),
                   cfg)

    def submit(self, tokens, max_new_tokens: int = 32, arrival: int = 0,
               ttl: Optional[int] = None) -> int:
        return self._replica.submit(tokens, max_new_tokens, arrival, ttl)

    def cancel(self, rid: int) -> bool:
        return self._replica.cancel(rid)

    def run(self, params, extras: Optional[Dict[int, Dict]] = None) -> Dict:
        """Serve every submitted request; ``extras`` maps request id →
        modality arrays sent with its first prefill chunk."""
        return self._replica.run(params, extras=extras)

    def clear(self) -> None:
        self._replica.clear()

    def generate(self, params, prompts: Sequence, max_new_tokens: int = 32
                 ) -> List[List[int]]:
        """Submit the whole batch at arrival 0, run to completion, return
        outputs in submission order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        res = self.run(params)
        return [res["outputs"][r] for r in rids]

    @property
    def metrics(self) -> Optional[MetricsSnapshot]:
        """The last ``run()``'s metrics (None before one)."""
        return self._replica.metrics_snapshot

    def request_state(self, rid: int) -> str:
        return self._replica.requests[rid].state

    def snapshot(self) -> Dict[str, Any]:
        return self._replica.snapshot()

    def restore(self, snap: Dict[str, Any]) -> None:
        self._replica.restore(snap)

    @property
    def replica(self) -> ContinuousServingEngine:
        return self._replica
