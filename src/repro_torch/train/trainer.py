"""The training loop with checkpoints, auto-resume and the straggler
watermark (port of ``repro/train/trainer.py``).

The restart contract, as in the reference:

* checkpoints are atomic (``repro_torch.checkpoint``);
* a batch is a pure function of the step (``data.pipeline.lm_batch``), so
  a resumed run consumes the same batches;
* ``resume="auto"`` picks up the newest checkpoint after any crash;
* each step's wall time, taken around a device synchronise, feeds a
  running median; a step slower than ``straggler_factor`` times the median
  of the last 50 (after 5 steps) is flagged in its metrics.

Under a bound ``distributed.sharding.mesh_scope`` with DP ranks, every
rank runs :meth:`Trainer.run`: it takes its DP slice of each batch, holds
the whole parameters and its ZeRO-1 slice of the moments
(``train/optimizer.py``), saves whole tensors (rank 0 writes) and restores
its slices, so a run resumes at another DP degree.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.distributed import sharding
from repro_torch.train.optimizer import OptConfig, _zero_mesh, adamw_init, moment_spec
from repro_torch.train.train_step import make_train_step, make_trainable, trainable_params

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    grad_accum: int = 1
    straggler_factor: float = 2.0
    resume: str = "auto"            # auto | none


class Trainer:
    """``Trainer(model, data_cfg, opt_cfg, cfg, policy).run(seed)``: the
    state is ``{"params": {name: tensor}, "opt": {"mu", "nu", "step"}}``
    over the model's trainable parameters, which the module returned by
    :meth:`init_state` holds."""

    def __init__(self, model, data_cfg: DataConfig, opt_cfg: OptConfig, cfg: TrainerConfig,
                 policy: SparsityPolicy = DENSE):
        self.model = model
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.policy = policy
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.step_fn = make_train_step(model, opt_cfg, policy, grad_accum=cfg.grad_accum)
        self.module = None
        self._times: List[float] = []

    def init_state(self, seed: int) -> Dict[str, Any]:
        """Seeded random weights made trainable, and a fresh AdamW state."""
        self.module = make_trainable(self.model.init(seed))
        params = trainable_params(self.module)
        return {"params": params, "opt": adamw_init(params)}

    @staticmethod
    def shardings(state: Dict) -> Optional[Dict]:
        """The state's shardings under a bound mesh (the moments' ZeRO-1
        slices; parameters whole), None off a mesh."""
        mesh = _zero_mesh()
        if mesh is None:
            return None
        mom = {k: sharding.NamedSharding(mesh, moment_spec(p, mesh))
               for k, p in state["params"].items()}
        return {"opt": {"mu": mom, "nu": dict(mom)}}

    def _restore(self, step: int, state: Dict) -> Dict:
        """Load checkpoint ``step`` into ``state``: the parameters in place
        in the module, the optimizer state as loaded."""
        loaded = self.ckpt.restore(step, state, self.shardings(state))
        with torch.no_grad():
            for k, p in state["params"].items():
                p.copy_(loaded["params"][k])
        return {"params": state["params"], "opt": loaded["opt"]}

    def run(self, seed: int, hooks: Optional[Callable[[int, Dict], None]] = None,
            crash_at: Optional[int] = None) -> Dict[str, Any]:
        """Train from the newest checkpoint (``resume="auto"``) or from
        ``seed``'s weights to ``total_steps``; ``crash_at`` raises at that
        step (a simulated failure).  → ``{"state", "metrics",
        "resumed_from"}``."""
        state = self.init_state(seed)
        start = 0
        if self.cfg.resume == "auto":
            latest = self.ckpt.latest()
            if latest is not None:
                state = self._restore(latest, state)
                start = latest
        dev = self.model.device
        metrics_hist = []
        for step in range(start, self.cfg.total_steps):
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = self._batch(step, dev)
            t0 = time.perf_counter()
            _, opt, metrics = self.step_fn(self.module, state["opt"], batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            state = {"params": state["params"], "opt": opt}

            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_time_s"] = dt
            metrics["straggler"] = self._straggler(dt)
            metrics_hist.append(metrics)
            if hooks:
                hooks(step, metrics)
            if (step + 1) % self.cfg.ckpt_every == 0 or step + 1 == self.cfg.total_steps:
                self.ckpt.save(step + 1, state, self.shardings(state))
        return {"state": state, "metrics": metrics_hist, "resumed_from": start}

    def _batch(self, step: int, dev) -> Dict[str, torch.Tensor]:
        """The step's batch; under a mesh this rank's DP slice of it."""
        batch = lm_batch(self.data_cfg, step, device=dev)
        mesh = _zero_mesh()
        if mesh is None:
            return batch
        spec = sharding.batch_spec(mesh)
        n = sharding._pieces(spec[0], mesh)
        if batch["tokens"].shape[0] % n:
            raise ValueError(f"batch {batch['tokens'].shape[0]} does not divide over {n} "
                             "DP ranks")
        return {k: sharding.local(v, spec, mesh) for k, v in batch.items()}

    def _straggler(self, dt: float) -> bool:
        self._times.append(dt)
        if len(self._times) < 5:
            return False
        med = statistics.median(self._times[-50:])
        return dt > self.cfg.straggler_factor * med
