"""Train a small LM with the PyTorch port's full substrate: AdamW + cosine
schedule, deterministic data pipeline, checkpoints + auto-resume (the
port's counterpart of ``examples/train_sparse_lm.py``).

    PYTHONPATH=src python examples/torch_train_sparse_lm.py [--steps 200] \\
        [--ckpt-dir DIR] [--device cpu]

Also demonstrates the fault-tolerance contract: the run checkpoints every
25 steps; re-running the script resumes from the newest checkpoint and
consumes the exact same data stream (stateless pipeline).  Runs on the GPU
unless ``--device cpu`` is given.  :func:`run` takes the initial weights
and, optionally, the batch of each step.
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.train import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def run(steps: int = 200, ckpt_dir: str = None, params=None, batches=None, device=None,
        seed: int = 0):
    """Train the smoke LLaMA-3.1 model (float32, 4 layers) to ``steps``,
    resuming from ``ckpt_dir``'s newest checkpoint.  ``params``: the initial
    module (default: the seeded init); ``batches(step)``: the ``(8, 65)``
    tokens of a step (default: the port's ``lm_batch``).  → the trainer's
    ``{"state", "metrics", "resumed_from"}``."""
    device = resolve_device(device)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_example_train")
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32", n_layers=4)
    model = build_model(cfg, device=device)
    if params is not None:
        model = _Given(model, params.to(device))
    print(f"training {cfg.name}: ~{cfg.n_params() / 1e6:.1f}M params")

    trainer = Trainer(
        model,
        DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8),
        OptConfig(lr=3e-3, total_steps=steps, warmup_steps=20),
        TrainerConfig(total_steps=steps, ckpt_every=25, ckpt_dir=ckpt_dir, log_every=20),
    )
    if batches is not None:
        trainer._batch = lambda step, dev: {
            "tokens": torch.as_tensor(batches(step)).to(dev)}

    def hook(step, m):
        if step % 20 == 0:
            print(f"  step {step:4d}  loss {m['loss']:.4f}  "
                f"{m['step_time_s'] * 1e3:6.1f} ms/step"
                f"{'  [straggler]' if m['straggler'] else ''}")

    out = trainer.run(seed, hooks=hook)
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"resumed_from={out['resumed_from']}  loss {losses[0]:.3f} → {losses[-1]:.3f}")
    else:
        print(f"resumed_from={out['resumed_from']}  (no step left to run)")
    print("re-run this script to see auto-resume from the latest checkpoint")
    return out


@dataclasses.dataclass(frozen=True)
class _Given:
    """The model with given initial weights: ``init`` returns them."""
    model: object
    params: object

    def __getattr__(self, name):
        return getattr(self.model, name)

    def init(self, seed: int = 0):
        return self.params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cpu (default: the GPU)")
    args = ap.parse_args(argv)
    run(args.steps, args.ckpt_dir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
