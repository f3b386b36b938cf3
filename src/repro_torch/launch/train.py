"""Training CLI of the port (port of ``repro/launch/train.py``)::

    python -m repro_torch.launch.train --arch llama31_8b --smoke --steps 200 \\
        --sparsity 8:16 --sparse-train

The flags and the printed lines are the reference's (``step ... loss ...
gnorm ... dt ...ms`` every ``log_every`` steps, then ``done: first loss …
→ last …``), with ``--device`` (default ``cuda``), as the serve CLI has:
on the GPU the pruned projections of ``--sparse-train`` run the
``nm_prune_matmul`` kernel under its ``torch.autograd.Function``; with
``--device cpu`` its plain version runs.  Asked for ``cuda`` without a GPU
the CLI raises.  Training runs dense by default (the paper confines
sparsity to prefill); ``--sparse-train`` makes the ``--sparsity`` policy
active in the training forward too.  ``--smoke`` takes the reduced config.
The weights are random from seed 0; the dense, MoE and recurrent families
train (``--arch qwen3_30b_a3b``, ``mixtral_8x7b``, ``llama4_scout_17b_a16e``:
under ``--sparse-train`` the routed experts' gate and down inputs run the
``nm_prune`` kernel under its ``torch.autograd.Function``; ``rwkv6_7b``,
``recurrentgemma_2b``: the WKV and RG-LRU recurrences under autograd).  The
encoder-decoder (``whisper_medium``) raises ``KeyError`` in its forward, as
the reference's CLI does: ``lm_batch`` carries no ``frame_embeds`` (it
trains through ``make_train_step`` and its cell, ``launch/cells.py``).
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama31_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--sparsity", default=None, help="N:M, e.g. 8:16")
    ap.add_argument("--sparse-train", action="store_true")
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.policy import DENSE, paper_policy
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    kernels = model.device.type == "cuda"

    # on the card the kernels' routes (the MoE grouped product among them)
    # even where no prune is active
    policy = DENSE.with_(use_kernels=kernels)
    if args.sparsity:
        n, m = (int(x) for x in args.sparsity.split(":"))
        phases = ("train", "prefill") if args.sparse_train else ("prefill",)
        policy = paper_policy(n, m, cfg.qgate_skip_layers).with_(phases=phases,
                                                                 use_kernels=kernels)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 1))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, grad_accum=args.grad_accum,
                         resume=args.resume)
    trainer = Trainer(model, data_cfg, opt_cfg, tcfg, policy=policy)

    def log(step, metrics):
        if step % tcfg.log_every == 0:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} "
                  f"dt {metrics['step_time_s']*1e3:.1f}ms"
                  f"{'  [straggler]' if metrics['straggler'] else ''}",
                  flush=True)

    out = trainer.run(0, hooks=log)
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"done: first loss {losses[0]:.4f} → last {losses[-1]:.4f} "
              f"(resumed_from={out['resumed_from']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
