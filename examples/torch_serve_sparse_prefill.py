"""End-to-end serving with the PyTorch port (the paper's deployment
scenario; the port's counterpart of ``examples/serve_sparse_prefill.py``).

    PYTHONPATH=src python examples/torch_serve_sparse_prefill.py [--device cpu]

Serves a small model with BATCHED requests: Amber-sparse prefill (8:16,
Robust-Norm scoring + layer skipping), dense decode, greedy sampling, then
reports throughput and the dense/sparse greedy agreement.  On the GPU the
pruned projections run on ``nm_prune_matmul`` and each step is a replayed
CUDA graph; ``--device cpu`` runs the plain versions.  :func:`run` takes
the weights and the prompts.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import DENSE, paper_policy
from repro_torch.core.pruner import precompute_scales
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.serve.engine import ServeConfig, ServingEngine

NEW_TOKENS = 32


def run(params=None, tokens=None, device=None, seed: int = 0):
    """``params``: the smoke Qwen2-7B model's module in float32 (default:
    its seeded init); ``tokens (8, 96)`` the prompts.  → ``{"dense",
    "amber816": (B, new) greedy tokens, "agreement", "first_token"}``."""
    device = resolve_device(device)
    cfg = dataclasses.replace(get_smoke_config("qwen2_7b"), dtype="float32")
    model = build_model(cfg, device=device)
    params = model.init(seed) if params is None else params.to(device)

    policy = paper_policy(8, 16, cfg.qgate_skip_layers, use_kernels=device.type == "cuda")
    params = precompute_scales(params, policy)   # offline, once

    scfg = ServeConfig(max_seq=160, temperature=0.0)
    engines = {"dense   ": ServingEngine(model, DENSE, scfg),
               "amber816": ServingEngine(model, policy, scfg)}

    # batched requests: 8 prompts of 96 tokens, 32 new tokens each
    if tokens is None:
        gen = torch.Generator(device="cpu").manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.vocab_size, (8, 96), generator=gen, dtype=torch.int32)
    batch = {"tokens": torch.as_tensor(tokens).to(device)}
    b, t = batch["tokens"].shape
    out = {}
    for name, engine in engines.items():
        t0 = time.perf_counter()
        got = engine.generate(params, batch, max_new_tokens=NEW_TOKENS)["tokens"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        out[name.strip()] = got.cpu()
        print(f"[{name}] prefill+decode {b}×({t}→{NEW_TOKENS}) in {dt:5.2f}s "
            f"({b * t / dt:7.0f} prefill tok/s on {device.type})  "
            f"sample: {got[0, :8].tolist()}")
    a, s = out["dense"], out["amber816"]
    out["agreement"] = float((a == s).float().mean())
    out["first_token"] = float((a[:, 0] == s[:, 0]).float().mean())
    print(f"greedy agreement (dense vs sparse prefill): {out['agreement']:.3f}  "
        f"first-token: {out['first_token']:.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu (default: the GPU)")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
