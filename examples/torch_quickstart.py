"""Quickstart of the PyTorch port: Amber Pruner in 60 seconds (the port's
counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Builds a small LLaMA-style model, precomputes the Robust-Norm scales
offline, and compares dense vs sparse-prefill outputs at the paper's three
N:M ratios.  Runs on the GPU (the pruned projections on ``nm_prune_matmul``)
unless ``--device cpu`` is given.  :func:`run` takes the weights and the
inputs, so a caller can hand it another package's.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import nm
from repro_torch.core.policy import DENSE, naive_policy, paper_policy
from repro_torch.core.pruner import precompute_scales, prune_input
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device

RATIOS = ((2, 4), (4, 8), (8, 16))


def run(params=None, x=None, tokens=None, device=None, seed: int = 0):
    """``params``: the smoke LLaMA-3.1 model's module in float32 (default:
    its seeded init); ``x (4, d_model)`` an activation to prune; ``tokens
    (2, 32)`` a prompt batch.  → ``{"sparsity", "n_scales", "errors":
    {(n, m): output perturbation}}``."""
    device = resolve_device(device)
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    model = build_model(cfg, device=device)
    params = model.init(seed) if params is None else params.to(device)
    print(f"model: {cfg.name}  layers={cfg.n_layers} d_model={cfg.d_model}")
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    kernels = device.type == "cuda"

    # --- 1. the core op: N:M activation pruning -------------------------
    x = torch.randn(4, cfg.d_model, generator=gen) if x is None else torch.tensor(x)
    xp = prune_input(x.to(device), None, naive_policy(2, 4))
    sparsity = float(nm.sparsity_fraction(xp))
    print(f"2:4 pruned activation sparsity: {sparsity:.2f} (expect 0.50)")

    # --- 2. offline scale precompute (the 'auxiliary weights') ----------
    policy = paper_policy(8, 16, cfg.qgate_skip_layers)
    n_before = len(list(params.buffers()))
    params_s = precompute_scales(params, policy)
    n_scales = len(list(params_s.buffers())) - n_before
    print(f"attached {n_scales} Robust-Norm scale tensors (<0.05% of size)")

    # --- 3. dense vs sparse prefill --------------------------------------
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen, dtype=torch.int32)
    batch = {"tokens": torch.as_tensor(tokens).to(device)}
    with torch.no_grad():
        dense = model.forward(params_s, batch, policy=DENSE, phase="prefill")
        errors = {}
        for n, m in RATIOS:
            pol = paper_policy(n, m, cfg.qgate_skip_layers, use_kernels=kernels)
            sparse = model.forward(params_s, batch, policy=pol, phase="prefill")
            rel = float(torch.linalg.norm(sparse - dense) / torch.linalg.norm(dense))
            errors[(n, m)] = rel
            print(f"Amber {n}:{m} prefill — output perturbation {rel:.4f}")
    print("(smaller is better; 8:16 should be the smallest — paper Table 1)")
    return {"sparsity": sparsity, "n_scales": n_scales, "errors": errors}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu (default: the GPU)")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
