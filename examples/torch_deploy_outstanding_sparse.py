"""Outstanding-sparse deployment workflow of the PyTorch port (paper
§Outstanding-sparse; the port's counterpart of
``examples/deploy_outstanding_sparse.py``):

  1. sensitivity scan → per-layer q/gate skip list (the paper's heuristic),
  2. SmoothQuant calibration on a synthetic stream (per-channel absmax),
  3. offline Outstanding rewrite (ŝ = 1/s, α = 0.10) + int8 weights,
  4. fidelity report: bf16 dense vs W8A8 vs W8A8 + Amber 8:16.

    PYTHONPATH=src python examples/torch_deploy_outstanding_sparse.py [--device cpu]

On the GPU the scan's probes run their pruned projections on
``nm_prune_matmul`` and the rewritten projection runs on ``w8a8_matmul``;
``--device cpu`` runs the plain versions.  :func:`run` takes the weights
and the inputs.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import quant, sensitivity
from repro_torch.core.policy import DENSE, paper_policy
from repro_torch.data.pipeline import DataConfig, calibration_stream
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device


def _rewrite_rel(ql, x, dense, kernels: bool) -> float:
    """The rewritten projection's relative error against the dense product,
    on ``w8a8_matmul`` where ``kernels`` (the function ``ql`` computes)."""
    if kernels:
        from repro_torch.kernels import ops

        xq = quant.quantize_act_per_tensor(x.float() / ql.smooth, ql.act_scale)
        y = ops.w8a8_matmul(xq, ql.wq, ql.act_scale.reshape(1), ql.w_scale)
    else:
        y = ql(x)
    return float(torch.linalg.norm(y - dense) / torch.linalg.norm(dense))


def run(params=None, tokens=None, x=None, w=None, calib=None, device=None, seed: int = 0):
    """``params``: the smoke LLaMA-3.1 model's module in float32 (default:
    its seeded init); ``tokens (2, 24)`` the scan's batch; ``x (128, d)``
    and ``w (d, d_ff)`` the projection to rewrite (default: seeded, four
    outlier channels in ``x``); ``calib``: the calibration batches' tokens,
    each ``(2, 33)`` (default: the port's ``calibration_stream``).  →
    ``{"skips", "coverage", "outlier_ratio", "rel_err": {name: relative
    error}}``."""
    device = resolve_device(device)
    kernels = device.type == "cuda"
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    model = build_model(cfg, device=device)
    params = model.init(seed) if params is None else params.to(device)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)

    # --- 1. sensitivity-driven skip selection ---------------------------
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen, dtype=torch.int32)
    batch = {"tokens": torch.as_tensor(tokens).to(device)}

    @torch.no_grad()
    def forward(params, batch, policy, phase):
        return model.forward(params, batch, policy=policy.with_(use_kernels=kernels),
                             phase=phase)

    base = paper_policy(8, 16)
    sens = sensitivity.sensitivity_scan(
        forward, params, batch, ["q_proj", "gate_proj"], cfg.n_layers, base)
    dims = {
        "q_proj": (cfg.d_model, cfg.q_dim),
        "k_proj": (cfg.d_model, cfg.kv_dim),
        "v_proj": (cfg.d_model, cfg.kv_dim),
        "o_proj": (cfg.q_dim, cfg.d_model),
        "gate_proj": (cfg.d_model, cfg.d_ff),
        "up_proj": (cfg.d_model, cfg.d_ff),
        "down_proj": (cfg.d_ff, cfg.d_model),
    }
    flops = sensitivity.linear_flops(dims)
    skips = sensitivity.select_qgate_skips(sens, flops, cfg.n_layers, base)
    pol = paper_policy(8, 16, skips)
    cov = sensitivity.coverage(flops, pol, cfg.n_layers)
    print(f"selected q/gate skip layers: {skips} → coverage {cov:.1%} (target ≥55%)")

    # --- 2. SmoothQuant calibration --------------------------------------
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    taps = quant.ActCalib()
    with torch.no_grad():
        stream = (calibration_stream(data, 4, device=device) if calib is None else
                  ({"tokens": torch.as_tensor(c).to(device)} for c in calib))
        for cb in stream:
            h = model.forward(params, {"tokens": cb["tokens"][:, :-1]}, policy=DENSE,
                              phase="prefill")
            taps.observe("hidden", h.reshape(-1, h.shape[-1]))
    am_h = taps.absmax("hidden")
    ratio = float(am_h.max() / am_h.mean())
    print(f"calibrated absmax over {len(list(taps.names()))} tap(s); max outlier ratio "
        f"{ratio:.1f}x")

    # --- 3+4. Outstanding rewrite of a projection + fidelity -------------
    if x is None:
        x = torch.randn(128, cfg.d_model, generator=gen) * (
            1 + 10 * (torch.arange(cfg.d_model) < 4))     # outlier channels
    if w is None:
        w = torch.randn(cfg.d_model, cfg.d_ff, generator=gen) * cfg.d_model**-0.5
    x, w = torch.as_tensor(x).float().to(device), torch.as_tensor(w).float().to(device)
    am = torch.amax(torch.abs(x), dim=0)
    dense = x @ w
    rel_err = {}
    for name, qcfg in [
        ("SQ-W8A8 (α=0.5)", quant.QuantConfig(alpha=0.5, outstanding=False)),
        ("Outstanding (α=0.1, ŝ=1/s)", quant.QuantConfig(alpha=0.1, outstanding=True)),
    ]:
        ql = quant.make_quantized_linear(w, am, qcfg)
        rel_err[name] = _rewrite_rel(ql, x, dense, kernels)
        print(f"{name:32s} rel_err={rel_err[name]:.4f}")
    print("Outstanding expands the activation range so the N:M pattern "
        "selects outlier channels more cleanly (paper Fig. 3/4)")
    return {"skips": skips, "coverage": cov, "outlier_ratio": ratio, "rel_err": rel_err}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu (default: the GPU)")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
