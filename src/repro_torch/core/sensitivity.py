"""Layer-skipping sensitivity analysis (port of ``repro/core/sensitivity.py``;
paper §Layer Skipping Strategy).

For a projection p at layer l, the sensitivity is the relative perturbation
of the *final model output* when only that projection's input is N:M-pruned:

    e_p(Y, Y') = ‖Y − Y'‖₂ / (‖Y‖₂ + ε)                     (paper Eq. 8)

The scan drives the paper's heuristic skip selection:
  * k_proj / v_proj     → non-prunable (GQA ⇒ tiny FLOP share, App. D);
  * o_proj / up_proj    → preserved (highest average sensitivity);
  * down_proj           → pruned everywhere (lowest sensitivity);
  * q_proj / gate_proj  → pruned except in the top-sensitivity layers,
                          subject to keeping coverage ≥ the target (55%).

Every function keeps the reference's name, signature and semantics.  The
port runs its layers as a Python loop with a static index, so a probe's
policy reaches exactly one projection call; under ``use_kernels`` that call
is one ``nm_prune_matmul`` launch.  In an MoE model the routed experts
prune with layer ``None`` (``models/moe.py``), as the reference's do, so a
gate/up/down probe "at layer l" prunes the experts' inputs in every layer.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch

from repro_torch.core.policy import ALL_PROJS, DENSE, SparsityPolicy

__all__ = [
    "relative_perturbation",
    "targeted_policy",
    "sensitivity_scan",
    "select_qgate_skips",
    "linear_flops",
    "coverage",
]

_EPS = 1e-6

ForwardFn = Callable[..., torch.Tensor]  # forward(params, batch, policy, phase) -> output


def relative_perturbation(y: torch.Tensor, y_prime: torch.Tensor) -> torch.Tensor:
    """e = ‖Y − Y'‖₂ / (‖Y‖₂ + ε), computed in float32 (a 0-d tensor).

    The difference is taken in float32, as the reference takes it; each
    norm's sum of squares is accumulated in float64 and rounded once to
    float32.  A float32 accumulation over a whole logit tensor (65.7M
    elements for LLaMA-3.1-8B's 2 x 256 tokens) drifts by up to ~3e-4 of
    the norm in torch's CPU reduction, where XLA's stays within ~1e-7."""
    yf = y.to(torch.float32).reshape(-1)
    yp = y_prime.to(torch.float32).reshape(-1)

    def norm(v):
        return torch.linalg.vector_norm(v, dtype=torch.float64).to(torch.float32)

    return norm(yf - yp) / (norm(yf) + _EPS)


def targeted_policy(
    module: str,
    layer: int,
    n_layers: int,
    base: SparsityPolicy,
) -> SparsityPolicy:
    """Policy pruning ONLY ``module`` at ``layer`` (for sensitivity probes)."""
    others = tuple(p for p in ALL_PROJS if p != module)
    skip = {module: frozenset(i for i in range(n_layers) if i != layer)}
    return base.with_(
        enabled=True, skip_modules=others, skip_layers=skip, phases=base.phases
    )


def sensitivity_scan(
    forward: ForwardFn,
    params,
    batch,
    modules: Sequence[str],
    n_layers: int,
    base_policy: SparsityPolicy,
    phase: str = "prefill",
) -> Dict[Tuple[str, int], float]:
    """e_p for every (module, layer) probe; returns a plain-float dict.

    ``forward(params, batch, policy=..., phase=...)`` (``Model.forward``'s
    signature) must route the policy to every projection.  One dense pass,
    then one pass per probe; each probe's e is read back to the host.
    """
    y_dense = forward(params, batch, policy=DENSE, phase=phase)
    out: Dict[Tuple[str, int], float] = {}
    for module in modules:
        for layer in range(n_layers):
            pol = targeted_policy(module, layer, n_layers, base_policy)
            y_p = forward(params, batch, policy=pol, phase=phase)
            out[(module, layer)] = float(relative_perturbation(y_dense, y_p))
    return out


# ---------------------------------------------------------------------------
# FLOP accounting + the paper's skip heuristic
# ---------------------------------------------------------------------------

def linear_flops(dims: Mapping[str, Tuple[int, int]], tokens: int = 1) -> Dict[str, float]:
    """2·T·d_in·d_out per projection, from a {module: (d_in, d_out)} map."""
    return {m: 2.0 * tokens * di * do for m, (di, do) in dims.items()}


def coverage(
    flops: Mapping[str, float],
    policy: SparsityPolicy,
    n_layers: int,
) -> float:
    """Fraction of total linear FLOPs that run sparsified under ``policy``."""
    total = 0.0
    pruned = 0.0
    for module, f in flops.items():
        for layer in range(n_layers):
            total += f
            if policy.should_prune(module, layer):
                pruned += f
    return pruned / max(total, 1.0)


def select_qgate_skips(
    sens: Mapping[Tuple[str, int], float],
    flops: Mapping[str, float],
    n_layers: int,
    base_policy: SparsityPolicy,
    coverage_target: float = 0.55,
) -> Tuple[int, ...]:
    """Pick q_proj/gate_proj layers to skip, most-sensitive first, while
    keeping linear-FLOP coverage ≥ ``coverage_target``.

    q_proj and gate_proj are skipped together per layer (combined score =
    sum of their sensitivities at that layer); the walk stops at the first
    candidate that would drop coverage under the target.
    """
    per_layer = []
    for layer in range(n_layers):
        s = sens.get(("q_proj", layer), 0.0) + sens.get(("gate_proj", layer), 0.0)
        per_layer.append((s, layer))
    per_layer.sort(reverse=True)  # most sensitive first

    skips: list[int] = []
    for _, layer in per_layer:
        cand = tuple(sorted(skips + [layer]))
        pol = base_policy.with_(
            skip_layers={"q_proj": frozenset(cand), "gate_proj": frozenset(cand)}
        )
        if coverage(flops, pol, n_layers) < coverage_target:
            break
        skips = list(cand)
    return tuple(sorted(skips))
