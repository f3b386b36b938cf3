"""Activation-importance scoring for Amber Pruner (port of
``repro/core/scoring.py``).

  * ``naive``  — ``S_ij = |X_ij|``.
  * ``wanda``  — ``S_ij = |X_ij| · ‖W_j,:‖₂ / min_k ‖W_k,:‖₂``.
  * ``robust`` — Robust-Norm Scoring: winsorize the weights to the
                 [0.5%, 99.5%] quantile band, standardize by the global mean
                 and population variance, then take min-normalized channel
                 L2 norms.

Weights are ``(d_in, d_out)`` as in the JAX package, so input channel j is
the row ``W[j, :]``.

``torch.quantile`` refuses inputs above 2**24 elements, and LLaMA-3.1-8B's
gate/down weights hold 4096·14336 = 58.7M, so the quantile is computed here
from one sort, with ``jnp.quantile``'s default "linear" rule — including its
float32 interpolation position ``q·(n-1)``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "channel_norm_scale",
    "robust_norm_scale",
    "precompute_scale",
    "score_activations",
    "quantiles_linear",
    "SCORE_MODES",
]

SCORE_MODES = ("naive", "wanda", "robust")

_EPS = 1e-12


def _min_normalize(norms: torch.Tensor) -> torch.Tensor:
    return norms / (torch.min(norms) + _EPS)


def channel_norm_scale(w: torch.Tensor) -> torch.Tensor:
    """Wanda-like per-input-channel scale: ``(d_in,)`` float32."""
    norms = torch.linalg.vector_norm(w.float(), dim=-1)
    return _min_normalize(norms)


def quantiles_linear(a: torch.Tensor, qs) -> list:
    """``jnp.quantile(a, q)`` (method "linear", whole array) for each q.

    One sort serves every q.  The position ``q·(n-1)`` and the weights are
    float32, as jnp computes them, so the bracketing elements match the
    JAX package's even where ``n - 1`` is not exactly representable.
    """
    v = a.reshape(-1).float().sort().values
    n = v.numel()
    out = []
    for q in qs:
        pos = np.float32(q) * np.float32(n - 1)
        lo_f, hi_f = np.floor(pos), np.ceil(pos)
        hw = np.float32(pos - lo_f)
        lw = np.float32(1.0) - hw
        lo = int(min(max(lo_f, 0), n - 1))
        hi = int(min(max(hi_f, 0), n - 1))
        out.append(v[lo] * float(lw) + v[hi] * float(hw))
    return out


def robust_norm_scale(w: torch.Tensor, q_low: float = 0.005,
                      q_high: float = 0.995) -> torch.Tensor:
    """Robust-Norm Scoring scale (paper Eqs. 3-5): ``(d_in,)`` float32."""
    wf = w.float()
    lo, hi = quantiles_linear(wf, (q_low, q_high))
    wc = torch.clamp(wf, lo, hi)
    mu = wc.mean()
    sd = torch.sqrt(wc.var(correction=0) + _EPS)   # population variance, as jnp.var
    wn = (wc - mu) / sd
    norms = torch.linalg.vector_norm(wn, dim=-1)
    return _min_normalize(norms)


def precompute_scale(w: torch.Tensor, mode: str) -> torch.Tensor | None:
    """Offline per-channel scale for a linear's weight, or None for naive."""
    if mode == "naive":
        return None
    if mode == "wanda":
        return channel_norm_scale(w)
    if mode == "robust":
        return robust_norm_scale(w)
    raise ValueError(f"unknown score mode {mode!r}; expected one of {SCORE_MODES}")


def score_activations(x: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """``S_ij = |X_ij| · scale_j`` (scale None → naive |X|); float32."""
    s = torch.abs(x.float())
    if scale is not None:
        s = s * scale.float()
    return s
