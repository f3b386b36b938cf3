"""Weight-sparsity baselines (port of ``repro/core/weight_sparsity.py``;
paper Appendix A comparison set).

The paper contrasts Naïve top-k *activation* sparsity against N:M *weight*
sparsity methods and shows activation sparsity dominates:

  * ``magnitude_nm``  — |W| scores (Pruner-Zero's seed metric).
  * ``wanda_nm``      — |W_ij| · ‖X_:,j‖₂ (Wanda, Eq. 1 of the paper).
  * ``sparsegpt_nm``  — OBS-style scores w²·h_j with the reference's
                        diagonal-Hessian approximation and its row-energy
                        rescale of the survivors.

Weight layout: ``(d_in, d_out)``; N:M groups run along d_in (the contraction
axis), independently for every output column.  Selection is
``core.nm.nm_topk_mask`` (a tie goes to the lower channel), so the masks are
the reference's bit for bit.  Pure torch: no kernel is called.
"""
from __future__ import annotations

import torch

from repro_torch.core import nm

__all__ = ["magnitude_nm", "wanda_nm", "sparsegpt_nm"]


def _mask_along_din(scores_t: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """scores_t: (d_out, d_in) → bool mask (d_out, d_in), N:M along d_in."""
    return nm.nm_topk_mask(scores_t, n, m)


def _back(pruned_t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(d_out, d_in) float32 → ``like``'s (d_in, d_out) layout and dtype."""
    return pruned_t.t().to(like.dtype).contiguous()


def magnitude_nm(w: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Prune by |W| within N:M groups along the input dimension."""
    wt = w.t().to(torch.float32)                      # (d_out, d_in)
    mask = _mask_along_din(wt.abs(), n, m)
    return _back(wt * mask, w)


def wanda_nm(w: torch.Tensor, act_norm: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Wanda: S_ij = |W_ij| · ‖X_:,j‖₂ with per-output-row N:M groups.

    Args:
      w:        (d_in, d_out) weights.
      act_norm: (d_in,) calibration activation column norms ‖X_:,j‖₂.
    """
    wt = w.t().to(torch.float32)                      # (d_out, d_in)
    scores = wt.abs() * act_norm.to(torch.float32)[None, :]
    mask = _mask_along_din(scores, n, m)
    return _back(wt * mask, w)


def sparsegpt_nm(
    w: torch.Tensor,
    hessian_diag: torch.Tensor,
    n: int,
    m: int,
    damp: float = 0.01,
) -> torch.Tensor:
    """Diagonal-Hessian SparseGPT with the reference's error compensation.

    H ≈ diag(Σ_t X_tj²) + λI with λ = ``damp``·mean + 1e-8; score = w²·h.
    Under a diagonal H the OBS update of the other weights vanishes, so, as
    the reference does, the survivors of each output row are rescaled to
    keep the row's H-weighted energy.

    Args:
      w:            (d_in, d_out).
      hessian_diag: (d_in,) — per input channel Σ X² from calibration.
    """
    h = hessian_diag.to(torch.float32) + damp * hessian_diag.mean() + 1e-8
    wt = w.t().to(torch.float32)                      # (d_out, d_in)
    scores = wt**2 * h[None, :]
    mask = _mask_along_din(scores, n, m)
    pruned = wt * mask

    # H-weighted row-energy preserving rescale of the survivors
    num = torch.sum(wt**2 * h[None, :], dim=-1, keepdim=True)
    den = torch.sum(pruned**2 * h[None, :], dim=-1, keepdim=True) + 1e-12
    gain = torch.sqrt(num / den)
    return _back(pruned * gain, w)
