"""RG-LRU recurrent block, Griffin / RecurrentGemma (port of
``repro/models/rglru.py``).

Recurrence (per channel)::

    r_t = σ(x_t W_a),  i_t = σ(x_t W_x)
    a_t = exp(-c · softplus(Λ) · r_t)                (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

wrapped Griffin-style: ``y = W_out(RG-LRU(conv4(W_in x)) ⊙ gelu(W_gate x))``
with a causal width-4 temporal conv.  Amber mapping, as in the JAX
package: W_in is ``q_proj``, W_gate ``gate_proj`` (both pruned), W_out
``o_proj`` (skipped); the recurrence gates W_a / W_x and Λ stay dense.

``lam`` and ``h`` are float32, the conv history is in the model dtype and
the conv accumulates in float32 in the reference's tap order.  The JAX
package evaluates the linear recurrence with ``jax.lax.associative_scan``;
the port with a Hillis-Steele scan over time in float32
(:func:`_rglru_scan`: log2(T) levels of a few launches each, capturable),
the same function summed in another order.  A chunk of one token takes
the single step, as decode does.  The recurrence is plain torch, as the
reference computes it outside any Pallas kernel.  :func:`rglru_block`
returns the new state out of place; the model writes it into its cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.policy import SparsityPolicy
from repro_torch.layers.linear import init_linear, sparse_linear

__all__ = ["RGLRUBlock", "init_rglru_state", "rglru_block"]

_C = 8.0


class RGLRUBlock(nn.Module):
    def __init__(self, d: int, rnn_w: int, conv_width: int, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.q_proj = init_linear(d, rnn_w, **kw)          # W_in
        self.gate_proj = init_linear(d, rnn_w, **kw)       # W_gate
        self.o_proj = init_linear(rnn_w, d, **kw)          # W_out
        self.conv_w = nn.Parameter(
            (torch.randn(conv_width, rnn_w, generator=generator, device=device)
             * (conv_width * rnn_w) ** -0.25).to(dtype), requires_grad=False)
        self.conv_b = nn.Parameter(torch.zeros(rnn_w, dtype=dtype, device=device),
                                   requires_grad=False)
        self.gate_a = init_linear(rnn_w, rnn_w, **kw)      # W_a (dense)
        self.gate_x = init_linear(rnn_w, rnn_w, **kw)      # W_x (dense)
        self.lam = nn.Parameter(torch.rand(rnn_w, generator=generator, device=device) * 3 + 2,
                                requires_grad=False)


def init_rglru_state(batch: int, rnn_w: int, conv_width: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    return {"h": torch.zeros(batch, rnn_w, dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, conv_width - 1, rnn_w, dtype=dtype, device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 hist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv by shifted adds.  ``x (B, T, W)``, ``hist (B,
    cw-1, W)`` → (y in x's dtype, the new history)."""
    cw = w.shape[0]
    xp = torch.cat([hist, x], dim=1)
    t = x.shape[1]
    y = xp[:, :t].float() * w[cw - 1].float()
    for i in range(1, cw):
        y = y + xp[:, i:i + t].float() * w[cw - 1 - i].float()
    new_hist = xp[:, -(cw - 1):] if cw > 1 else hist
    return (y + b.float()).to(x.dtype), new_hist


def _rglru_scan(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + bx_t`` over ``(B, T, W)`` float32 from ``h0``, by
    Hillis-Steele doubling: after the level at offset ``s`` each position
    holds the composition of the last ``2s`` steps (the reference's
    combine ``(a1, b1), (a2, b2) → (a1 a2, a2 b1 + b2)``)."""
    bx = torch.cat([torch.addcmul(bx[:, :1], a[:, :1], h0[:, None]), bx[:, 1:]], dim=1)
    t, s = a.shape[1], 1
    while s < t:
        bx = torch.cat([bx[:, :s], torch.addcmul(bx[:, s:], a[:, s:], bx[:, :-s])], dim=1)
        if 2 * s < t:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return bx


def _rglru_step(a: torch.Tensor, bx: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One step ``a h + bx`` (decode, or a chunk of one token)."""
    return a * h + bx


def rglru_block(x: torch.Tensor, p: RGLRUBlock, policy: SparsityPolicy, phase: str,
                state: Optional[Dict[str, torch.Tensor]] = None,
                layer_idx: Optional[int] = None):
    """``x (B, T, d)`` → (y, new state); ``state`` None: zeros."""
    b, t, _ = x.shape
    rnn_w, cw = p.conv_b.shape[0], p.conv_w.shape[0]
    if state is None:
        state = init_rglru_state(b, rnn_w, cw, x.dtype, x.device)
    xi = sparse_linear(x, p.q_proj, "q_proj", policy, phase, layer_idx)
    gate = F.gelu(sparse_linear(x, p.gate_proj, "gate_proj", policy, phase, layer_idx),
                  approximate="tanh")
    xc, new_hist = _causal_conv(xi, p.conv_w, p.conv_b, state["conv"])

    xf = xc.float()
    r = torch.sigmoid(xf @ p.gate_a.w.float())
    i = torch.sigmoid(xf @ p.gate_x.w.float())
    a = torch.exp(-_C * F.softplus(p.lam) * r)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    if t == 1:
        h_last = _rglru_step(a[:, 0], bx[:, 0], state["h"])
        hs = h_last[:, None]
    else:
        hs = _rglru_scan(a, bx, state["h"])
        h_last = hs[:, -1]
    y = sparse_linear(hs.to(x.dtype) * gate, p.o_proj, "o_proj", policy, phase, layer_idx)
    return y, {"h": h_last, "conv": new_hist}
