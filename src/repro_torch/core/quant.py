"""W8A8 quantization (SmoothQuant) and Outstanding-sparse (port of
``repro/core/quant.py``).

SmoothQuant migrates activation outliers into the weights with a
per-input-channel factor

    s_j = max|X_:,j|^alpha / max|W_:,j|^(1-alpha)            (paper Eq. 9)

and rewrites ``Y = X W`` as ``Y = (X diag(1/s)) (diag(s) W)``, after which
both factors are int8-quantizable (per-tensor activations, per-channel
weights).  **Outstanding-sparse** inverts the factor (``ŝ = 1/s``, small
alpha 0.10), which expands the activation range so that the Amber N:M
pattern selects outlier channels more cleanly, letting sparsity and W8A8
stack.

Numerics follow the JAX package exactly: quantization divides by the scale
(never multiplies by a reciprocal; on a GPU PyTorch turns division by a
Python number into multiplication by its reciprocal, so constant divisors
are given as tensors on the data's device), ``torch.round`` rounds half to
even as
``jnp.round`` does, and dequantization is ``acc.float() * x_scale *
w_scale`` in that order.  ``int8 @ int8`` in PyTorch returns int8 and
wraps, so the integer product is taken in int32 on the CPU and in float64
on a GPU (``torch.matmul`` has no CUDA int32 kernel; float64 holds every
partial sum exactly, since ``|acc| <= D * 127**2 < 2**53``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import torch

__all__ = [
    "QuantConfig",
    "ActCalib",
    "smooth_factors",
    "quantize_weight_per_channel",
    "quantize_act_per_tensor",
    "quantize_act_per_token",
    "int_matmul",
    "quantized_matmul",
    "k_major",
    "QuantizedLinear",
    "make_quantized_linear",
]

_EPS = 1e-8


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device (see the module note)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static W8A8 deployment description.

    Attributes:
      alpha:         SmoothQuant migration strength (0.10 for
                     Outstanding-sparse, 0.5-0.85 for vanilla SmoothQuant).
      outstanding:   invert the smooth factor (ŝ = 1/s) to expand activations.
      per_token_act: dynamic per-token activation scales instead of the
                     static per-tensor one.
      skip_modules:  projections left in float (down_proj for LLaMA/Qwen2).
      skip_layers:   layer indices where every linear stays float.
    """

    alpha: float = 0.10
    outstanding: bool = True
    per_token_act: bool = False
    skip_modules: tuple = ("down_proj",)
    skip_layers: tuple = ()

    def should_quantize(self, module: str, layer_idx: int | None = None) -> bool:
        if module in self.skip_modules:
            return False
        if layer_idx is not None and layer_idx in self.skip_layers:
            return False
        return True


class ActCalib:
    """Running per-channel absmax over calibration batches."""

    def __init__(self) -> None:
        self._absmax: Dict[str, torch.Tensor] = {}

    def observe(self, name: str, x: torch.Tensor) -> None:
        am = torch.amax(x.float().reshape(-1, x.shape[-1]).abs(), dim=0)
        if name in self._absmax:
            am = torch.maximum(am, self._absmax[name])
        self._absmax[name] = am

    def absmax(self, name: str) -> torch.Tensor:
        return self._absmax[name]

    def names(self) -> Iterable[str]:
        return self._absmax.keys()


def smooth_factors(act_absmax: torch.Tensor, w: torch.Tensor, alpha: float,
                   outstanding: bool) -> torch.Tensor:
    """Per-input-channel smooth factor ``s`` (or ``ŝ = 1/s``), ``(d_in,)``
    float32, such that the rewrite is ``Y = (X / s) (s ⊙ W)``.

    ``act_absmax`` is ``(d_in,)``; ``w`` is ``(d_in, d_out)`` (channel j is
    row j).
    """
    a = torch.clamp(act_absmax.float(), min=_EPS)
    wmax = torch.clamp(torch.amax(w.float().abs(), dim=-1), min=_EPS)
    s = (a**alpha) / (wmax ** (1.0 - alpha))
    s = torch.clamp(s, min=_EPS)
    if outstanding:
        s = 1.0 / s
    return s


def quantize_weight_per_channel(w: torch.Tensor):
    """Symmetric int8 per-output-channel weight quant → (q, scale (d_out,))."""
    wf = w.float()
    scale = _div(torch.clamp(torch.amax(wf.abs(), dim=0), min=_EPS), 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_act_per_tensor(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Static symmetric per-tensor int8 activation quant with a given scale."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def quantize_act_per_token(x: torch.Tensor):
    """Dynamic per-token int8 quant → (q, scale (..., 1))."""
    xf = x.float()
    scale = _div(torch.clamp(torch.amax(xf.abs(), dim=-1, keepdim=True), min=_EPS), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact ``int8 @ int8`` sums as float32: int32 on the CPU, float64 on
    a GPU (both exact; each integer then rounds to float32 once)."""
    acc_t = torch.int32 if xq.device.type == "cpu" else torch.float64
    return (xq.to(acc_t) @ wq.to(acc_t)).float()


def quantized_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    """int8 × int8 → exact integer sum, dequantized to float32.

    ``x_scale`` is a scalar (per-tensor) or ``(..., 1)`` (per-token);
    ``w_scale`` is ``(d_out,)``.
    """
    return int_matmul(xq, wq) * x_scale * w_scale


def k_major(wq: torch.Tensor) -> torch.Tensor:
    """``wq (d_in, d_out)`` stored K-major: the ``(d_in, d_out)`` transposed
    view of one contiguous ``(d_out, d_in)`` buffer (each output channel's
    weights contiguous), the layout the port's int8 tensor-core kernels read
    (8-bit wgmma takes K-major operands only).  Values, shape and every
    plain-version result are unchanged; a tensor already so stored is
    returned as it is, anything else is copied once."""
    return wq if wq.t().is_contiguous() else wq.t().contiguous().t()


@dataclasses.dataclass
class QuantizedLinear:
    """Offline-rewritten linear: smooth + int8 weights + static act scale.
    ``wq`` is stored K-major (:func:`k_major`) whatever layout it is given
    in."""

    wq: torch.Tensor          # (d_in, d_out) int8, the view of a (d_out, d_in) buffer
    w_scale: torch.Tensor     # (d_out,) f32
    smooth: torch.Tensor      # (d_in,) f32 — divide X by this pre-quant
    act_scale: torch.Tensor   # 0-d f32 (static per-tensor)
    per_token: bool = False

    def __post_init__(self) -> None:
        self.wq = k_major(self.wq)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xs = x.float() / self.smooth
        if self.per_token:
            xq, ts = quantize_act_per_token(xs)
            return quantized_matmul(xq, self.wq, ts, self.w_scale).to(x.dtype)
        xq = quantize_act_per_tensor(xs, self.act_scale)
        return quantized_matmul(xq, self.wq, self.act_scale, self.w_scale).to(x.dtype)


def make_quantized_linear(w: torch.Tensor, act_absmax: torch.Tensor,
                          cfg: QuantConfig) -> QuantizedLinear:
    """Offline rewrite of one linear under SmoothQuant / Outstanding-sparse."""
    s = smooth_factors(act_absmax, w, cfg.alpha, cfg.outstanding)
    w_smoothed = w.float() * s[:, None]
    wq, w_scale = quantize_weight_per_channel(w_smoothed)
    act_scale = _div(torch.clamp(torch.amax(act_absmax.float() / s), min=_EPS), 127.0)
    return QuantizedLinear(wq=wq, w_scale=w_scale, smooth=s,
                           act_scale=act_scale.float(), per_token=cfg.per_token_act)
