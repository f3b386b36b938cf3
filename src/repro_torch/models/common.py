"""Shared model pieces: norms, embeddings, positions (port of
``repro/models/common.py``: RMSNorm and LayerNorm, the sinusoidal
positions of the encoder-decoder, the default, the 2-D and the M-RoPE)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["RMSNorm", "LayerNorm", "Embedding", "rms_norm", "layer_norm", "norm_apply",
           "init_norm", "init_embedding", "embed", "sinusoidal_positions", "rope_freqs",
           "apply_rope", "apply_rope_2d", "apply_mrope", "dtype_of", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: raise when there is none, never fall back to
    the CPU.  The CPU is used only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU unless "
                               "the caller passes device='cpu'")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def dtype_of(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                              requires_grad=False)


class LayerNorm(nn.Module):
    """``w`` (ones) and ``b`` (zeros), as the JAX ``init_norm`` makes them."""

    def __init__(self, d: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                              requires_grad=False)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(vocab, d, dtype=dtype, device=device),
                              requires_grad=False)


def init_norm(d: int, kind: str, *, dtype: torch.dtype, device) -> RMSNorm | LayerNorm:
    if kind == "layernorm":
        return LayerNorm(d, dtype=dtype, device=device)
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    return RMSNorm(d, dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, p: RMSNorm, eps: float = 1e-6) -> torch.Tensor:
    """float32 RMSNorm, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """float32 LayerNorm over the population variance (``jnp.var``'s), plus
    ``p.b`` where the norm has one, cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p.w.float()
    b = getattr(p, "b", None)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def norm_apply(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    return layer_norm(x, p) if kind == "layernorm" else rms_norm(x, p)


def init_embedding(vocab: int, d: int, *, dtype: torch.dtype, device,
                   generator: torch.Generator) -> Embedding:
    emb = Embedding(vocab, d, dtype=dtype, device=device)
    emb.w.copy_((torch.randn(vocab, d, generator=generator, device=device)
                 * 0.02).to(dtype))
    return emb


def embed(tokens: torch.Tensor, p: Embedding) -> torch.Tensor:
    return p.w[tokens.long()]


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The classic sinusoidal embedding ``[sin ∥ cos]`` of ``positions``
    (any shape) → ``(..., d)`` float32 (the caller casts it)."""
    half = d // 2
    dev = positions.device
    log_base = torch.full((), 10000.0, dtype=torch.float32, device=dev).log()
    freqs = torch.exp(-log_base * torch.arange(half, dtype=torch.float32, device=dev) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope_freqs(head_dim: int, theta: float, rotary_dim: int | None = None,
               device=None) -> torch.Tensor:
    rd = rotary_dim or head_dim
    return 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32, device=device)
                            / rd))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs laid out as [x0..x_{d/2-1} | x_{d/2}..] (neox style)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _cos_sin(positions: torch.Tensor, inv: torch.Tensor, dtype: torch.dtype):
    """cos and sin of ``positions (B, T)`` times ``inv``, ``(B, T, 1, F)``,
    cast to x's dtype before the rotation, as in the JAX package."""
    ang = positions.float()[..., None] * inv
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard (neox half-split) RoPE.  x: (B, T, H, hd); positions: (B, T)
    absolute."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)      # (hd/2,)
    return _rotate(x, *_cos_sin(positions, inv, x.dtype))


def apply_rope_2d(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """ChatGLM-style: rotary on the first half of head_dim only, with
    frequencies over that half (``rotary_dim = hd // 2``)."""
    hd = x.shape[-1]
    rd = hd // 2
    inv = rope_freqs(hd, theta, rotary_dim=rd, device=x.device)  # (rd/2,)
    return torch.cat([_rotate(x[..., :rd], *_cos_sin(positions, inv, x.dtype)),
                      x[..., rd:]], dim=-1)


MROPE_SECTIONS = (0.25, 0.375, 0.375)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections=MROPE_SECTIONS) -> torch.Tensor:
    """Qwen2-VL's M-RoPE: the half head_dim's frequencies split into
    ``sections`` of the temporal, height and width position streams, each
    frequency rotated by the angle of its own stream.  x: (B, T, H, hd);
    positions_3d: (3, B, T)."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, device=x.device)        # (half,)
    n_t = int(half * sections[0])
    n_th = n_t + int(half * sections[1])
    ang_all = positions_3d.float()[..., None] * inv               # (3, B, T, half)
    ang = torch.cat([ang_all[0, ..., :n_t], ang_all[1, ..., n_t:n_th],
                     ang_all[2, ..., n_th:]], dim=-1)
    return _rotate(x, torch.cos(ang)[:, :, None, :].to(x.dtype),
                   torch.sin(ang)[:, :, None, :].to(x.dtype))
