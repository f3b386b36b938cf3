"""Shared model pieces: norms, embeddings, RoPE (port of
``repro/models/common.py``, the parts the dense family uses)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["RMSNorm", "Embedding", "rms_norm", "init_norm", "init_embedding",
           "embed", "rope_freqs", "apply_rope", "dtype_of", "resolve_device"]


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


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(vocab, d, dtype=dtype, device=device),
                              requires_grad=False)


def init_norm(d: int, kind: str, *, dtype: torch.dtype, device) -> RMSNorm:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    return RMSNorm(d, dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, p: RMSNorm, eps: float = 1e-6) -> torch.Tensor:
    """float32 RMSNorm, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.w.float()).to(x.dtype)


def init_embedding(vocab: int, d: int, *, dtype: torch.dtype, device,
                   generator: torch.Generator) -> Embedding:
    emb = Embedding(vocab, d, dtype=dtype, device=device)
    emb.w.copy_((torch.randn(vocab, d, generator=generator, device=device)
                 * 0.02).to(dtype))
    return emb


def embed(tokens: torch.Tensor, p: Embedding) -> torch.Tensor:
    return p.w[tokens.long()]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard (neox half-split) RoPE.  x: (B, T, H, hd); positions: (B, T)
    absolute.  cos/sin are cast to x's dtype before the rotation, as in the
    JAX package."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    ang = positions.float()[..., None] * inv                   # (B, T, hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    d2 = hd // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
