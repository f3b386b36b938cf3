"""Deterministic synthetic LM data (port of ``repro/data/pipeline.py``).

A batch is a pure function of ``(seed, step)``: tokens follow a Zipf
marginal over the vocabulary, sampled by inverse CDF, composed with a
copy-back process (each position takes the token ``copy_back`` places
earlier with probability ``copy_prob``), so a real LM objective has signal.

The random numbers come from a CPU ``torch.Generator`` seeded from
``(seed, step)``, whatever the target device, so the same call gives the
same tokens on the CPU and on the GPU; the batch is then moved to
``device``.  They are not ``jax.random``'s bits: the parity tests feed the
same numpy token arrays to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch

from repro_torch.models.common import resolve_device

__all__ = ["DataConfig", "lm_batch", "calibration_stream"]

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    copy_prob: float = 0.35
    copy_back: int = 8


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for ``(seed, step)``.  The CPU generator keeps only
    the low 32 bits of its seed, so the pair is mixed (splitmix64) into
    every bit rather than packed side by side."""
    mixed = _splitmix64(_splitmix64(seed & _MASK64) ^ (step & _MASK64))
    return torch.Generator(device="cpu").manual_seed(mixed & 0x7FFFFFFFFFFFFFFF)


def _zipf_tokens(u: torch.Tensor, vocab: int, alpha: float) -> torch.Tensor:
    """Inverse CDF of p(k) ∝ k^-alpha on [1, V] at float32 uniforms ``u``
    in [1e-6, 1) → int32 token ids in [0, V)."""
    inv = (1.0 - u * (1.0 - float(vocab) ** (1.0 - alpha))) ** (1.0 / (1.0 - alpha))
    return torch.clamp(inv.to(torch.int32) - 1, 0, vocab - 1)


def lm_batch(cfg: DataConfig, step: int, device=None) -> Dict[str, torch.Tensor]:
    """``{"tokens": (B, S + 1) int32}`` for ``step`` on ``device`` (default:
    the GPU, raising if there is none); callers slice inputs and labels."""
    device = resolve_device(device)
    gen = _generator(cfg.seed, step)
    b, s = cfg.global_batch, cfg.seq_len + 1
    u = 1e-6 + (1.0 - 1e-6) * torch.rand((b, s), generator=gen, dtype=torch.float32)
    base = _zipf_tokens(u, cfg.vocab_size, cfg.zipf_alpha)
    copy = torch.rand((b, s), generator=gen, dtype=torch.float32) < cfg.copy_prob
    tokens = torch.where(copy, torch.roll(base, cfg.copy_back, dims=1), base)
    return {"tokens": tokens.to(device)}


def calibration_stream(cfg: DataConfig, n_batches: int,
                       device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields ``n_batches`` prompt batches for SmoothQuant / sensitivity
    calibration, from steps the training stream does not reach."""
    for i in range(n_batches):
        yield lm_batch(cfg, 10_000_000 + i, device)
