"""Model dispatcher (port of ``repro/models/model.py``)::

    model = build_model(cfg)                 # cuda; device="cpu" for tests
    params = model.init(seed)                # a Transformer nn.Module
    logits = model.forward(params, batch, policy=...)
    logits, cache = model.prefill(params, batch, cache, policy=...)
    logits, cache = model.prefill_chunk(params, batch, cache, policy=...)
    logits, cache = model.decode_step(params, tokens, cache, policy=...)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device

__all__ = ["Model", "build_model", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0) -> transformer.Transformer:
        return transformer.init_params(self.cfg, seed, device=self.device)

    def forward(self, params, batch, *, policy: SparsityPolicy = DENSE,
                phase: str = "prefill"):
        return transformer.forward(self.cfg, params, batch, policy=policy, phase=phase)

    def init_cache(self, batch_size: int, max_seq: int, dtype=None,
                   block_size: int = 16):
        return transformer.init_cache(self.cfg, batch_size, max_seq, dtype,
                                      device=self.device, block_size=block_size)

    def paged_kv_spec(self):
        return transformer.paged_kv_spec(self.cfg)

    def prefill(self, params, batch, cache, *, policy: SparsityPolicy = DENSE):
        return transformer.prefill(self.cfg, params, batch, cache, policy=policy)

    def prefill_chunk(self, params, batch, cache, *, policy: SparsityPolicy = DENSE):
        return transformer.prefill_chunk(self.cfg, params, batch, cache, policy=policy)

    def decode_step(self, params, tokens, cache, *, policy: SparsityPolicy = DENSE):
        return transformer.decode_step(self.cfg, params, tokens, cache, policy=policy)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model on ``device`` (default: the GPU, raising if there is none)."""
    transformer.check_supported(cfg)
    return Model(cfg=cfg, device=resolve_device(device))
