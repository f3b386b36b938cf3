"""Model dispatcher (port of ``repro/models/model.py``): an
encoder-decoder (``cfg.is_encdec``) goes to ``models/encdec.py``, every
other family to ``models/transformer.py``::

    model = build_model(cfg)                 # cuda; device="cpu" for tests
    params = model.init(seed)                # a Transformer or EncDec nn.Module
    logits = model.forward(params, batch, policy=...)   # phase="train", as the reference
    logits, cache = model.prefill(params, batch, cache, policy=...)
    logits, cache = model.prefill_chunk(params, batch, cache, policy=...)
    logits, cache = model.decode_step(params, tokens, cache, policy=...)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.models import encdec, transformer
from repro_torch.models.common import resolve_device

__all__ = ["Model", "build_model", "resolve_device", "stub_shapes"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    @property
    def _mod(self):
        return encdec if self.cfg.is_encdec else transformer

    def init(self, seed: int = 0):
        return self._mod.init_params(self.cfg, seed, device=self.device)

    def forward(self, params, batch, *, policy: SparsityPolicy = DENSE,
                phase: str = "train"):
        return self._mod.forward(self.cfg, params, batch, policy=policy, phase=phase)

    def init_cache(self, batch_size: int, max_seq: int, dtype=None,
                   block_size: int = 16, paged=None):
        return self._mod.init_cache(self.cfg, batch_size, max_seq, dtype,
                                    device=self.device, block_size=block_size, paged=paged)

    def layer_kinds(self):
        return self._mod.layer_kinds(self.cfg)

    def paged_kv_spec(self):
        return self._mod.paged_kv_spec(self.cfg)

    def pools_anything(self) -> bool:
        return self._mod.pools_anything(self.cfg)

    def stub_shapes(self) -> Dict[str, Tuple[int, int]]:
        return stub_shapes(self.cfg)

    def prefill(self, params, batch, cache, *, policy: SparsityPolicy = DENSE):
        return self._mod.prefill(self.cfg, params, batch, cache, policy=policy)

    def prefill_chunk(self, params, batch, cache, *, policy: SparsityPolicy = DENSE):
        return self._mod.prefill_chunk(self.cfg, params, batch, cache, policy=policy)

    def decode_step(self, params, tokens, cache, *, policy: SparsityPolicy = DENSE):
        return self._mod.decode_step(self.cfg, params, tokens, cache, policy=policy)


def stub_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    """``{batch key: (rows, d_model)}`` of each modality stub ``cfg`` takes
    with a request's prompt: an encoder-decoder's ``frame_embeds`` of
    ``encoder_seq`` rows, a VLM's ``pixel_embeds`` of ``n_patches``; empty for
    a text-only model."""
    out = {}
    if cfg.is_encdec:
        out["frame_embeds"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.vision_stub:
        out["pixel_embeds"] = (cfg.n_patches, cfg.d_model)
    return out


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model on ``device`` (default: the GPU, raising if there is none)."""
    (encdec if cfg.is_encdec else transformer).check_supported(cfg)
    return Model(cfg=cfg, device=resolve_device(device))
