"""Model configuration: a copy of ``repro/configs/base.py``'s ``ModelConfig``.

``ModelConfig`` is a frozen dataclass with the same fields, defaults and
derived properties as the JAX package's, so a config round-trips between
the two packages field by field (the parity tests rely on it).  One module
per architecture lives in this package and exports ``CONFIG`` plus a
``smoke()`` reduced config of the same family for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

__all__ = ["ModelConfig", "get_config", "get_smoke_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // n_heads

    # --- attention ---
    attn_type: str = "full"         # full | swa | local
    window: int = 4096
    rope_variant: str = "default"   # default | 2d | mrope | sinusoidal | none
    rope_theta: float = 1e4
    qkv_bias: bool = False
    attn_chunk: int = 1024          # online-softmax KV chunk of the plain path
    attn_impl: str = "chunked"      # chunked | flash

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    moe_impl: str = "ragged"

    # --- recurrent / hybrid ---
    block_pattern: Tuple[str, ...] = ("attn",)
    rnn_width: int = 0
    conv_width: int = 4

    # --- encoder-decoder ---
    is_encdec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- VLM stub ---
    vision_stub: bool = False
    n_patches: int = 64

    # --- misc ---
    act_fn: str = "silu"            # silu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    sub_quadratic: bool = False
    remat: bool = True
    scan_layers: bool = True

    # paper-policy metadata: published q/gate skip lists where known
    qgate_skip_layers: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def get_config(arch: str) -> ModelConfig:
    """Load ``repro_torch/configs/<arch>.py`` and return its CONFIG."""
    arch = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}").smoke()
