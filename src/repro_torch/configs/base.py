"""Model configuration: a copy of ``repro/configs/base.py``'s ``ModelConfig``.

``ModelConfig`` is a frozen dataclass with the same fields, defaults and
derived properties as the JAX package's, so a config round-trips between
the two packages field by field (the parity tests rely on it).  One module
per architecture lives in this package and exports ``CONFIG`` plus a
``smoke()`` reduced config of the same family for CPU tests.  ``ShapeCell``,
``SHAPE_CELLS``, ``ARCH_IDS`` and ``PAPER_ARCH_IDS`` are copied field for
field too.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

__all__ = ["ModelConfig", "ShapeCell", "SHAPE_CELLS", "ARCH_IDS", "PAPER_ARCH_IDS",
           "get_config", "get_smoke_config"]


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

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.n_experts:
            per_ff = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
            if self.shared_expert:
                per_ff += 3 * d * self.moe_d_ff
        else:
            per_ff = 3 * d * f
        kinds = [self.block_pattern[i % len(self.block_pattern)] for i in range(self.n_layers)]
        n_attn = sum(k == "attn" for k in kinds)
        n_rwkv = sum(k == "rwkv6" for k in kinds)
        n_rglru = sum(k == "rglru" for k in kinds)
        rnn_w = self.rnn_width or d
        per_rwkv = 5 * d * d + 3 * d * f  # r,k,v,g,o + channel-mix
        per_rglru = 2 * d * rnn_w + rnn_w * d + 2 * rnn_w * rnn_w // 64
        total = v * d * (1 if self.tie_embeddings else 2)
        total += n_attn * (per_attn + per_ff) + n_rwkv * per_rwkv + n_rglru * (per_rglru + per_ff)
        if self.is_encdec:
            total += self.n_encoder_layers * (2 * per_attn + per_ff)  # self+cross approx
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        dense_ff_total = self.n_params() - self.n_layers * (
            self.n_experts * 3 * d * self.moe_d_ff)
        active_ff = self.n_layers * (self.top_k * 3 * d * self.moe_d_ff)
        return int(dense_ff_total + active_ff)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

ARCH_IDS = (
    "mixtral_8x7b",
    "llama4_scout_17b_a16e",
    "qwen2_vl_2b",
    "rwkv6_7b",
    "whisper_medium",
    "recurrentgemma_2b",
    "qwen2_5_32b",
    "stablelm_3b",
    "granite_34b",
    "chatglm3_6b",
)

# the paper's own evaluation models (small-scale stand-ins live in smoke())
PAPER_ARCH_IDS = ("llama31_8b", "qwen2_7b", "qwen3_30b_a3b")


def get_config(arch: str) -> ModelConfig:
    """Load ``repro_torch/configs/<arch>.py`` and return its CONFIG."""
    arch = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}").smoke()
