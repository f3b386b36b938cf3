"""Qwen2-7B — one of the paper's own evaluation models (copy of
``repro/configs/qwen2_7b.py``).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, q/k/v biases.
Published Amber-P skip list: q_proj/gate_proj skipped in layers
0, 6, 23, 26, 27 → 57.6% of linear FLOPs accelerated (paper §Setup).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    qgate_skip_layers=(0, 6, 23, 26, 27),
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-smoke",
        family="dense",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        qgate_skip_layers=(0, 3),
        attn_chunk=8,
    )
