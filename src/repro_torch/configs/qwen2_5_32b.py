"""Qwen2.5-32B — dense GQA with QKV bias (copy of
``repro/configs/qwen2_5_32b.py``).

[hf:Qwen/Qwen2.5-0.5B; hf] 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064.  Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        attn_chunk=8,
    )
