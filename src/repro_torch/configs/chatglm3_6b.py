"""ChatGLM3-6B — dense GQA with 2D (half-dim) RoPE and QKV bias (copy of
``repro/configs/chatglm3_6b.py``).

[arXiv:2406.12793; hf] 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024.  Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_variant="2d",
    qkv_bias=True,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        rope_variant="2d",
        qkv_bias=True,
        attn_chunk=8,
    )
