"""Qwen2-VL-2B — VLM backbone with M-RoPE; vision frontend stubbed (copy of
``repro/configs/qwen2_vl_2b.py``).

[arXiv:2409.12191; hf] 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.  ``input_specs`` provides precomputed patch embeddings
(B, n_patches, d_model) that replace the first ``n_patches`` token slots;
M-RoPE position ids (3, B, S) are a stub input.  Full attention →
long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    rope_variant="mrope",
    rope_theta=1e6,
    qkv_bias=True,
    vision_stub=True,
    n_patches=64,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        rope_variant="mrope",
        qkv_bias=True,
        vision_stub=True,
        n_patches=4,
        attn_chunk=8,
    )
