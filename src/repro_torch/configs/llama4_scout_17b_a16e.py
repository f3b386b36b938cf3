"""Llama-4-Scout-17B-16E — 16-expert top-1 MoE with a shared expert (copy
of ``repro/configs/llama4_scout_17b_a16e.py``).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1,
early fusion (multimodal frontend stubbed — text backbone only here).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    moe_d_ff=8192,
    shared_expert=True,
    rope_theta=5e5,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        n_experts=4,
        top_k=1,
        moe_d_ff=96,
        shared_expert=True,
        attn_chunk=8,
    )
