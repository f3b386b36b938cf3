"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window attention (copy of
``repro/configs/mixtral_8x7b.py``).

[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, SWA window 4096.  Its attention layers keep ring caches of
``min(window, max_seq)`` rows, which the block pool does not hold: it is
served on the dense per-slot slab.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
    attn_type="swa",
    window=4096,
    rope_theta=1e6,
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        n_experts=4,
        top_k=2,
        moe_d_ff=128,
        attn_type="swa",
        window=16,
        sub_quadratic=True,
        attn_chunk=8,
    )
