"""RWKV6-7B (Finch) — attention-free, data-dependent decay (copy of
``repro/configs/rwkv6_7b.py``).

[arXiv:2404.05892; hf] 32L d_model=4096 d_ff=14336 vocab=65536.
Head size 64 → 64 heads.  Linear-time → long_500k runs.
Attention-free: served on the dense per-slot slab (its recurrent state is
per slot; nothing is pooled).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # head_size 64
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    block_pattern=("rwkv6",),
    rope_variant="none",
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        head_dim=32,
        block_pattern=("rwkv6",),
        rope_variant="none",
        sub_quadratic=True,
    )
