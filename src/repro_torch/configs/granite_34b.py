"""Granite-34B-Code — deep dense LLaMA-arch with MQA (kv=1; copy of
``repro/configs/granite_34b.py``).

[arXiv:2405.04324; hf] 88L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152.  Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        attn_chunk=8,
    )
