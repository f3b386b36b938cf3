"""LLaMA3.1-8B — one of the paper's own evaluation models.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
Published Amber-P skip list: q_proj/gate_proj skipped in layers
19, 21, 28, 30, 31 (paper §Setup).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    qgate_skip_layers=(19, 21, 28, 30, 31),
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama31-smoke",
        family="dense",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        qgate_skip_layers=(3,),
        attn_chunk=8,
    )
