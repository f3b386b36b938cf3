"""StableLM-3B — dense MHA (kv = heads), LayerNorm (copy of
``repro/configs/stablelm_3b.py``).

[hf:stabilityai/stablelm-2-1_6b; unverified] 32L d_model=2560 32H
(GQA kv=32 ⇒ MHA) d_ff=6912 vocab=50304.  Full attention → long_500k skip.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        norm="layernorm",
        attn_chunk=8,
    )
