"""Whisper-medium — encoder-decoder with a stubbed conv frontend (copy of
``repro/configs/whisper_medium.py``).

[arXiv:2212.04356; unverified] 24L d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=51865; encoder consumes 1500 precomputed frame embeddings
(conv frontend stub per the task spec).  Sinusoidal positions so assigned
decoder lengths beyond Whisper's 448 are well-defined.  Full attention →
long_500k skipped; decode shapes run (decoder + cross-attention cache).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    is_encdec=True,
    n_encoder_layers=24,
    encoder_seq=1500,
    rope_variant="sinusoidal",
    act_fn="gelu",
    norm="layernorm",
    qkv_bias=True,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        is_encdec=True,
        n_encoder_layers=2,
        encoder_seq=16,
        rope_variant="sinusoidal",
        act_fn="gelu",
        norm="layernorm",
        qkv_bias=True,
        attn_chunk=8,
    )
