"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 1 attn : 2
recurrent (copy of ``repro/configs/recurrentgemma_2b.py``).

[arXiv:2402.19427; hf] 26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680
vocab=256000, local-attn window 2048.  Period (rglru, rglru, attn);
26 = 8 full periods + 2 leftover recurrent blocks.  Sub-quadratic →
long_500k runs.
Its local attention keeps ring caches of ``min(window, max_seq)`` rows and
its RG-LRU blocks per-slot state: served on the dense per-slot slab.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "attn"),
    rnn_width=2560,
    attn_type="local",
    window=2048,
    act_fn="gelu",
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        n_layers=5,          # 1 full period + 2 leftover
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        block_pattern=("rglru", "rglru", "attn"),
        rnn_width=64,
        attn_type="local",
        window=8,
        act_fn="gelu",
        sub_quadratic=True,
        attn_chunk=8,
    )
