"""Qwen3-30B-A3B — the paper's MoE evaluation model (copy of
``repro/configs/qwen3_30b_a3b.py``).

48L d_model=2048 32H (GQA kv=4) 128 experts top-8, moe_d_ff=768,
vocab=151936.  Published Amber-P skip list: q_proj/gate_proj skipped in
layers 41, 46, 47 → 56.9% coverage.  Robust-Norm scoring disabled inside
routed experts (paper: dynamic routing → per-expert stats unstable).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    rope_theta=1e6,
    qgate_skip_layers=(41, 46, 47),
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        n_experts=8,
        top_k=2,
        moe_d_ff=32,
        qgate_skip_layers=(1,),
        attn_chunk=8,
    )
