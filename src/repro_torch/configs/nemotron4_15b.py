"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 -- squared-ReLU MLP (no gating), LayerNorm, partial rotary
[arXiv:2402.16819]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    rope_theta=10000.0,
    rope_fraction=0.5,
    mlp_kind="relu2",
    norm_kind="layernorm",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256
    )
