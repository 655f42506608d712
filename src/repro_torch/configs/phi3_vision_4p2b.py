"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (stub).

32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct]. The vision tower is a STUB:
input_specs() provides precomputed patch/text embeddings (batch, seq,
d_model); the LM head and vocab are real.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    input_kind="embeddings",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256
    )
