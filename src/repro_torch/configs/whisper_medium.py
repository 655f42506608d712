"""whisper-medium [audio]: enc-dec 24L+24L d_model=1024 16H d_ff=4096
vocab=51865 -- conv frontend is a STUB: input_specs() provides
precomputed frame embeddings (batch, seq, d_model); decoder length is
seq_len // 4 (see DESIGN.md §Arch-applicability) [arXiv:2212.04356]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    decoder_ratio=4,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mlp_kind="gelu",
    norm_kind="layernorm",
    input_kind="embeddings",  # stub conv frontend emits frame embeddings
    rope_theta=0.0,  # whisper uses absolute (sinusoidal) positions
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
    )
