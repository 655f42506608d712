"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
ssm_state=16 -- parallel attention + mamba heads in every layer, 128
meta tokens, SWA everywhere except first/middle/last global layers
[arXiv:2411.13676]. Runs long_500k (SWA cache + O(1) SSM state)."""

import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    rope_theta=10000.0,
    window_size=1024,
    global_pattern="ends",  # first / middle / last layers full attention
    meta_tokens=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    ssm=SSMConfig(kind="mamba", state_dim=16, conv_dim=4, expand=2.0, chunk=128),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        window_size=32,
        meta_tokens=8,
        ssm=SSMConfig(kind="mamba", state_dim=8, conv_dim=4, expand=2.0, chunk=16),
    )
