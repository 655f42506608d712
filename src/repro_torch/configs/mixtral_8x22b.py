"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088].

8 experts < 16-way TP: expert dim is GSPMD-padded under the einsum
dispatch (see DESIGN.md §Arch-applicability); the explicit ring dispatch
is exercised on reduced configs where experts % shards == 0.
"""

import dataclasses

from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    rope_theta=1000000.0,
    window_size=4096,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    moe=MoEConfig(num_experts=8, top_k=2, dispatch="einsum"),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        window_size=32,
        moe=MoEConfig(num_experts=4, top_k=2, dispatch="einsum"),
    )
