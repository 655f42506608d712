"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MoE 256 routed top-8 + 1 shared, MLA, MTP depth 1
[arXiv:2412.19437].

The primary paper-technique target: 256 experts / 16-way TP = 16 experts
per shard, so the token all-to-all dispatch runs through the explicit
shard_map ring with the fused/scatter strategy switch.
"""

import dataclasses

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,  # MLA: latent cache replaces per-head KV
    d_ff=18432,  # dense-layer d_ff; experts use moe.expert_d_ff
    vocab_size=129280,
    rope_theta=10000.0,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        num_shared=1,
        expert_d_ff=2048,
        first_k_dense=3,
        dense_d_ff=18432,
        dispatch="ring",
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    mtp_depth=1,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=3,  # 1 dense + 2 moe
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        moe=MoEConfig(
            num_experts=8, top_k=2, num_shared=1, expert_d_ff=32,
            first_k_dense=1, dense_d_ff=128, dispatch="ring",
        ),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8, nope_head_dim=16, v_head_dim=16),
        mtp_depth=1,
    )
