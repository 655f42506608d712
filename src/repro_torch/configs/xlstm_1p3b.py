"""xlstm-1.3b [ssm]: 48L d_model=2048, sLSTM + mLSTM blocks, vocab=50304
[arXiv:2405.04517]. Attention-free: runs long_500k with O(1) state.

Block layout: every 2nd block is sLSTM (scalar memory, sequential scan,
4 heads); the rest are mLSTM (matrix memory, chunkwise-parallel).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,  # blocks carry their own projections
    vocab_size=50304,
    norm_kind="layernorm",
    ssm=SSMConfig(kind="mlstm", expand=2.0, chunk=64, slstm_every=2, slstm_heads=4),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        vocab_size=256,
        ssm=SSMConfig(kind="mlstm", expand=2.0, chunk=16, slstm_every=2, slstm_heads=2),
    )
