"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8, head_dim=256)
d_ff=14336 vocab=256000 -- local(4096)+global alternating, logit
softcaps (attn 50, final 30), GeGLU, sandwich norms, tied embeddings
[arXiv:2408.00118]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    window_size=4096,
    global_pattern="alternate",  # even layers local SWA, odd layers global
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    post_norm=True,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        window_size=32,
    )
