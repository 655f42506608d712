"""Config dataclasses: model, shapes, mesh, training, serving (a copy of
``repro.configs.base``, field for field).

Every assigned architecture gets a module in this package exposing
``CONFIG`` (the exact full-size numbers from the assignment) and
``reduced()`` (same family, tiny dims -- what the CPU smoke tests run).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared: int = 0  # deepseek: shared experts always active
    expert_d_ff: int = 0  # 0 -> use model d_ff
    first_k_dense: int = 0  # leading dense layers (deepseek: 3)
    dense_d_ff: int = 0  # d_ff of those dense layers
    capacity_factor: float = 1.25
    dispatch: str = "einsum"  # einsum (gshard) | ring (shard_map a2a) | dense
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mlstm"  # mlstm | mamba
    state_dim: int = 16  # mamba SSM state
    conv_dim: int = 4  # mamba depthwise conv width
    expand: float = 2.0  # inner dim = expand * d_model
    chunk: int = 64  # chunkwise-parallel chunk length
    slstm_every: int = 0  # xLSTM: every k-th block is sLSTM (0 = none)
    slstm_heads: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- attention ---
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # partial rotary (nemotron: 0.5)
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    window_size: int = 0  # sliding-window width (0 = full attention)
    global_pattern: str = "none"  # none | alternate | ends  (which layers go full)
    meta_tokens: int = 0  # hymba: learnable prefix tokens
    # --- mlp / norms ---
    mlp_kind: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    post_norm: bool = False  # gemma2 sandwich norm
    tie_embeddings: bool = False
    # --- submodules ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0  # >0 -> encoder-decoder
    decoder_ratio: int = 4  # decoder_len = seq_len // ratio
    # --- io ---
    input_kind: str = "tokens"  # tokens | embeddings (vlm/audio stub frontends)
    mtp_depth: int = 0  # deepseek multi-token prediction heads
    # --- numerics ---
    dtype: str = "bfloat16"
    remat: str = "full"  # full | dots | none
    seq_parallel: bool = True  # shard saved residual seq dim over TP axis
    attn_partition: str = "auto"  # auto | heads | context (see attention.py)
    attn_kv_chunk: int = 512  # flash KV block (VMEM-bounded on TPU)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic sequence handling (SSM state / sliding window)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> float:
        """Analytic parameter count (used for 6ND model-flops)."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        n_dec = self.num_layers
        if self.ssm is not None and self.ssm.kind == "mlstm":
            n_slstm = 0
            if self.ssm.slstm_every:
                n_slstm = self.num_layers // self.ssm.slstm_every
            n_mlstm = self.num_layers - n_slstm
            di = int(self.ssm.expand * d)
            # mLSTM block: up/gate/down proj + qkv + gates + out
            per_m = d * di * 2 + di * d + 3 * di * di // self.num_heads + 3 * di
            per_s = 4 * (d * d + (d // self.ssm.slstm_heads) * d) + 2 * d * (d * 4 // 3)
            total += n_mlstm * per_m + n_slstm * per_s
            return float(total)
        # attention params
        if self.mla is not None:
            m = self.mla
            per_attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.num_heads * (m.nope_head_dim + m.rope_head_dim)
                + d * (m.kv_lora_rank + m.rope_head_dim)
                + m.kv_lora_rank * self.num_heads * (m.nope_head_dim + m.v_head_dim)
                + self.num_heads * m.v_head_dim * d
            )
        else:
            per_attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        # mlp params
        gated = self.mlp_kind in ("swiglu", "geglu")
        def mlp_params(ff: int) -> int:
            return d * ff * (3 if gated else 2)
        if self.moe is not None:
            mo = self.moe
            eff = mo.expert_d_ff or self.d_ff
            dense_ff = mo.dense_d_ff or self.d_ff
            n_moe = n_dec - mo.first_k_dense
            per_moe = (mo.num_experts + mo.num_shared) * mlp_params(eff) + d * mo.num_experts
            total += mo.first_k_dense * (per_attn + mlp_params(dense_ff)) + n_moe * (per_attn + per_moe)
        elif self.ssm is not None and self.ssm.kind == "mamba":  # hybrid (hymba)
            di = int(self.ssm.expand * d)
            per_mamba = d * 2 * di + di * (self.ssm.state_dim * 2 + 1) + di * d
            total += n_dec * (per_attn + per_mamba + mlp_params(self.d_ff))
        else:
            total += n_dec * (per_attn + mlp_params(self.d_ff))
        if self.is_encdec:
            total += self.encoder_layers * (per_attn + mlp_params(self.d_ff))
            total += n_dec * per_attn  # cross attention
        return float(total)

    def active_param_count(self) -> float:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        d = self.d_model
        eff = mo.expert_d_ff or self.d_ff
        gated = self.mlp_kind in ("swiglu", "geglu")
        per_expert = d * eff * (3 if gated else 2)
        inactive = (self.num_layers - mo.first_k_dense) * (
            (mo.num_experts - mo.top_k) * per_expert
        )
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: smoke-test shapes (same kinds, tiny)
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 4, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 128, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode"),
    "long_500k": ShapeConfig("long_500k", 256, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0  # 0 = no gradient accumulation
    opt_state_dtype: str = "float32"  # float32 | bfloat16 (HBM relief at 671B)
    grad_compression: str = "none"  # none | int8 (error-feedback allreduce)
    seed: int = 0
    checkpoint_every: int = 500
    keep_checkpoints: int = 3
    z_loss: float = 1e-4


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 2048
    prefill_chunk: int = 512
    temperature: float = 0.0  # greedy


def shape_for(name: str, smoke: bool = False) -> ShapeConfig:
    table = SMOKE_SHAPES if smoke else SHAPES
    return table[name]
