"""Architecture + shape configuration system (``--arch`` / ``--shape``).

A copy of the reference's ``configs/base.py`` (plain dataclasses, no JAX):
the port keeps its own so that it never imports ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One LM workload shape: sequence length, global batch and kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned LM shapes.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One LM architecture: family, widths, depth and numerics."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # attention details
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: int = 0  # 0 => full attention
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_kernel: int = 4

    # structure
    cross_attn_every: int = 0  # vlm: insert cross-attn before every n-th layer
    max_position_embeddings: int = 32_770  # learned-positional archs (whisper)
    encoder_layers: int = 0  # audio: encoder depth (enc-dec)
    frontend_seq: int = 0  # audio/vlm stub frontend length
    tie_embeddings: bool = False

    # numerics / compilation
    norm_eps: float = 1e-6
    act: str = "silu"  # silu | gelu
    param_dtype: str = "bfloat16"  # bf16 params + f32 optimizer moments (mixed precision)
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # which shapes apply (long_500k only for sub-quadratic archs)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        if self.act == "silu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        per_layer = 0
        if self.family == "ssm":
            di, N = self.d_inner_ssm, self.ssm_state
            H = self.ssm_heads
            in_proj = d * (2 * di + 2 * self.ssm_groups * N + H)
            per_layer = in_proj + di * d + di * self.conv_kernel
        elif self.family == "moe":
            e_mlp = 3 * d * self.d_ff * self.num_experts
            shared = 3 * d * self.d_ff * self.num_shared_experts
            router = d * self.num_experts
            per_layer = attn + e_mlp + shared + router
        elif self.family == "hybrid":
            di, N = self.d_inner_ssm, self.ssm_state
            H = self.ssm_heads
            ssm = d * (2 * di + 2 * self.ssm_groups * N + H) + di * d
            per_layer = attn + ssm + mlp
        elif self.family == "audio":
            per_layer = 2 * attn + mlp  # decoder: self-attn + cross-attn
        else:
            per_layer = attn + mlp
        total = emb + L * per_layer
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp)
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            total += n_cross * (attn + mlp)
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE uses top-k + shared experts)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        active_mlp = 3 * d * self.d_ff * (self.num_experts_per_tok + self.num_shared_experts)
        router = d * self.num_experts
        return int(emb + L * (attn + active_mlp + router))

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2)
            if self.num_experts_per_tok else 0,
            num_shared_experts=min(self.num_shared_experts, 1)
            if self.num_shared_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_seq=16 if self.frontend_seq else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            max_position_embeddings=128,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            scan_layers=False,
        )
