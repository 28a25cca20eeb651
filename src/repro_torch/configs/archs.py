"""Registry of the 10 assigned architectures (one module per arch).

Select with ``--arch <id>``; ids use the assignment spelling (dots/dashes).
"""

from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b,
    hymba_1_5b,
    llama32_vision_11b,
    mamba2_780m,
    phi3_mini_3_8b,
    qwen2_moe_a2_7b,
    qwen3_0_6b,
    stablelm_12b,
    whisper_large_v3,
    yi_9b,
)
from repro_torch.configs.base import ArchConfig

ARCHS = {
    cfg.name: cfg
    for cfg in [
        mamba2_780m.CONFIG,
        qwen3_0_6b.CONFIG,
        yi_9b.CONFIG,
        stablelm_12b.CONFIG,
        phi3_mini_3_8b.CONFIG,
        whisper_large_v3.CONFIG,
        llama32_vision_11b.CONFIG,
        hymba_1_5b.CONFIG,
        dbrx_132b.CONFIG,
        qwen2_moe_a2_7b.CONFIG,
    ]
}


def get_arch(name: str) -> ArchConfig:
    """The registered config of ``name``; raises ``KeyError`` naming the
    available ones."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
