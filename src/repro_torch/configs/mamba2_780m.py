"""Assigned architecture config: mamba2-780m."""

from repro_torch.configs.base import ArchConfig

# [ssm] SSD (state-space duality) [arXiv:2405.21060]
CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,  # attention-free, no MLP (mamba2 blocks only)
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    supports_long_context=True,
)
