"""Assigned architecture config: hymba-1-5b."""

from repro_torch.configs.base import ArchConfig

# [hybrid] parallel attn+mamba heads [arXiv:2411.13676]
CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    sliding_window=1024,  # hymba uses SWA on most layers -> sub-quadratic
    supports_long_context=True,
)
