"""Assigned architecture config: yi-9b."""

from repro_torch.configs.base import ArchConfig

# [dense] llama-arch GQA [arXiv:2403.04652]
CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=10_000.0,
)
