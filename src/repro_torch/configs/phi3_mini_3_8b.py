"""Assigned architecture config: phi3-mini-3-8b."""

from repro_torch.configs.base import ArchConfig

# [dense] RoPE SwiGLU GQA(kv=32 -> MHA) [arXiv:2404.14219]
CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
)
