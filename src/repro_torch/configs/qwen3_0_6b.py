"""Assigned architecture config: qwen3-0-6b."""

from repro_torch.configs.base import ArchConfig

# [dense] qk_norm, GQA [hf:Qwen/Qwen3-8B family, 0.6B config]
CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,  # qwen3 uses 128 regardless of d_model/heads
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
