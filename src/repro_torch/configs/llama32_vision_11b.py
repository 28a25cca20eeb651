"""Assigned architecture config: llama32-vision-11b."""

from repro_torch.configs.base import ArchConfig

# [vlm] cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision]
CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    cross_attn_every=5,  # 8 cross-attention blocks
    frontend_seq=1601,  # vision patch tokens (stub input)
    rope_theta=500_000.0,
)
