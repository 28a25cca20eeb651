"""Assigned architecture config: whisper-large-v3."""

from repro_torch.configs.base import ArchConfig

# [audio] enc-dec, conv frontend (stub) [arXiv:2212.04356]
CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,  # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    frontend_seq=1500,  # post-conv mel frames (stub input)
    act="gelu",
    attn_bias=True,
)
