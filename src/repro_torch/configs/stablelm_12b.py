"""Assigned architecture config: stablelm-12b."""

from repro_torch.configs.base import ArchConfig

# [dense] [hf:stabilityai/stablelm-2-12b]
CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13_824,
    vocab_size=100_352,
)
