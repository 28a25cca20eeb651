"""Assigned architecture config: dbrx-132b."""

from repro_torch.configs.base import ArchConfig

# [moe] 16 experts top-4, fine-grained [hf:databricks/dbrx-base]
CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    num_experts=16,
    num_experts_per_tok=4,
    rope_theta=500_000.0,
)
