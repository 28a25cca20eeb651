"""Assigned architecture config: qwen2-moe-a2-7b."""

from repro_torch.configs.base import ArchConfig

# [moe] 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]
CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,  # per-expert ffn dim (fine-grained experts)
    vocab_size=151_936,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
)
