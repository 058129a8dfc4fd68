"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) d_ff=1408 (per expert) vocab=151936.
60 routed experts are padded to 64 for expert-parallel sharding over the
16-way model axis (pad experts are masked out of the router; DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        num_experts=60,
        num_shared_experts=4,
        top_k=4,
        rope_theta=1e6,
        grad_accum=2,
    )
)
