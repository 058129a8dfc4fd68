"""minitron-8b — pruned Nemotron, 256k vocab [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
        rope_theta=1e4,
        grad_accum=8,
    )
)
