"""hymba-1.5b — hybrid parallel attention+Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention (Hymba uses SWA in all but three layers); the SSM
branch runs in parallel with attention in every layer and the branch outputs
are mean-fused after per-branch normalization.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_expand=2,
        sliding_window=1024,
        rope_theta=1e4,
        grad_accum=8,
    )
)
