"""falcon-mamba-7b — attention-free Mamba-1 [arXiv:2410.05355; unverified].

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16.  Constant-size recurrent
state: the decode cache is the SSM state and the conv tail, not a KV cache.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=1,
        num_kv_heads=1,
        d_ff=0,
        vocab_size=65024,
        ssm_state=16,
        ssm_expand=2,
        grad_accum=8,   # SSM scan residuals are f32 [B,S,d_inner,N] slabs
    )
)
