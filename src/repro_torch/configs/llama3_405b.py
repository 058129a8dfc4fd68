"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783; unverified].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
The same numbers as the JAX package's config, which sizes it for a
multi-chip mesh: heavy gradient accumulation, remat with a two-level scan,
bf16 optimizer states.  On one card the port runs it only at ``reduced()``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=5e5,
        opt_state_dtype="bfloat16",
        grad_accum_dtype="bfloat16",
        grad_accum=16,      # microbatch = 1 seq/device at 256 global batch
        scan_block=14,      # two-level scan: (9 + 14) residuals vs 126
        ce_chunk=256,
    )
)
