"""jamba2-3b — interleaved Mamba-1 and attention layers
[https://huggingface.co/ai21labs/AI21-Jamba2-3B/blob/main/config.json].

28L d_model=2560, attention at layers 7 and 21 (period 14, offset 7): 20
query heads of 128 on 1 kv head, no positional encoding, full causal mask;
the other 26 are Mamba-1 (d_state 16, d_conv 4 with bias, expand 2,
dt_rank 160, RMSNorms on dt, B and C).  Every layer has a SwiGLU MLP of
8192 (num_experts 1: no expert layers).  vocab=65536, tied embeddings.
Port-only: the JAX package has no interleaved family.
"""
from repro_torch.configs.base import InterleavedConfig, register

CONFIG = register(
    InterleavedConfig(
        name="jamba2-3b",
        family="interleaved",
        num_layers=28,
        d_model=2560,
        num_heads=20,
        num_kv_heads=1,
        head_dim=128,
        d_ff=8192,
        vocab_size=65536,
        tie_embeddings=True,
        rope_theta=0.0,
        norm_eps=1e-6,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        ssm_dt_rank=160,
        attn_layer_period=14,
        attn_layer_offset=7,
        grad_accum=8,
    ),
    port_only=True,
)
