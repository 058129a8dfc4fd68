"""llava-next-mistral-7b — VLM, anyres tiling stubbed [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone: Mistral-7B-like, 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000.  The anyres vision frontend is a stub, as in the JAX package:
the model takes precomputed patch embeddings [B, num_patches, d_model] (the
launchers make them) and prepends their ``mm_proj`` projection to the token
embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        num_patches=576,
        rope_theta=1e6,
        grad_accum=4,
    )
)
