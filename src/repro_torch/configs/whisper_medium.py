"""whisper-medium — encoder-decoder, conv frontend stubbed [arXiv:2212.04356].

24L (decoder) + 24L encoder, d_model=1024 16H d_ff=4096 vocab=51865.
The conv frontend is a stub, as in the JAX package: the model consumes
precomputed frame embeddings [B, source_len, d_model] (the launchers make
them).  Real Whisper decodes at most 448 tokens (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-medium",
        family="encdec",
        num_layers=24,
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        tie_embeddings=True,   # whisper ties the output head to the embedding
        source_len=1500,
        rope_theta=0.0,      # learned/sinusoidal positions, no RoPE
        grad_accum=2,
    )
)
