"""Model configuration schema and the architecture registry.

The port's own copy of the JAX package's ``configs/base.py``: the same
fields with the same defaults, so a configuration reads the same on both
sides.  ``reduced()`` gives the CPU-test variant of an architecture (same
family and wiring, tiny dimensions); the four input-shape cells of the dry
run are the ``ShapeConfig`` cells of ``SHAPES``.

``InterleavedConfig`` is the port's own: the settings of a stack whose
layers are of different kinds (Jamba's Mamba and attention layers), which
the JAX package has no field for.  Its configurations register as port-only
(``port_only_configs``): ``get_config`` finds them, ``list_configs`` stays
the JAX package's list.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["ModelConfig", "InterleavedConfig", "ShapeConfig", "SHAPES", "register",
           "get_config", "list_configs", "port_only_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    #: 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    router_aux_coef: float = 0.01
    expert_capacity_factor: float = 1.25

    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0              # 0 -> ceil(d_model / 16)

    # Hybrid (Hymba-style) sliding-window attention; 0 -> full attention
    sliding_window: int = 0

    # Encoder-decoder (Whisper-style)
    encoder_layers: int = 0
    source_len: int = 0

    # VLM stub frontend
    num_patches: int = 0

    # numerics / memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    remat: bool = True
    scan_block: int = 0
    ce_chunk: int = 256
    #: decode KV-cache storage: 'bfloat16' or 'int8' (symmetric per-row scales).
    kv_cache_dtype: str = "bfloat16"
    grad_accum: int = 1

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM state or window cache)"""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.sliding_window > 0
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def num_params(self) -> int:
        """Analytic parameter count (embeddings included once if tied), as
        the JAX package's ``ModelConfig.num_params``."""
        d, hd = self.d_model, self.resolved_head_dim
        h, k = self.num_heads, self.num_kv_heads
        p = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = 0
        if self.family != "ssm":
            attn = d * h * hd + 2 * d * k * hd + h * hd * d
            if self.qkv_bias:
                attn += (h + 2 * k) * hd
        if self.family in ("dense", "vlm", "encdec", "hybrid"):
            mlp = 3 * d * self.d_ff if self.family != "encdec" else 2 * d * self.d_ff
        elif self.family == "moe":
            mlp = (self.num_experts + self.num_shared_experts) * 3 * d * self.d_ff
            mlp += d * self.num_experts  # router
        else:
            mlp = 0
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, n, r = self.ssm_d_inner, self.ssm_state, self.resolved_dt_rank
            ssm = (d * 2 * di + di * self.ssm_conv + di * (r + 2 * n) + r * di + di * n
                   + di + di * d)
        p += self.num_layers * (attn + mlp + ssm + 2 * d)
        if self.family == "encdec":
            cross = d * h * hd + 2 * d * k * hd + h * hd * d
            p += self.encoder_layers * (attn + 2 * d * self.d_ff + 2 * d)
            p += self.num_layers * cross  # decoder cross-attention blocks
        p += d  # final norm
        return int(p)

    def num_active_params(self) -> int:
        """Params touched per token (moe: the top-k and shared experts only),
        as the JAX package's ``ModelConfig.num_active_params``."""
        if self.family != "moe":
            return self.num_params()
        d = self.d_model
        dense_like = self.num_params() - self.num_layers * (
            self.num_experts + self.num_shared_experts) * 3 * d * self.d_ff
        active = self.num_layers * (self.top_k + self.num_shared_experts) * 3 * d * self.d_ff
        return int(dense_like + active)

    def reduced(self) -> "ModelConfig":
        """Same family/wiring, tiny dims — used by the CPU tests."""
        h = min(self.num_heads, 4)
        k = max(1, min(self.num_kv_heads, 2))
        h = max(h, k)
        h = (h // k) * k  # keep GQA divisibility
        return self.replace(
            num_layers=2,
            d_model=64,
            num_heads=h,
            num_kv_heads=k,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            expert_capacity_factor=4.0,
            ssm_state=min(self.ssm_state, 8),
            ssm_dt_rank=4 if self.family in ("ssm", "hybrid") else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            source_len=16 if self.source_len else 0,
            num_patches=8 if self.num_patches else 0,
            param_dtype="float32",
            compute_dtype="float32",
            grad_accum=1,
        )


@dataclasses.dataclass(frozen=True)
class InterleavedConfig(ModelConfig):
    """A decoder whose layers are Mamba-1 mixers or attention, each followed
    by the SwiGLU MLP (``family='interleaved'``; Jamba, arXiv:2403.19887).
    Layer ``i`` is attention when ``i % attn_layer_period ==
    attn_layer_offset`` (transformers' ``JambaConfig.layers_block_type``),
    else Mamba.  The Mamba mixer RMS-normalises dt, B and C after
    ``x_proj``; attention runs without any positional encoding
    (``rope_theta`` is unused)."""

    attn_layer_period: int = 1
    attn_layer_offset: int = 0

    @property
    def layer_kinds(self) -> tuple:
        """'attention' or 'mamba' for each layer, in order."""
        return tuple("attention" if i % self.attn_layer_period == self.attn_layer_offset
                     else "mamba" for i in range(self.num_layers))

    def layer_slot(self, i: int) -> tuple:
        """(kind of layer ``i``, its index among the layers of that kind)."""
        kinds = self.layer_kinds
        return kinds[i], kinds[:i].count(kinds[i])

    def num_params(self) -> int:
        """Every leaf of ``lm.init_lm``: the embedding (tied: once), each
        layer's two norms and MLP, the attention layers' projections, the
        Mamba layers' mixer with its conv bias, dt bias, D and dt/B/C norms,
        and the final norm."""
        d, hd, h, k = self.d_model, self.resolved_head_dim, self.num_heads, self.num_kv_heads
        di, n, r, ck = self.ssm_d_inner, self.ssm_state, self.resolved_dt_rank, self.ssm_conv
        attn = d * h * hd + 2 * d * k * hd + h * hd * d
        mamba = (d * 2 * di + ck * di + di + di * (r + 2 * n) + r * di + di + di * n + di
                 + di * d + r + 2 * n)
        kinds = self.layer_kinds
        p = self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
        p += self.num_layers * (2 * d + 3 * d * self.d_ff)
        p += kinds.count("attention") * attn + kinds.count("mamba") * mamba
        return int(p)

    def reduced(self) -> "InterleavedConfig":
        """Four layers, Mamba, attention, Mamba, attention: an attention
        layer with a Mamba layer on either side, and more than one layer of
        each kind on its stack."""
        return super().reduced().replace(num_layers=4, attn_layer_period=2,
                                         attn_layer_offset=1, ssm_dt_rank=4)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    #: 'train' runs the train step; 'prefill' runs prefill; 'decode' runs one
    #: decode step with a seq_len-deep KV cache.
    kind: str

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(
            self, seq_len=min(self.seq_len, 64), global_batch=min(self.global_batch, 4)
        )


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}
_PORT_ONLY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, *, port_only: bool = False) -> ModelConfig:
    """Register ``cfg`` under its name; ``port_only`` for an architecture
    the JAX package does not have, kept out of ``list_configs``."""
    (_PORT_ONLY if port_only else _REGISTRY)[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (importing the package registers)

    try:
        return _REGISTRY.get(name) or _PORT_ONLY[name]
    except KeyError:
        have = sorted(_REGISTRY) + sorted(_PORT_ONLY)
        raise ValueError(f"unknown arch {name!r}; have {have}") from None


def list_configs() -> list[str]:
    """The architectures both packages register."""
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def port_only_configs() -> list[str]:
    """The architectures only the port registers."""
    import repro_torch.configs  # noqa: F401

    return sorted(_PORT_ONLY)
