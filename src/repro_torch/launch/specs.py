"""Meta-tensor input stand-ins for every (arch x shape) dry-run cell.

The port of ``repro.launch.specs``: where JAX returns ``ShapeDtypeStruct``\\s
these return tensors on the ``meta`` device, with the same shapes and
dtypes, allocating nothing.  The VLM/audio frontends are stubs, as there:
their specs are precomputed patch/frame embeddings.  One departure: a decode
cache's ``pos`` is a Python int (the port's caches count positions on the
host), where JAX's is an int32 scalar.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.models.lm import CacheSpec

__all__ = ["train_specs", "prefill_specs", "decode_specs", "state_specs",
           "cell_applicability"]

META = torch.device("meta")


def _sds(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device=META)


def cell_applicability(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """None if the cell runs; otherwise the skip reason (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: 500k decode is quadratic — skipped"
    return None


def train_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {
        "labels": _sds((b, s if cfg.family != "vlm" else s - cfg.num_patches), "int32"),
        "weights": _sds((b,), "float32"),
    }
    specs.update(prefill_specs(cfg, shape))
    return specs


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if cfg.family == "vlm":
        # backbone sequence = patches + text; honor the assigned seq_len.
        specs["tokens"] = _sds((b, s - cfg.num_patches), "int32")
        specs["patches"] = _sds((b, cfg.num_patches, cfg.d_model), cfg.compute_dtype)
    elif cfg.family == "encdec":
        specs["tokens"] = _sds((b, s), "int32")
        specs["source"] = _sds((b, cfg.source_len, cfg.d_model), cfg.compute_dtype)
    else:
        specs["tokens"] = _sds((b, s), "int32")
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, *, model_axis: int, plan=None):
    """(cache specs, token spec, CacheSpec) for one decode step with a
    seq_len-deep cache (a model rank's, with a split ``plan``: its kv heads,
    or its block of the slots, and its channels)."""
    b, s = shape.global_batch, shape.seq_len
    spec = CacheSpec.build(cfg, s, model_axis)
    if cfg.family == "encdec":
        cache = _encdec_cache(cfg, spec, b, plan)
    else:
        cache = lm.init_cache(cfg, spec, b, device=META, plan=plan)
    return cache, _sds((b,), "int32"), spec


def _encdec_cache(cfg: ModelConfig, spec: CacheSpec, b: int, plan=None) -> dict:
    """The layout ``encdec.prefill`` builds (a split ``plan``'s rank's kv
    heads)."""
    hd = cfg.resolved_head_dim
    kh = encdec._kv_heads(cfg, lm._part(plan, "attention"))
    shape = (cfg.num_layers, b, kh, spec.cache_len, hd)
    cross = (cfg.num_layers, b, kh, cfg.source_len, hd)
    return {"pos": 0, "k": _sds(shape, cfg.compute_dtype), "v": _sds(shape, cfg.compute_dtype),
            "ck": _sds(cross, cfg.compute_dtype), "cv": _sds(cross, cfg.compute_dtype)}


def state_specs(cfg: ModelConfig, opt_cfg, *, mesh=None):
    """The full train state (flat params + AdamW moments) on meta tensors;
    on ``mesh`` as DTensors in ``param_sharding``'s layout, each holding its
    meta local shard."""
    from repro_torch.train.step import init_train_state

    init = encdec.init_encdec if cfg.family == "encdec" else lm.init_lm
    params = lm.flat_params(init(cfg, device=META))
    return init_train_state(params, opt_cfg, mesh=mesh)
