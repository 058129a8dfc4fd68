"""Batched serving engine: prefill + decode loop over the KV cache.

The static-batch engine of the JAX package's ``serve/engine.py``: the
decoder-only dense, moe, ssm and hybrid families through ``models/lm.py``,
the encoder-decoder through ``models/encdec.py`` (``generate(...,
source=)``).  Like the JAX engine it takes no patch embeddings, so it
refuses the vlm family: serve that through ``lm.prefill(..., patches=)`` and
``lm.decode_step`` (a model rank's: on ``tensor_parallel.local_view``
params).  ``generate_from_tier`` feeds prompts from the
multi-tenant data tier (:mod:`repro_torch.serve.datatier`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel
from repro_torch.models import encdec, lm
from repro_torch.models.lm import CacheSpec

__all__ = ["ServeEngine"]


class ServeEngine:
    """``attn_impl`` and ``ssm_impl`` select the prefill attention and
    selective scan, ``norm_impl`` every RMSNorm of prefill and decode
    ('pallas' is the hand-written CUDA kernel; the default 'auto' takes it
    for CUDA inputs and raises where it refuses one).  The encoder-decoder
    has no RMSNorm and no scan.  ``device`` defaults to the card and raises
    without one; pass ``device='cpu'`` to run on the CPU.  ``model_axis``
    is the model-parallel width the cache is laid out for
    (``CacheSpec.build``: kv heads repeated to divide it).

    On a ``mesh`` (a ``DeviceMesh`` with a ``model`` axis; every rank
    builds its engine from the same whole ``params``) the engine is a model
    rank's: it keeps the rank's block of each part that splits
    (``tensor_parallel.local_view``: the moe family's experts and the
    encoder-decoder's heads and GELU hidden too), its cache the rank's kv
    heads (or, where they do not split, its block of the slots:
    ``tensor_parallel.cache_block``) and channels, ``model_axis`` is the
    mesh's, and every rank must call
    ``prefill`` and ``step`` alike (their all-reduces pair up).  The logits
    are the whole vocabulary's on every rank."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int,
                 model_axis: int = 1, attn_impl: str = "auto", ssm_impl: str = "auto",
                 norm_impl: str = "auto", device=None, mesh=None):
        if cfg.family == "vlm":
            raise NotImplementedError(
                "the engine takes no patch embeddings, as the JAX package's does not: "
                "serve the vlm family through lm.prefill(..., patches=) and "
                "lm.decode_step")
        self.device = resolve_device(device)
        self.cfg = cfg
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names)
            model_axis = mesh.size(names.index("model")) if "model" in names else 1
            params = tensor_parallel.local_view(
                params, tensor_parallel.split_plan(cfg, lm.flat_params(params), mesh))
        self.spec = CacheSpec.build(cfg, max_len, model_axis)
        self.attn_impl = attn_impl
        self.ssm_impl = ssm_impl
        self.norm_impl = norm_impl
        self.params = _to_device(params, self.device)

    @torch.inference_mode()
    def prefill(self, prompts, source=None):
        """prompts [B, S] (the encoder-decoder: and ``source [B, T, D]``
        frame embeddings) -> (f32 logits [B, V] at the last position,
        cache)."""
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                 device=self.device)
        if self.cfg.family == "encdec":
            if source is None:
                raise ValueError("the encoder-decoder needs source= frame embeddings")
            source = torch.as_tensor(np.asarray(source), device=self.device)
            return encdec.prefill(self.params, tokens, source, self.cfg, self.spec,
                                  attn_impl=self.attn_impl)
        return lm.prefill(self.params, tokens, self.cfg, self.spec,
                          attn_impl=self.attn_impl, ssm_impl=self.ssm_impl,
                          norm_impl=self.norm_impl)

    @torch.inference_mode()
    def step(self, cache, tokens):
        """One decode step for tokens [B] on the device; updates ``cache``."""
        if self.cfg.family == "encdec":
            return encdec.decode_step(self.params, cache, tokens, self.cfg, self.spec)
        return lm.decode_step(self.params, cache, tokens, self.cfg, self.spec,
                              norm_impl=self.norm_impl)

    @torch.inference_mode()
    def generate(self, prompts, num_tokens: int, *, source=None, greedy: bool = True,
                 generator: torch.Generator | None = None) -> np.ndarray:
        """prompts [B, S_prompt] int -> generated tokens [B, num_tokens];
        the encoder-decoder takes ``source [B, T, D]`` too.

        Sampling (``greedy=False``) draws from softmax(logits) with
        ``generator`` (a ``torch.Generator`` on the engine's device; seeded
        with 0 when omitted)."""
        if not greedy and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        logits, cache = self.prefill(prompts, source)
        tok = torch.argmax(logits, dim=-1)
        out = []
        for _ in range(num_tokens):
            out.append(tok)
            logits, cache = self.step(cache, tok)
            if greedy:
                tok = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    def generate_from_tier(self, client, sample_ids, num_tokens: int, *,
                           prompt_len: int, greedy: bool = True, rng=None):
        """Pull ``sample_ids`` through a data-tier client and generate.

        ``client`` is a :class:`~repro_torch.serve.datatier.DataTierClient`.
        Rows are mapped to prompts on the host
        (:func:`~repro_torch.serve.datatier.rows_to_prompts`) and generated
        on the engine's device.  Rows the tier cannot serve are dropped from
        the batch; returns ``(tokens, served_mask)`` so callers can retry or
        backfill the unserved ids.  Raises when the tier serves nothing at
        all.  ``rng`` is the sampling ``torch.Generator`` (``generate``'s
        ``generator``).
        """
        from repro_torch.serve.datatier import rows_to_prompts

        ids = np.asarray(sample_ids, np.int64)
        rows, ok = client.read(ids)
        if not ok.any():
            raise RuntimeError(
                f"data tier served none of the {ids.size} requested samples"
            )
        prompts = rows_to_prompts(rows[ok], prompt_len, self.cfg.vocab_size)
        return self.generate(prompts, num_tokens, greedy=greedy,
                             generator=rng), ok


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree  # a split plan
