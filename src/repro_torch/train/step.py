"""The training step: gradient accumulation, AdamW, optional compression.

Port of ``repro.train.step``.  Gradient accumulation runs over ``grad_accum``
microbatches and accumulates *sum* gradients, in ``grad_accum_dtype``, so
the final update equals the full-batch gradient of the weighted loss:

    g = (Σ_mb Σ_i w_i ∇nll_i) / (Σ_mb Σ_i w_i)

which is exactly the paper's Eq. (3) invariance — SOLAR's uneven per-node
batches (zero-weight padding rows) produce the same update as the vanilla
assignment.  The train state is ``{"params": {name: tensor}, "opt":
OptState, ["ef": {name: tensor}]}``, functional like the JAX package's: a
step returns a new state and leaves the old one as it was.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import compression
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_opt_state, torch_dtype

__all__ = ["init_train_state", "make_train_step"]


def init_train_state(params, opt_cfg: AdamWConfig, *, error_feedback: bool = False):
    params = dict(params)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    if error_feedback:
        state["ef"] = compression.init_error_feedback(params)
    return state


def make_train_step(cfg, opt_cfg: AdamWConfig, loss_fn: Callable, *,
                    compress_grads: bool = False):
    """loss_fn(params, microbatch) -> (mean_loss, metrics with 'tokens').

    ``cfg`` carries ``grad_accum`` and ``grad_accum_dtype`` (a
    ``ModelConfig`` or any object with those two fields).  Returns
    step(state, batch) -> (state, metrics).  Batch leaves are
    ``[B_global, ...]`` tensors; B_global must divide by ``cfg.grad_accum``.
    """
    accum = max(cfg.grad_accum, 1)
    adt = torch_dtype(cfg.grad_accum_dtype)

    def step(state, batch):
        params = state["params"]
        names = list(params)
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        device = params[names[0]].device
        for k, x in batch.items():
            if x.shape[0] % accum:
                raise ValueError(
                    f"batch leaf {k!r} has {x.shape[0]} rows, not a multiple "
                    f"of grad_accum={accum}")

        gacc = {k: torch.zeros(p.shape, dtype=adt, device=device)
                for k, p in params.items()}
        denom = torch.zeros((), dtype=torch.float32, device=device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(accum):
            mb = {k: x.reshape((accum, x.shape[0] // accum) + x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, metrics = loss_fn(leaves, mb)
            tokens = metrics.get("tokens")
            if tokens is None:
                tokens = torch.ones((), dtype=torch.float32, device=device)
            tokens = tokens.detach()
            lsum = loss * tokens
            g = torch.autograd.grad(lsum, [leaves[k] for k in names])
            for k, gk in zip(names, g):
                gacc[k] = gacc[k] + gk.to(adt)
            denom = denom + tokens
            loss_sum = loss_sum + lsum.detach()

        grads = {k: (g.to(torch.float32) / torch.clamp_min(denom, 1.0)).to(g.dtype)
                 for k, g in gacc.items()}
        new_state = dict(state)
        if compress_grads:
            grads, new_state["ef"] = compression.apply_error_feedback(grads, state["ef"])

        with torch.no_grad():
            new_params, new_opt, om = apply_updates(params, grads, state["opt"], opt_cfg)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        metrics = {
            "loss": loss_sum / torch.clamp_min(denom, 1.0),
            "tokens": denom,
            **om,
        }
        return new_state, metrics

    return step
