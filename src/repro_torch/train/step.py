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

On a mesh (``init_train_state(..., mesh=)``, ``make_train_step(...,
mesh=)``) params and AdamW moments are DTensors in ``param_sharding``'s
layout, the gradient accumulator holds each leaf's local shard, and the
model reads the params through :mod:`repro_torch.distributed.fsdp`'s
gathered view.  Each data rank (a SOLAR node) takes its own block of
the global batch's rows and cuts its ``grad_accum`` microbatches from them;
``Σw`` and the loss sum are all-reduced over the data axes before the
division.  A data rank's microbatch is one microbatch of the global step, so
the sharded step with ``grad_accum`` A over D data ranks computes the
unsharded step with ``grad_accum`` A·D, up to f32 summation order: the
same update as A, by Eq. (3), in every family but moe, whose router aux loss
is a function of each microbatch's tokens.

Where the mesh has a ``model`` axis of more than one rank
(``tensor_parallel.split_plan``: every family, the encoder-decoder too), the
gathered view hands the model each split part's ``model`` blocks and the
plan, and the model ranks compute their own heads, hidden units, experts,
channels and vocabulary.  The loss
is the same on every model rank, so ``Σw`` and the loss sum are still
reduced over the data axes only.

Traced (:mod:`repro_torch.obs.trace`), per microbatch: ``step.forward`` (its
view of the params and the loss), ``step.backward`` (``autograd.grad``) and
``step.accumulate`` (the adds into the accumulator); once a step:
``step.optimizer`` (the division by ``Σw`` and AdamW's update).  They time
the host's dispatch of each phase: the card runs it asynchronously.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import compression, fsdp, tensor_parallel
from repro_torch.distributed.sharding import param_sharding
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates, init_opt_state,
                                     torch_dtype)

__all__ = ["init_train_state", "make_train_step"]


def init_train_state(params, opt_cfg: AdamWConfig, *, error_feedback: bool = False,
                     mesh=None):
    """``{"params", "opt"[, "ef"]}`` from flat params.  On ``mesh`` (a
    ``DeviceMesh``) params and moments are DTensors in ``param_sharding``'s
    layout; the step counter stays a plain tensor."""
    params = dict(params)
    if mesh is None:
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        if error_feedback:
            state["ef"] = compression.init_error_feedback(params)
        return state
    fsdp.check_mesh(mesh)
    if error_feedback:
        raise NotImplementedError("error feedback is not sharded: compress with "
                                  "compression.compressed_psum instead")
    shardings = param_sharding(params, mesh)
    params = {k: fsdp.distribute(p, shardings[k]) for k, p in params.items()}
    sdt = torch_dtype(opt_cfg.state_dtype)
    device = fsdp.local(next(iter(params.values()))).device
    # zeros_like of a DTensor: zeros in its layout, its local shard only
    opt = OptState(mu={k: torch.zeros_like(p, dtype=sdt) for k, p in params.items()},
                   nu={k: torch.zeros_like(p, dtype=sdt) for k, p in params.items()},
                   step=torch.zeros((), dtype=torch.int32, device=device))
    return {"params": params, "opt": opt}


def make_train_step(cfg, opt_cfg: AdamWConfig, loss_fn: Callable, *,
                    compress_grads: bool = False, mesh=None):
    """loss_fn(params, microbatch) -> (mean_loss, metrics with 'tokens').

    ``cfg`` carries ``grad_accum`` and ``grad_accum_dtype`` (a
    ``ModelConfig`` or any object with those two fields).  Returns
    step(state, batch) -> (state, metrics).  Batch leaves are
    ``[B_global, ...]`` tensors; B_global must divide by ``cfg.grad_accum``.

    With ``mesh`` the step is sharded (the state from ``init_train_state(...,
    mesh=mesh)``): every rank passes the same global batch and trains its
    data-parallel block of it, each block dividing by ``grad_accum``, on its
    local shards through ``fsdp.gathered``; the gradients and their
    accumulator are shards in the params' layout.
    """
    accum = max(cfg.grad_accum, 1)
    adt = torch_dtype(cfg.grad_accum_dtype)
    if mesh is not None:
        fsdp.check_mesh(mesh)
        if compress_grads:
            raise NotImplementedError("the sharded step does not compress gradients: "
                                      "compression.compressed_psum is the int8 collective")

    plans = []  # the split plan, read on the first call: cfg, the mesh and
                # the params' global shapes are fixed for the step's lifetime

    def step(state, batch):
        tr = obs_trace.get()
        params = state["params"]
        names = list(params)
        reduce_dims, plan = (), None
        if mesh is not None:
            from torch.distributed.tensor import DTensor

            if not all(isinstance(p, DTensor) for p in params.values()):
                raise TypeError("a sharded step takes the DTensor state of "
                                "init_train_state(..., mesh=)")
            reduce_dims = fsdp.batch_mesh_dims(next(iter(batch.values())).shape[0], mesh)
            batch = fsdp.local_rows(batch, mesh, reduce_dims)
            if not plans:
                plans.append(tensor_parallel.split_plan(cfg, params, mesh))
            plan = plans[0]
        leaves = {k: fsdp.local(p).detach().requires_grad_(True) for k, p in params.items()}
        device = leaves[names[0]].device
        for k, x in batch.items():
            if x.shape[0] % accum:
                raise ValueError(
                    f"batch leaf {k!r} has {x.shape[0]} rows"
                    f"{' on this rank' if mesh is not None else ''}, not a multiple "
                    f"of grad_accum={accum}")

        gacc = {k: torch.zeros(p.shape, dtype=adt, device=device)
                for k, p in leaves.items()}
        denom = torch.zeros((), dtype=torch.float32, device=device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(accum):
            mb = {k: x.reshape((accum, x.shape[0] // accum) + x.shape[1:])[i]
                  for k, x in batch.items()}
            t = tr.t()
            view = leaves if mesh is None else fsdp.gathered(leaves, params, mesh,
                                                             reduce_dims, plan)
            loss, metrics = loss_fn(view, mb)
            tokens = metrics.get("tokens")
            if tokens is None:
                tokens = torch.ones((), dtype=torch.float32, device=device)
            tokens = tokens.detach()
            lsum = loss * tokens
            tr.rec(obs_trace.STEP_FORWARD, t)
            t = tr.t()
            # a leaf the loss does not reach (the ssm family's ln2) gets a
            # zero gradient, as under jax.grad
            g = torch.autograd.grad(lsum, [leaves[k] for k in names], allow_unused=True,
                                    materialize_grads=True)
            tr.rec(obs_trace.STEP_BACKWARD, t)
            t = tr.t()
            for k, gk in zip(names, g):
                gacc[k].add_(gk.to(adt))
            tr.rec(obs_trace.STEP_ACCUMULATE, t)
            del g, view  # one set of gradients alive at a time, beside the accumulator
            denom = denom + tokens
            loss_sum = loss_sum + lsum.detach()
        if mesh is not None:
            # Σw and the loss over every data rank's rows, before the division
            denom, loss_sum = fsdp.all_reduce(torch.stack([denom, loss_sum]), mesh,
                                              reduce_dims).unbind()

        t = tr.t()
        # an f32 accumulator is divided in place: the same values, without a
        # second copy of every gradient
        scale = torch.clamp_min(denom, 1.0)
        grads = {k: g.div_(scale) if g.dtype == torch.float32
                 else (g.to(torch.float32) / scale).to(g.dtype) for k, g in gacc.items()}
        new_state = dict(state)
        if compress_grads:
            grads, new_state["ef"] = compression.apply_error_feedback(grads, state["ef"])

        opt = state["opt"]
        gnorm = None if mesh is None else fsdp.global_norm(grads, params, mesh)
        with torch.no_grad():
            new_params, new_opt, om = apply_updates(
                {k: fsdp.local(p) for k, p in params.items()}, grads,
                OptState({k: fsdp.local(v) for k, v in opt.mu.items()},
                         {k: fsdp.local(v) for k, v in opt.nu.items()},
                         fsdp.local(opt.step)),
                opt_cfg, gnorm=gnorm)
        if mesh is not None:
            new_params = fsdp.wrap_like(new_params, params)
            new_opt = OptState(fsdp.wrap_like(new_opt.mu, opt.mu),
                               fsdp.wrap_like(new_opt.nu, opt.nu), new_opt.step)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        tr.rec(obs_trace.STEP_OPTIMIZER, t)
        metrics = {"loss": loss_sum / scale, "tokens": denom, **om}
        return new_state, metrics

    return step
