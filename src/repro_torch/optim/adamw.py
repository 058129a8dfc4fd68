"""AdamW with dtype-configurable moments, global-norm clipping and a cosine
schedule.

Port of ``repro.optim.adamw``, line by line.  Parameters, gradients and
moments are flat dicts of tensors with the same keys.  The step counts from
1; the clip scale is ``min(1, clip / max(gnorm, 1e-9))``; weight decay is
decoupled and sits inside the learning rate, ``p - lr·(m̂/(√v̂ + eps) +
wd·p)``, on every leaf; moments are stored in ``state_dtype`` and the update
math runs in f32 (cast in, cast out).  The step counter, learning rate and
norm stay tensors on the parameters' device, so an update makes no host
round trip.  ``torch.optim.AdamW`` with ``clip_grad_norm_`` is not the same
update: that clip divides by ``norm + 1e-6`` and has no schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "apply_updates",
           "cosine_schedule", "global_norm"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """A JAX dtype name (``"float32"``, ``"bfloat16"``) as a torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"


class OptState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor  # int32 scalar on the parameters' device


def init_opt_state(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> OptState:
    dt = torch_dtype(cfg.state_dtype)
    device = next(iter(params.values())).device
    return OptState(
        mu={k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree.values())
    )


def apply_updates(params, grads, state: OptState, cfg: AdamWConfig, *, gnorm=None):
    """One AdamW step.  Returns (new_params, new_state, metrics).  ``gnorm``
    is the global gradient norm when the caller computes it (a sharded step
    passes its shards here and sums their squares over the mesh)."""
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
             if cfg.clip_norm > 0 else torch.ones((), device=gnorm.device))
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    sdt = torch_dtype(cfg.state_dtype)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2;
        # p -= lr (m_hat / (sqrt(v_hat) + eps) + wd p): the same operations,
        # each rounded once, run in place on temporaries of this step, so a
        # leaf holds at most three f32 temporaries beside the old and the new
        # state (a step keeps both).
        g = grads[k].to(torch.float32) * scale
        m32 = state.mu[k].to(torch.float32) * cfg.b1
        m32.add_(g * (1 - cfg.b1))
        v32 = state.nu[k].to(torch.float32) * cfg.b2
        v32.add_(g.square_().mul_(1 - cfg.b2))
        del g
        upd = m32 / b1c
        vhat = v32 / b2c
        upd.div_(vhat.sqrt_().add_(cfg.eps))
        del vhat
        p32 = p.to(torch.float32)
        upd.add_(p32 * cfg.weight_decay).mul_(lr)
        new_p[k], new_m[k], new_v[k] = (p32 - upd).to(p.dtype), m32.to(sdt), v32.to(sdt)
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gnorm, "lr": lr}
