"""The reference, put where the port's training step was: the checked
steps again, from the seed's weights and data, in plain PyTorch.

Imports nothing of the port.  ``precision`` None is the reference
(float32, TF32 off); a precision name rounds every product to it (the
control).  ``half`` trains each step on the first half of its rows and
takes the mean over them (a planted fault)."""
from __future__ import annotations

import numpy as np
import torch

from bench import kinds
from bench.reference.common import AdamW, Rounding, exact_f32, leaf_norms
from bench.traffic import generator, weights

__all__ = ["follow"]


def follow(config: dict, mix: dict, seed: int, device, step_ids: list,
           precision: str | None = None, half: bool = False,
           full: tuple = ("grad", "update")) -> dict:
    """Train the steps whose global batches are ``step_ids`` (sample ids per
    step).  Returns ``{"loss": [per step], "grad": {leaf: the first
    gradient's norm, as the optimizer takes it}, "grad_norm": its global
    norm, "update": {leaf: |p_K - p_0|}}`` and, on the host,
    ``<name>_full`` for each name in ``full``: those tensors themselves."""
    kind = kinds.get(config["kind"])
    rnd = Rounding(precision)
    with exact_f32():
        data = generator.data(config, mix, seed, device)
        w0 = weights.make(config, seed, device)
        params = {k: v.to(torch.float32, copy=True).requires_grad_(True)
                  for k, v in w0.items()}
        adam = AdamW({k: p.detach() for k, p in params.items()}, config["optimizer"],
                     {k: v.dtype for k, v in w0.items()})
        out = {"loss": []}
        for j, ids in enumerate(step_ids):
            rows = data[torch.as_tensor(np.asarray(ids), device=device)]
            if half:
                rows = rows[: rows.shape[0] // 2]
            loss, grads = kind.reference_step(params, rows, config, mix, rnd)
            grads = {k: (g if g is not None else torch.zeros_like(params[k])).detach()
                     for k, g in grads.items()}
            if j == 0:
                out["grad"] = leaf_norms(grads)
                if "grad" in full:
                    out["grad_full"] = {k: g.to("cpu", torch.float32) for k, g in grads.items()}
                out["grad_norm"] = sum(v * v for v in out["grad"].values()) ** 0.5
            adam.update({k: p.detach() for k, p in params.items()}, grads)
            out["loss"].append(loss)
            del grads, rows
        change = {k: params[k].detach() - w0[k].float() for k in params}
        out["update"] = leaf_norms(change)
        if "update" in full:
            out["update_full"] = {k: v.to("cpu") for k, v in change.items()}
    return out
