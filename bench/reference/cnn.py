"""CosmoFlow's regressor in plain PyTorch, float32 (Mathuriya et al. 2018,
arXiv:1808.04728, as the configuration file sizes it).

``depth`` stride-2 3x3x3 convolutions, channels ``base_channels * 2^i``,
each with a bias and LeakyReLU(0.01), padded as XLA's "SAME" pads a
stride-2 convolution of an even axis (none before, one after); the last
activation flattened in (D, H, W, C) order; a head of 128 LeakyReLU units
and ``output_shape`` outputs.  The loss is the mean squared error of each
row against its target, averaged over the rows.  Inputs are channels-last
``[B, D, H, W, C]``; the weights come in the layout of
``bench/traffic/weights.py`` (convolutions ``[out, in, 3, 3, 3]``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import Rounding

__all__ = ["predict", "targets", "loss_sum"]


def _same_pads(n: int) -> tuple[int, int]:
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def predict(params: dict, x: torch.Tensor, model: dict, rnd: Rounding | None = None):
    rnd = rnd or Rounding()
    h = x.permute(0, 4, 1, 2, 3)
    for i in range(model["depth"]):
        pads = []
        for n in reversed(h.shape[2:]):
            pads.extend(_same_pads(n))
        h = F.conv3d(rnd(F.pad(h, pads)), rnd(params[f"enc.{i}.w"]), params[f"enc.{i}.b"],
                     stride=2)
        h = F.leaky_relu(rnd._result(h), 0.01)
    flat = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
    z = F.leaky_relu(rnd.mm(flat, params["head.w1"]) + params["head.b1"], 0.01)
    return rnd.mm(z, params["head.w2"]) + params["head.b2"]


def targets(x: torch.Tensor, model: dict) -> torch.Tensor:
    """Each row's target: the mean of its input (in float64), repeated over
    the outputs."""
    mean = x.reshape(x.shape[0], -1).double().mean(1).float()
    return mean[:, None].expand(x.shape[0], model["output_shape"][0])


def loss_sum(params: dict, x: torch.Tensor, model: dict, rnd: Rounding | None = None):
    """Σ over the rows of each row's mean squared error."""
    pred = predict(params, x, model, rnd)
    return (pred - targets(x, model)).square().mean(1).sum()
