"""The paper's CNN surrogates in PyTorch: PtychoNN, AutoPhaseNN, CosmoFlow.

Port of ``repro.models.cnn``.  These are the models whose *training* SOLAR
accelerates (paper §3, §5): small conv stacks whose compute is negligible
next to data loading.

  * PtychoNN    — 2D conv autoencoder: 64×64 diffraction frame → amplitude +
    phase (2 output channels).
  * AutoPhaseNN — the same topology in 3D for BCDI volumes.
  * CosmoFlow   — 3D conv regressor → 4 cosmological parameters.

Parameters are a flat dict keyed like the module's ``named_parameters``
(``enc.0.w``, ``dec.1.b``, ``head.w1``); :mod:`repro_torch.convert` maps each
to the JAX pytree leaf of the same path.  Convolution weights are in
PyTorch's layout: ``[out, in, k, k(, k)]`` for the encoder, and for the
decoder's transposed convolutions ``[in, out, k, k(, k)]``, spatially flipped
against the JAX kernel.  Inputs and outputs keep the JAX package's
channels-last layout (NHWC / NDHWC) at the public functions.

What the JAX package's ``"SAME"`` convolutions become here:
  * a stride-2 convolution pads each spatial axis by the JAX rule, ``total =
    max((ceil(n/s) - 1)·s + k - n, 0)``, ``total // 2`` before and the rest
    after — (0, 1) for k=3, s=2 at even n, not PyTorch's symmetric
    ``padding=1`` — and then runs with no padding;
  * ``lax.conv_transpose(..., "SAME")`` does not flip its kernel, so it is
    ``conv_transpose`` with the flipped kernel (flipped once, in
    :mod:`repro_torch.convert` and at init), no padding, cropped to the first
    ``s·n`` outputs of each axis;
  * CosmoFlow's head flattens the NDHWC activation, so the features are
    permuted back to channels-last before the flatten.
The convolutions themselves are ``F.conv{2,3}d`` and
``F.conv_transpose{2,3}d``, as the JAX package leaves them to XLA, outside any
Pallas kernel.  One gradient is a hand-written kernel: a float32 3D
convolution of 1, 4 or 8 input channels (``conv_wgrad.routes``: the stem of
AutoPhaseNN and CosmoFlow) is a ``torch.autograd.Function`` whose forward is
``F.conv3d`` and whose weight and bias gradients are
``kernels/csrc/conv3d_stem_wgrad.cu`` on the card (its plain version on the
CPU), traced as ``conv.stem_wgrad``; an input that needs a gradient keeps
cuDNN's.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.surrogates import SurrogateConfig
from repro_torch.kernels import conv_wgrad, ops
from repro_torch.obs import trace as obs_trace

__all__ = ["Surrogate", "init_surrogate", "surrogate_apply", "surrogate_loss",
           "same_pads", "conv_pads", "stem_layers"]

_STRIDE = 2
_KSIZE = 3


def same_pads(n: int, stride: int = _STRIDE, ksize: int = _KSIZE) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding ``(before, after)`` of one spatial axis."""
    total = max((math.ceil(n / stride) - 1) * stride + ksize - n, 0)
    return total // 2, total - total // 2


class _StemConv(torch.autograd.Function):
    """A stride-2 3D convolution whose weight and bias gradients are the
    stem kernel's (``ops.conv3d_stem_wgrad``); the forward and an input's
    gradient are cuDNN's."""

    @staticmethod
    def forward(ctx, x, w, b, pads):
        ctx.save_for_backward(x, w)
        ctx.pads = pads
        return F.conv3d(F.pad(x, pads), w, b, stride=_STRIDE)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:  # cuDNN's gradient of the padded input, cropped
            before, after = ctx.pads[4::-2], ctx.pads[5::-2]  # (d, h, w)
            spatial = x.shape[2:]
            padded = x.shape[:2] + tuple(n + a + b for n, a, b in zip(spatial, before, after))
            dx = torch.nn.grad.conv3d_input(padded, w, dy, stride=_STRIDE)
            dx = dx[(Ellipsis,) + tuple(slice(a, a + n) for n, a in zip(spatial, before))]
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            tr = obs_trace.get()
            t = tr.t()
            cl = torch.channels_last_3d
            dw, db = ops.conv3d_stem_wgrad(x.contiguous(memory_format=cl),
                                           dy.contiguous(memory_format=cl), ctx.pads)
            tr.rec(obs_trace.CONV_STEM_WGRAD, t, a=dy.numel() // dy.shape[1],
                   b=27 * x.shape[1])
        return dx, dw, db, None


def conv_pads(spatial) -> tuple[int, ...]:
    """``F.pad``'s pads of a stride-2 ``"SAME"`` convolution over the axes
    ``spatial`` (F.pad lists the last axis first)."""
    pads: list[int] = []
    for n in reversed(spatial):
        pads.extend(same_pads(n))
    return tuple(pads)


def _conv(x, w, b, rank: int):
    """Stride-2 ``"SAME"`` convolution of a channels-first ``x``."""
    pads = conv_pads(x.shape[2:])
    if conv_wgrad.routes(rank, x.shape[1], w.shape[0], x.dtype):
        return _StemConv.apply(x, w, b, pads)
    conv = F.conv2d if rank == 2 else F.conv3d
    return conv(F.pad(x, pads), w, b, stride=_STRIDE)


def _conv_transpose(x, w, b, rank: int):
    """``lax.conv_transpose(..., strides=2, padding="SAME")`` of a
    channels-first ``x``; ``w`` is already flipped and ``[in, out, ...]``."""
    convt = F.conv_transpose2d if rank == 2 else F.conv_transpose3d
    y = convt(x, w, b, stride=_STRIDE)
    crop = tuple(slice(0, _STRIDE * n) for n in x.shape[2:])
    return y[(Ellipsis,) + crop]


def _channels_first(x, rank: int):
    return x.permute(0, rank + 1, *range(1, rank + 1))


def _channels_last(x, rank: int):
    return x.permute(0, *range(2, rank + 2), 1)


def _flatten(h, rank: int):
    """CosmoFlow's head input: the activation flattened in NDHWC order."""
    return _channels_last(h, rank).reshape(h.shape[0], -1)


def _layer_channels(cfg: SurrogateConfig) -> tuple[list, list]:
    """``(cin, cout)`` of each encoder and each decoder layer, as
    ``repro.models.cnn.init_surrogate`` builds them."""
    enc, dec = [], []
    c = cfg.input_shape[-1]
    for i in range(cfg.depth):
        cout = cfg.base_channels * (2**i)
        enc.append((c, cout))
        c = cout
    if cfg.kind in ("ptychonn", "autophasenn"):
        for i in range(cfg.depth):
            cout = (cfg.base_channels * (2 ** (cfg.depth - 2 - i))
                    if i < cfg.depth - 1 else cfg.output_shape[-1])
            dec.append((c, cout))
            c = cout
    return enc, dec


def stem_layers(cfg: SurrogateConfig) -> list[str]:
    """The encoder layers whose weight gradient is the stem kernel's."""
    rank = len(cfg.input_shape) - 1
    enc, _ = _layer_channels(cfg)
    return [f"enc.{i}" for i, (cin, cout) in enumerate(enc)
            if conv_wgrad.routes(rank, cin, cout, torch.float32)]


class _Conv(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class _Head(nn.Module):
    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.w2, self.b2 = nn.Parameter(w2), nn.Parameter(b2)


class Surrogate(nn.Module):
    """One of the three surrogates, its parameters drawn from ``generator``
    with the JAX init's shapes and scales: a normal draw divided by
    √fan_in, zero biases; CosmoFlow's head is ``w1 [flat, 128]``,
    ``w2 [128, out]``.  ``named_parameters`` gives the flat names
    :func:`surrogate_apply` takes."""

    def __init__(self, cfg: SurrogateConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        if cfg.kind not in ("ptychonn", "autophasenn", "cosmoflow"):
            raise ValueError(f"unknown surrogate kind {cfg.kind!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        rank = len(cfg.input_shape) - 1
        kdims = (_KSIZE,) * rank

        def normal(shape, fan_in):
            w = torch.randn(shape, generator=generator, dtype=torch.float32)
            return (w / math.sqrt(fan_in)).to(device)

        def zeros(n):
            return torch.zeros(n, dtype=torch.float32, device=device)

        enc, dec = _layer_channels(cfg)
        fan = _KSIZE**rank
        self.enc = nn.ModuleList(
            _Conv(normal((co, ci) + kdims, ci * fan), zeros(co)) for ci, co in enc)
        self.dec = nn.ModuleList(
            _Conv(normal((ci, co) + kdims, ci * fan), zeros(co)) for ci, co in dec)
        self.head = None
        if cfg.kind == "cosmoflow":
            spatial = cfg.input_shape[0] // (2**cfg.depth)
            flat = enc[-1][1] * spatial**rank
            out = cfg.output_shape[0]
            self.head = _Head(normal((flat, 128), flat), zeros(128),
                              normal((128, out), 128.0), zeros(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return surrogate_apply(dict(self.named_parameters()), x, self.cfg)


def init_surrogate(cfg: SurrogateConfig, *, generator: torch.Generator | None = None,
                   device=None) -> dict[str, torch.Tensor]:
    """A fresh :class:`Surrogate`'s parameters as a flat dict of tensors."""
    model = Surrogate(cfg, generator=generator, device=device)
    return {k: v.detach() for k, v in model.named_parameters()}


def surrogate_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                    cfg: SurrogateConfig) -> torch.Tensor:
    """``x`` channels-last ``[B, *spatial, C]`` -> the prediction, channels-last
    for the autoencoders and ``[B, out]`` for CosmoFlow."""
    rank = len(cfg.input_shape) - 1
    enc, dec = _layer_channels(cfg)
    h = _channels_first(x, rank)
    for i in range(len(enc)):
        h = F.leaky_relu(_conv(h, params[f"enc.{i}.w"], params[f"enc.{i}.b"], rank))
    if cfg.kind in ("ptychonn", "autophasenn"):
        for i in range(len(dec)):
            h = _conv_transpose(h, params[f"dec.{i}.w"], params[f"dec.{i}.b"], rank)
            if i < len(dec) - 1:
                h = F.leaky_relu(h)
        return _channels_last(h, rank)
    z = F.leaky_relu(_flatten(h, rank) @ params["head.w1"] + params["head.b1"])
    return z @ params["head.w2"] + params["head.b2"]


def surrogate_loss(params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
                   cfg: SurrogateConfig):
    """Weighted MSE.  batch: x [B, ...], y [B, ...], weights [B].  The sum
    is divided by ``max(Σw, 1)``, so zero-weight padding rows change
    nothing."""
    pred = surrogate_apply(params, batch["x"], cfg)
    w = batch.get("weights")
    if w is None:
        w = torch.ones(batch["x"].shape[0], dtype=torch.float32, device=pred.device)
    per = torch.mean(torch.square(pred - batch["y"]), dim=tuple(range(1, pred.ndim)))
    denom = torch.sum(w)
    loss = torch.sum(per * w) / torch.clamp_min(denom, 1.0)
    return loss, {"loss": loss, "tokens": denom}
