"""CNN surrogates (``configs/<name>.json`` with ``"kind": "surrogate"``),
trained through the port's ``launch/train_surrogate.py``.  The weights are
float32, stride-2 3x3x3 convolutions then a two-layer head, drawn normal
over sqrt(fan-in) with zero biases; the store's samples are standard
normal floats of the input shape."""
from __future__ import annotations

import argparse
import math

import torch

from bench.counts.models import cnn_train_flops
from bench.reference import cnn

RATE = ("samples_per_s", "samples/s")
#: a row's work units for the rate: one sample
UNIT_NAME = "samples"
DTYPE_KEYS = ()
CONTROL_ROWS = None
PROGRAM_LOSS = ("repro_torch.models.cnn", "surrogate_loss")


def units_per_row(config: dict, mix: dict) -> int:
    return 1


def model_flops_per_row(config: dict, mix: dict) -> float:
    return cnn_train_flops(config["model"], 1)


def program(config: dict, device):
    """(the port's config, its AdamW config, its training step).  A
    configuration that states ``"allow_tf32": false`` runs the products in
    float32: PyTorch's TF32 switches (process-wide; the port sets none of
    its own) are turned off for it."""
    from repro_torch.configs.surrogates import SurrogateConfig
    from repro_torch.launch import train_surrogate

    if "allow_tf32" in config:
        torch.backends.cudnn.allow_tf32 = bool(config["allow_tf32"])
        torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"])
    m = config["model"]
    cfg = SurrogateConfig(name=m["name"], kind=m["kind"], input_shape=tuple(m["input_shape"]),
                          output_shape=tuple(m["output_shape"]),
                          base_channels=m["base_channels"], depth=m["depth"])
    if config["optimizer"]["lr"] != train_surrogate.LR:
        raise ValueError(f"the launcher trains at lr {train_surrogate.LR}, the "
                         f"configuration states {config['optimizer']['lr']}")
    opt, step = train_surrogate.make_step(
        cfg, argparse.Namespace(steps=config["optimizer"]["total_steps"]))
    return cfg, opt, step


def make_batch(cfg, capacity: int):
    from repro_torch.launch import train_surrogate

    return train_surrogate.make_batch_fn(cfg, capacity)


def batch_rows(batch: dict) -> dict:
    """The leaves of a program batch that carry the store's rows."""
    return {"x": batch["x"]}


def expected_rows(rows: torch.Tensor, config: dict) -> dict:
    """What :func:`batch_rows` holds for these store rows."""
    return {"x": rows}


def reference_step(params: dict, rows: torch.Tensor, config: dict, mix: dict, rnd):
    """Loss and gradients of one step over ``rows`` (the step's real
    samples, [B, *input_shape] float32)."""
    for p in params.values():
        p.grad = None
    loss = cnn.loss_sum(params, rows, config["model"], rnd) / rows.shape[0]
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in params.items()}


def layout(config: dict) -> list:
    m = config["model"]
    out = []
    c = m["input_shape"][-1]
    spatial = list(m["input_shape"][:-1])
    for i in range(m["depth"]):
        co = m["base_channels"] * 2 ** i
        out += [(f"enc.{i}.w", (co, c, 3, 3, 3), "float32", ("normal", 1 / math.sqrt(c * 27))),
                (f"enc.{i}.b", (co,), "float32", ("const", 0.0))]
        c = co
        spatial = [-(-s // 2) for s in spatial]
    flat = c * math.prod(spatial)
    outs = m["output_shape"][0]
    out += [("head.w1", (flat, 128), "float32", ("normal", 1 / math.sqrt(flat))),
            ("head.b1", (128,), "float32", ("const", 0.0)),
            ("head.w2", (128, outs), "float32", ("normal", 1 / math.sqrt(128))),
            ("head.b2", (outs,), "float32", ("const", 0.0))]
    return out


def data(config: dict, mix: dict, gen, device) -> torch.Tensor:
    return torch.randn((mix["num_samples"], *config["model"]["input_shape"]), generator=gen,
                       device=device, dtype=torch.float32)
