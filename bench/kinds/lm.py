"""Decoder LMs (``configs/<name>.json`` with ``"kind": "lm"``), trained
through the port's ``launch/train.py``: its ``make_step`` and
``make_batch_fn``, the SOLAR rows split into ``grad_accum`` microbatches."""
from __future__ import annotations

import argparse

import torch

from bench.counts.models import lm_train_flops
from bench.reference import lm

RATE = ("train_tokens_per_s", "tokens/s")
UNIT_NAME = "tokens"


def units_per_row(config: dict, mix: dict) -> int:
    return mix["seq_len"]


def model_flops_per_row(config: dict, mix: dict) -> float:
    return lm_train_flops(config["model"], 1, mix["seq_len"])


def program(config: dict, device):
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    cfg = get_config(config["arch"]).replace(**config["model"])
    o = config["optimizer"]
    opt, step = launch_train.make_step(
        cfg, argparse.Namespace(lr=o["lr"], steps=o["total_steps"]))
    return cfg, opt, step


def make_batch(cfg, capacity: int):
    from repro_torch.launch import train as launch_train

    return launch_train.make_batch_fn(cfg, capacity)


def batch_rows(batch: dict) -> dict:
    return {"tokens": batch["tokens"], "labels": batch["labels"]}


def expected_rows(rows: torch.Tensor, config: dict) -> dict:
    return {"tokens": rows[:, :-1].to(torch.int32), "labels": rows[:, 1:].to(torch.int32)}


def reference_step(params: dict, rows: torch.Tensor, config: dict, mix: dict, rnd):
    """Loss and gradients of one step over ``rows`` ([B, seq_len + 1] token
    ids): the mean NLL over every position of every row, one row at a time."""
    for p in params.values():
        p.grad = None
    rows = rows.long()
    denom = rows.shape[0] * (rows.shape[1] - 1)
    total = 0.0
    for r in range(rows.shape[0]):
        nll = lm.row_nll(params, rows[r, :-1], rows[r, 1:], config["model"], rnd)
        (nll / denom).backward()
        total += float(nll.detach())
    return total / denom, {k: p.grad for k, p in params.items()}
