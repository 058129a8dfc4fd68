"""The one generator of the traffic mixes: a mix is ``<name>.json`` beside
this file, a set of parameters that this module reads.

Keys of a mix: ``loader`` (the port's loading strategy), ``backend`` (its
store layout), ``num_samples`` (rows in the store), ``num_nodes`` and
``local_batch`` (SOLAR's nodes and each node's batch), ``buffer_size``
(samples a node buffers), ``num_workers`` and ``prefetch_depth`` (the
loader's read-ahead threads and steps), ``num_epochs`` (the plan's length),
``pfs_latency_s`` (the store's sleep per physical read, emulating a
parallel file system's call latency), ``seq_len`` (LM rows: tokens a row
trains on), ``warmup_steps`` (steps trained before the window, the checked
ones among them), ``checked_steps`` (the first steps the reference
follows), ``trace_steps`` (steps under the profiler in a ``--trace 1``
run).

The store's rows come from the seed's data stream, made on the device in
one draw by the configuration's kind (``bench/kinds/<kind>.py``,
``data``)."""
from __future__ import annotations

import json
from pathlib import Path

import torch

from bench import kinds
from bench.traffic.weights import generator

__all__ = ["load", "data", "KEYS"]

HERE = Path(__file__).resolve().parent

KEYS = {"loader", "backend", "num_samples", "num_nodes", "local_batch", "buffer_size",
        "num_workers", "prefetch_depth", "num_epochs", "pfs_latency_s", "warmup_steps",
        "checked_steps", "trace_steps"}


def load(name: str) -> dict:
    """The parameters of the mix ``name``."""
    mix = json.loads((HERE / f"{name}.json").read_text())
    missing = KEYS - set(mix)
    if missing:
        raise ValueError(f"traffic {name!r} lacks {sorted(missing)}")
    return mix


def data(config: dict, mix: dict, seed: int, device) -> torch.Tensor:
    """Every row of the store, on ``device``, as the configuration's kind
    draws them from the seed's data stream."""
    return kinds.get(config["kind"]).data(config, mix, generator(seed, 1, device), device)
