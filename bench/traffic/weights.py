"""Random weights from the seed, made on the device in a few large draws.

Every leaf of a dtype is a view of one flat buffer, filled from float32
normal draws of at most ``DRAW`` numbers, each leaf scaled by its own
factor and cast once; constant leaves are filled.  The leaves, their order
and their inits are the configuration's kind's (``bench/kinds/<kind>.py``,
``layout``).  The same seed on the same device gives the same weights."""
from __future__ import annotations

import math

import torch

from bench import kinds

__all__ = ["layout", "make", "generator"]

#: numbers a single normal draw makes
DRAW = 1 << 27

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one of the seed's streams (0 weights,
    1 data)."""
    return torch.Generator(device=device).manual_seed((seed * 2 + stream) % (1 << 63))


def layout(config: dict) -> list:
    """``[(name, shape, dtype name, (init, arg)), ...]`` of a configuration
    file's model, in the order the port's init gives its leaves."""
    return kinds.get(config["kind"]).layout(config)


def make(config: dict, seed: int, device) -> dict:
    """The weights of ``config`` from ``seed``: ``{name: tensor}``."""
    leaves = layout(config)
    gen = generator(seed, 0, device)
    flats, offsets, totals = {}, {}, {}
    for name, shape, dt, _ in leaves:
        offsets[name] = totals.get(dt, 0)
        totals[dt] = offsets[name] + math.prod(shape)
    for dt, total in totals.items():
        flats[dt] = torch.empty(total, dtype=_DTYPES[dt], device=device)
    out = {name: flats[dt][offsets[name]:offsets[name] + math.prod(shape)].view(shape)
           for name, shape, dt, _ in leaves}
    normal = [(name, math.prod(shape), init[1]) for name, shape, _, init in leaves
              if init[0] == "normal"]
    # one stream of draws over the normal leaves in order, DRAW numbers a call
    todo = sum(n for _, n, _ in normal)
    leaf, done_in_leaf = 0, 0
    while todo:
        chunk = torch.randn(min(DRAW, todo), generator=gen, device=device,
                            dtype=torch.float32)
        used = 0
        while used < chunk.numel():
            name, n, scale = normal[leaf]
            take = min(n - done_in_leaf, chunk.numel() - used)
            dst = out[name].view(-1)[done_in_leaf:done_in_leaf + take]
            dst.copy_(chunk[used:used + take] * scale)
            used += take
            done_in_leaf += take
            if done_in_leaf == n:
                leaf, done_in_leaf = leaf + 1, 0
        todo -= chunk.numel()
        del chunk
    for name, shape, dt, (init, arg) in leaves:
        if init == "const":
            out[name].fill_(arg)
        elif init == "dt_range":
            lo, hi = math.log(arg[0]), math.log(arg[1])
            dt = torch.exp(torch.linspace(lo, hi, shape[-1], dtype=torch.float64,
                                          device=device))
            out[name].copy_(torch.log(torch.expm1(dt)).float().expand(shape))
        elif init == "a_log":
            out[name].copy_(torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                                   device=device)).expand(shape))
    return out
