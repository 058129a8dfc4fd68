"""Pre-determined multi-epoch shuffle (SOLAR observation 1, §4.2).

In stock training loops the permutation for epoch ``e`` is drawn *at the start
of epoch e*.  SOLAR's first observation is that with a fixed seed the entire
sequence of permutations is already determined before training starts, so all
of them can be generated ahead of time and optimized offline.

``generate_epoch_permutations`` reproduces exactly that semantics: one PCG64
stream seeded once, drawing ``num_epochs`` successive permutations — i.e. the
same index lists a seeded online sampler would produce.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "generate_epoch_permutations",
    "split_global_batches",
    "default_node_assignment",
]


def generate_epoch_permutations(
    num_samples: int, num_epochs: int, seed: int = 0
) -> np.ndarray:
    """Return the shuffled index list for *all* epochs, shape ``[E, D]``.

    Deterministic in ``seed``; epoch ``e``'s permutation equals the ``e``-th
    draw from a single seeded generator, matching an online per-epoch shuffle.
    """
    if num_samples <= 0 or num_epochs <= 0:
        raise ValueError("num_samples and num_epochs must be positive")
    rng = np.random.Generator(np.random.PCG64(seed))
    out = np.empty((num_epochs, num_samples), dtype=np.int64)
    for e in range(num_epochs):
        out[e] = rng.permutation(num_samples)
    return out


def split_global_batches(perm: np.ndarray, global_batch: int, drop_last: bool = True):
    """Split one epoch's permutation into global batches.

    Returns an array of shape ``[num_steps, global_batch]``.  With
    ``drop_last`` (the default, matching distributed samplers) the ragged tail
    is dropped so every step is full.
    """
    nsteps = perm.size // global_batch
    if nsteps == 0:
        raise ValueError(
            f"dataset ({perm.size}) smaller than one global batch ({global_batch})"
        )
    body = perm[: nsteps * global_batch]
    if not drop_last and perm.size % global_batch:
        raise NotImplementedError("ragged final batch is not supported")
    return body.reshape(nsteps, global_batch)


def default_node_assignment(batch: np.ndarray, num_nodes: int) -> list[np.ndarray]:
    """The vanilla (no SOLAR) node-to-sample mapping: contiguous split.

    Node ``n`` trains ``batch[n*Bl : (n+1)*Bl]`` — this is what a distributed
    sampler does and is the baseline SOLAR's locality remap replaces.
    """
    if batch.size % num_nodes:
        raise ValueError("global batch must divide evenly across nodes")
    return list(batch.reshape(num_nodes, -1))
