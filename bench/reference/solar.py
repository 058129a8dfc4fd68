"""SOLAR's per-step membership, worked out again from the seed.

SOLAR (arXiv:2211.00224 §4) keeps every epoch's global batches as the seeded
shuffle draws them and changes only the order of the epochs and which node
reads which sample.  So every trained step's samples, taken over all nodes,
are one global batch of one epoch's permutation, the steps of an epoch come
in the permutation's order, and each epoch is trained once.
:func:`epoch_permutations` is a frozen copy of the shuffle
(``repro_torch/core/shuffle.py``): one PCG64 stream, one permutation per
epoch."""
from __future__ import annotations

import numpy as np

__all__ = ["epoch_permutations", "Membership"]


def epoch_permutations(num_samples: int, num_epochs: int, seed: int) -> np.ndarray:
    rng = np.random.Generator(np.random.PCG64(seed))
    out = np.empty((num_epochs, num_samples), dtype=np.int64)
    for e in range(num_epochs):
        out[e] = rng.permutation(num_samples)
    return out


class Membership:
    """The global batches of every epoch, by their set of sample ids."""

    def __init__(self, num_samples: int, num_epochs: int, global_batch: int, seed: int):
        self.perms = epoch_permutations(num_samples, num_epochs, seed)
        self.global_batch = global_batch
        self.steps_per_epoch = num_samples // global_batch
        self._where = {}
        for e in range(num_epochs):
            for s in range(self.steps_per_epoch):
                ids = self.perms[e, s * global_batch:(s + 1) * global_batch]
                self._where[frozenset(ids.tolist())] = (e, s)

    def batch(self, e: int, s: int) -> np.ndarray:
        return self.perms[e, s * self.global_batch:(s + 1) * self.global_batch]

    def check(self, steps: list) -> tuple[list, int]:
        """``steps``: per trained step, the per-node id arrays.  Returns
        (per step its (epoch, step) or None, the number of faults: a step
        that is no global batch or repeats an id, a step out of its epoch's
        order, an epoch trained twice)."""
        where, faults = [], 0
        seen_epochs, prev = set(), None
        for node_ids in steps:
            ids = np.concatenate([np.asarray(a, np.int64) for a in node_ids])
            hit = self._where.get(frozenset(ids.tolist()))
            if hit is None or len(set(ids.tolist())) != ids.size:
                faults += 1
                where.append(None)
                prev = None
                continue
            e, s = hit
            if s == 0:
                if e in seen_epochs:
                    faults += 1
                seen_epochs.add(e)
            elif prev is None or prev != (e, s - 1):
                faults += 1
            where.append(hit)
            prev = hit
        return where, faults
