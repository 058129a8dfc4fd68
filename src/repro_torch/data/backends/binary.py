"""``binary`` backend: the flat-file :class:`ChunkStore` behind the protocol.

The flat-file store already satisfies :class:`~repro_torch.data.backends.base.
StorageBackend` (it *is* a :class:`~repro_torch.data.backends.base.BaseBackend`);
this subclass only adds the uniform spec-based creation surface the registry
expects, so ``open_store(path, "binary")`` and ``create_store(path, "binary",
spec=...)`` round-trip.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.backends.base import DatasetSpec, register_backend
from repro_torch.data.storage import ChunkStore, write_binary_layout


def write_layout(
    path: str,
    spec: DatasetSpec | None,
    data: np.ndarray | None,
    fill: str,
    seed: int,
    kind: str,
) -> None:
    """Spec/data dispatch onto :func:`write_binary_layout` (shared with the
    ``memory`` backend, whose persisted form is this same layout)."""
    if spec is None and data is None:
        raise ValueError(f"{kind} create needs a DatasetSpec or a data array")
    if data is not None:
        write_binary_layout(path, data)
    else:
        write_binary_layout(
            path,
            num_samples=spec.num_samples,
            sample_shape=spec.sample_shape,
            dtype=spec.np_dtype,
            fill=fill,
            seed=seed,
        )


@register_backend("binary")
class BinaryBackend(ChunkStore):
    """Flat binary file + JSON header; lock-free fd-pool preads."""

    @classmethod
    def create(
        cls,
        path: str,
        *,
        spec: DatasetSpec | None = None,
        data: np.ndarray | None = None,
        fill: str = "zeros",
        seed: int = 0,
        **options,
    ) -> "BinaryBackend":
        write_layout(path, spec, data, fill, seed, "binary")
        return cls(path, **options)
