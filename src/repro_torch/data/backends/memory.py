"""``memory`` backend: the dataset staged entirely into host RAM.

Models the ideal lower bound every PFS optimization chases — node-local DRAM
with zero per-call latency — and doubles as the fastest fixture for tests.
Opening a path stages the ``binary`` layout's flat file into one array
(create writes that layout first, so memory stores are reopenable); use
:meth:`MemoryBackend.from_array` to wrap an existing array without touching
disk.  ``simulated_latency_s`` still applies per coalesced read, so the
memory backend can also emulate a remote store whose *call* cost dominates
while its bandwidth is infinite.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.data.backends.base import BaseBackend, DatasetSpec, register_backend
from repro_torch.data.storage import _HEADER_SUFFIX, ChunkStore


@register_backend("memory")
class MemoryBackend(BaseBackend):
    """Whole dataset resident in one ``[num_samples, *sample_shape]`` array."""

    def __init__(
        self,
        path: str | None = None,
        *,
        data: np.ndarray | None = None,
        simulated_latency_s: float = 0.0,
    ):
        if data is None:
            if path is None:
                raise ValueError("MemoryBackend needs a path or a data array")
            with open(path + _HEADER_SUFFIX) as f:
                hdr = json.load(f)
            shape = (int(hdr["num_samples"]),) + tuple(hdr["sample_shape"])
            data = np.fromfile(path, dtype=np.dtype(hdr["dtype"])).reshape(shape)
        super().__init__(
            data.shape[0],
            data.shape[1:],
            data.dtype,
            path=path or "<memory>",
            simulated_latency_s=simulated_latency_s,
        )
        self._data = data

    @classmethod
    def from_array(cls, data: np.ndarray, **options) -> "MemoryBackend":
        return cls(data=data, **options)

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
    ) -> "MemoryBackend":
        # Persist the binary layout at ``path`` so the store is reopenable,
        # then stage it: bytes on disk and in RAM are identical by design.
        from repro_torch.data.backends.binary import write_layout

        write_layout(path, spec, data, fill, seed, "memory")
        return cls(path, **options)

    @classmethod
    def exists(cls, path: str) -> bool:
        return ChunkStore.exists(path)

    def _read_span(self, start: int, stop: int) -> np.ndarray:
        # copy: callers may hold rows past subsequent reads/close().
        return self._data[start:stop].copy()

    # -- ingest ----------------------------------------------------------------

    @property
    def writable(self) -> bool:
        return self._data.flags.writeable

    def write_rows(self, start: int, rows: np.ndarray) -> None:
        """In-RAM row overwrite (streaming ingest, DESIGN.md §10).

        Writes land in the staged array only — same-process readers see them
        immediately; the on-disk binary layout (if any) is untouched, so a
        multi-process streaming run must use a file-backed writable backend
        (``sharded``) instead.
        """
        rows = self._check_write(int(start), rows)
        self._data[start : start + rows.shape[0]] = rows

    # No _close_resources override: close() only flips _closed (new reads
    # fail loudly) while the array stays valid for reads already in flight —
    # the same "in-flight reads finish, new ones fail" contract the fd/handle
    # pools give the other backends.  RAM is reclaimed when the backend is
    # garbage collected.
