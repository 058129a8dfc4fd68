"""Flat-binary chunked sample store — the original "PFS + HDF5" stand-in.

A minimal HDF5-like chunked dataset: a JSON header + one flat binary file
holding ``num_samples`` fixed-shape samples contiguously.  What matters for
SOLAR is preserved exactly:

  * a *ranged* read of samples ``[start, stop)`` is a single seek + one
    sequential read (this is what makes aggregated chunk loading win), and
  * a scattered read of k samples costs one pread per consecutive run of
    ids (adjacent ids are coalesced into ranged reads).

Every read is a real ``pread`` against the filesystem; benchmarks additionally
price the same access trace under :class:`repro_torch.core.costmodel.PFSCostModel`
to model a remote Lustre/GPFS where the per-call cost dominates.

:class:`ChunkStore` is one implementation of the
:class:`repro_torch.data.backends.base.StorageBackend` protocol (registered as the
``binary`` backend via :class:`repro_torch.data.backends.binary.BinaryBackend`);
the geometry, stats, and coalescing read paths live in
:class:`~repro_torch.data.backends.base.BaseBackend` and are shared with the
``hdf5``/``memory``/``sharded`` layouts.

Concurrency: reads are safe from any number of threads.  Each in-flight read
checks a private file descriptor out of a pool (growing it on demand, so fd
count tracks *peak concurrency*, not thread count), preads, and returns it —
parallel chunk fetches from the prefetch executor never serialize behind a
lock; only the counter updates share a short critical section.
``simulated_latency_s`` injects a per-pread sleep to emulate remote-PFS call
latency in benchmarks (``time.sleep`` releases the GIL, so injected latency
overlaps across threads exactly like real PFS round-trips would).
"""
from __future__ import annotations

import json
import os
import queue
import threading

import numpy as np

from repro_torch.data.backends.base import BaseBackend, synthetic_blocks

__all__ = ["ChunkStore", "create_synthetic_store", "write_binary_layout"]

_HEADER_SUFFIX = ".header.json"


def write_binary_layout(
    path: str,
    data: np.ndarray | None = None,
    *,
    num_samples: int | None = None,
    sample_shape: tuple[int, ...] | None = None,
    dtype=np.float32,
    fill: str = "zeros",
    seed: int = 0,
) -> None:
    """Write the flat-binary layout (header + data file) without opening a
    store — shared by :meth:`ChunkStore.create` and the ``binary``/``memory``
    backends' creation paths."""
    if data is not None:
        num_samples = data.shape[0]
        sample_shape = tuple(data.shape[1:])
        dtype = data.dtype
    assert num_samples is not None and sample_shape is not None
    hdr = {
        "num_samples": int(num_samples),
        "sample_shape": [int(x) for x in sample_shape],
        "dtype": np.dtype(dtype).str,
    }
    with open(path + _HEADER_SUFFIX, "w") as f:
        json.dump(hdr, f)
    if data is not None:
        data.tofile(path)
    else:
        with open(path, "wb") as f:
            for _, block in synthetic_blocks(
                num_samples, sample_shape, dtype, fill, seed
            ):
                block.tofile(f)


class ChunkStore(BaseBackend):
    """Fixed-shape sample array stored contiguously in one file."""

    backend_name = "binary"

    def __init__(self, path: str, simulated_latency_s: float = 0.0):
        with open(path + _HEADER_SUFFIX) as f:
            hdr = json.load(f)
        super().__init__(
            int(hdr["num_samples"]),
            tuple(hdr["sample_shape"]),
            np.dtype(hdr["dtype"]),
            path=path,
            simulated_latency_s=simulated_latency_s,
        )
        self._fd_pool: queue.SimpleQueue = queue.SimpleQueue()
        self._fds: list[int] = []       # every fd ever opened, for close()
        self._fd_lock = threading.Lock()
        self._release_fd(self._open_fd())  # fail on a bad path right here

    # -- construction --------------------------------------------------------

    @classmethod
    def create(
        cls,
        path: str,
        data: np.ndarray | None = None,
        *,
        num_samples: int | None = None,
        sample_shape: tuple[int, ...] | None = None,
        dtype=np.float32,
        fill: str = "zeros",
        seed: int = 0,
    ) -> "ChunkStore":
        write_binary_layout(
            path, data, num_samples=num_samples, sample_shape=sample_shape,
            dtype=dtype, fill=fill, seed=seed,
        )
        return cls(path)

    @classmethod
    def exists(cls, path: str) -> bool:
        return os.path.exists(path) and os.path.exists(path + _HEADER_SUFFIX)

    # -- fd pool --------------------------------------------------------------

    def _open_fd(self) -> int:
        with self._fd_lock:
            if self._closed:
                raise ValueError(f"store {self.path!r} is closed")
            fd = os.open(self.path, os.O_RDONLY)
            self._fds.append(fd)
        return fd

    def _acquire_fd(self) -> int:
        """Check a descriptor out for one read (grow the pool on demand)."""
        if self._closed:
            raise ValueError(f"store {self.path!r} is closed")
        try:
            return self._fd_pool.get_nowait()
        except queue.Empty:
            return self._open_fd()

    def _release_fd(self, fd: int) -> None:
        # close() only tears down *pooled* descriptors; one that was in
        # flight when close() ran is retired here instead of re-pooled, so a
        # concurrent reader never preads a descriptor closed under it.
        if self._closed:
            self._close_fd(fd)
        else:
            self._fd_pool.put(fd)

    def _close_fd(self, fd: int) -> None:
        with self._fd_lock:
            if fd in self._fds:
                self._fds.remove(fd)
            else:  # already retired by a racing close()
                return
        try:
            os.close(fd)
        except OSError:  # pragma: no cover
            pass

    # -- physical read + lifecycle --------------------------------------------

    def _read_span(self, start: int, stop: int) -> np.ndarray:
        nbytes = (stop - start) * self.sample_bytes
        fd = self._acquire_fd()
        try:
            buf = os.pread(fd, nbytes, start * self.sample_bytes)
        finally:
            self._release_fd(fd)
        arr = np.frombuffer(buf, dtype=self.dtype)
        return arr.reshape((stop - start,) + self.sample_shape)

    def close(self) -> None:
        with self._fd_lock:
            self._closed = True
        while True:  # drain + close idle descriptors; in-flight ones retire
            try:     # themselves in _release_fd once their pread finishes
                fd = self._fd_pool.get_nowait()
            except queue.Empty:
                break
            self._close_fd(fd)


def create_synthetic_store(
    path: str,
    num_samples: int,
    sample_shape: tuple[int, ...],
    dtype=np.float32,
    kind: str = "arange",
    seed: int = 0,
) -> ChunkStore:
    """Synthetic scientific dataset (diffraction frames / token sequences)."""
    return ChunkStore.create(
        path,
        num_samples=num_samples,
        sample_shape=sample_shape,
        dtype=dtype,
        fill=kind,
        seed=seed,
    )
