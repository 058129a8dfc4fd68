"""``hdf5`` backend: chunk-aligned, aggregated h5py reads (paper §5.4).

SOLAR "optimizes its data access pattern with HDF5 to achieve a better
parallel I/O throughput": instead of touching the dataset once per sample,
the runtime issues a few *large* reads aligned to the HDF5 chunk grid, each
covering whole chunks, and slices the wanted samples back out.  This backend
implements exactly that:

  * ``read_ranges`` first coalesces adjacent logical ranges (like every
    backend), then rounds each merged span outward to HDF5 chunk boundaries
    and merges spans whose *aligned* windows touch — so a step's ChunkReads
    that land in the same chunks cost one h5py call, and the HDF5 chunk
    cache is never re-read for partially-consumed chunks.  ``bytes_read``
    counts the aligned span (chunk waste included), mirroring the paper's
    numPFS-with-waste accounting.  Set ``align_chunks=False`` for the naive
    exact-span behaviour (the benchmark's ablation baseline).
  * the HDF5 chunk-cache size is a knob (``rdcc_nbytes``/``rdcc_nslots``,
    passed straight to :class:`h5py.File`), and
  * ``simulated_latency_s`` injects per-call latency for PFS emulation,
    slept *outside* h5py's global lock so injected latency overlaps across
    prefetch threads.

Handles follow ChunkStore's fd-pool pattern: each in-flight read checks a
private ``h5py.File`` out of an on-demand pool (h5py serializes HDF5 library
calls internally, so this is about lifecycle safety — a reader never holds a
handle that ``close()`` tears down under it — not about lock-free I/O).

h5py is an *optional* dependency (see ``requirements-dev.txt``): importing
this module never fails, but constructing the backend without h5py raises a
clear ImportError, and HDF5 tests ``pytest.importorskip`` it.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.data.backends.base import BaseBackend, DatasetSpec, register_backend, synthetic_blocks

try:  # optional dependency — tier-1 must pass without it
    import h5py

    HAVE_H5PY = True
except Exception:  # pragma: no cover - environment without h5py
    h5py = None
    HAVE_H5PY = False

__all__ = ["Hdf5Backend", "HAVE_H5PY"]

_DATASET = "samples"


def _require_h5py() -> None:
    if not HAVE_H5PY:
        raise ImportError(
            "the 'hdf5' storage backend requires h5py, which is not installed; "
            "install the optional dev dependency (see requirements-dev.txt) or "
            "pick another backend ('binary', 'sharded', 'memory')"
        )


@register_backend("hdf5")
class Hdf5Backend(BaseBackend):
    """Chunked HDF5 dataset with aggregated chunk-aligned ranged reads."""

    def __init__(
        self,
        path: str,
        *,
        simulated_latency_s: float = 0.0,
        align_chunks: bool = True,
        rdcc_nbytes: int | None = None,
        rdcc_nslots: int | None = None,
    ):
        _require_h5py()
        self._open_kwargs: dict = {}
        if rdcc_nbytes is not None:
            self._open_kwargs["rdcc_nbytes"] = int(rdcc_nbytes)
        if rdcc_nslots is not None:
            self._open_kwargs["rdcc_nslots"] = int(rdcc_nslots)
        with h5py.File(path, "r") as f:
            d = f[_DATASET]
            shape, dtype = d.shape, d.dtype
            chunk_rows = int(d.chunks[0]) if d.chunks else 0
        super().__init__(
            shape[0],
            shape[1:],
            dtype,
            path=path,
            simulated_latency_s=simulated_latency_s,
        )
        #: aggregated access on the chunk grid (paper §5.4); False = naive
        #: exact-span reads (ablation baseline in ``benchmarks/backends.py``).
        self.align_chunks = bool(align_chunks)
        #: HDF5 chunk height in samples (0 = contiguous dataset).
        self.chunk_samples = chunk_rows
        self._handles: queue.SimpleQueue = queue.SimpleQueue()
        self._files: list = []          # every File ever opened, for close()
        self._handle_lock = threading.Lock()
        self._release_handle(self._open_handle())  # fail on a bad file now

    def spec(self) -> DatasetSpec:
        return DatasetSpec(
            self.num_samples,
            self.sample_shape,
            self.dtype.str,
            chunk_samples=self.chunk_samples,
        )

    # -- handle pool (ChunkStore's fd-pool pattern) -------------------------------

    def _open_handle(self):
        with self._handle_lock:
            if self._closed:
                raise ValueError(f"store {self.path!r} is closed")
            f = h5py.File(self.path, "r", **self._open_kwargs)
            self._files.append(f)
        return (f, f[_DATASET])

    def _acquire_handle(self):
        if self._closed:
            raise ValueError(f"store {self.path!r} is closed")
        try:
            return self._handles.get_nowait()
        except queue.Empty:
            return self._open_handle()

    def _release_handle(self, handle) -> None:
        if self._closed:
            self._close_file(handle[0])
        else:
            self._handles.put(handle)

    def _close_file(self, f) -> None:
        with self._handle_lock:
            if f in self._files:
                self._files.remove(f)
            else:  # already retired by a racing close()
                return
        try:
            f.close()
        except Exception:  # pragma: no cover
            pass

    def _close_resources(self) -> None:
        while True:  # drain + close idle handles; in-flight ones retire
            try:     # themselves in _release_handle once their read finishes
                handle = self._handles.get_nowait()
            except queue.Empty:
                break
            self._close_file(handle[0])

    # -- reads -----------------------------------------------------------------

    def _read_span(self, start: int, stop: int) -> np.ndarray:
        handle = self._acquire_handle()
        try:
            return np.asarray(handle[1][start:stop])
        finally:
            self._release_handle(handle)

    def read_ranges(self, ranges) -> list[np.ndarray]:
        """Aggregated chunk-aligned ranged reads.

        Adjacent-touching input ranges are merged (as everywhere), then each
        merged span is rounded outward to the HDF5 chunk grid; consecutive
        spans whose aligned windows touch or overlap collapse into a single
        dataset read covering whole chunks.  The wanted sub-ranges are sliced
        back out, preserving the one-array-per-input-range contract.
        """
        if not self.align_chunks or self.chunk_samples <= 0:
            return super().read_ranges(ranges)
        c = self.chunk_samples
        ranges = [(int(a), int(b)) for a, b in ranges]
        for a, b in ranges:
            if not 0 <= a < b <= self.num_samples:
                raise IndexError((a, b, self.num_samples))
        out: list[np.ndarray | None] = [None] * len(ranges)
        i = 0
        while i < len(ranges):
            lo, hi = ranges[i]
            alo = (lo // c) * c
            ahi = min(-(-hi // c) * c, self.num_samples)
            j = i
            while j + 1 < len(ranges):
                nlo, nhi = ranges[j + 1]
                if nlo < lo or (nlo // c) * c > ahi:
                    break  # unsorted, or next aligned window is disjoint
                ahi = max(ahi, min(-(-nhi // c) * c, self.num_samples))
                j += 1
            arr = self._pread(alo, ahi)  # one aggregated h5py call
            for k in range(i, j + 1):
                a, b = ranges[k]
                out[k] = arr[a - alo : b - alo]
            i = j + 1
        return out  # type: ignore[return-value]

    # -- construction ----------------------------------------------------------

    @classmethod
    def create(
        cls,
        path: str,
        *,
        spec: DatasetSpec | None = None,
        data: np.ndarray | None = None,
        fill: str = "zeros",
        seed: int = 0,
        chunk_samples: int | None = None,
        **options,
    ) -> "Hdf5Backend":
        _require_h5py()
        if data is not None:
            spec = DatasetSpec(
                data.shape[0], data.shape[1:], np.dtype(data.dtype).str
            )
        if spec is None:
            raise ValueError("hdf5 create needs a DatasetSpec or a data array")
        rows = int(chunk_samples or spec.chunk_samples) or max(
            1, min(spec.num_samples, (1 << 20) // max(spec.sample_bytes, 1))
        )
        rows = max(1, min(rows, spec.num_samples))
        with h5py.File(path, "w") as f:
            d = f.create_dataset(
                _DATASET,
                shape=(spec.num_samples,) + spec.sample_shape,
                dtype=spec.np_dtype,
                chunks=(rows,) + spec.sample_shape,
            )
            if data is not None:
                d[...] = data
            else:
                for start, block in synthetic_blocks(
                    spec.num_samples, spec.sample_shape, spec.np_dtype, fill, seed
                ):
                    d[start : start + block.shape[0]] = block
        return cls(path, **options)

    @classmethod
    def exists(cls, path: str) -> bool:
        # signature check, not a bare stat: a flat-binary file left at the
        # same path by another backend must read as "no HDF5 dataset here"
        # (create will then raise/replace) instead of failing deep in h5py.
        return HAVE_H5PY and bool(h5py.is_hdf5(path))
