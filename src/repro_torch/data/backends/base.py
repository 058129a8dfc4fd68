"""Storage-backend protocol: one read contract over many physical layouts.

The SOLAR schedule only cares about *sample geometry* — which contiguous
runs of sample ids a node reads per step — never about how those samples are
laid out on disk.  This module pins that boundary down:

  * :class:`DatasetSpec` — pure geometry (sample count/shape/dtype plus the
    layout hints ``chunk_samples`` and ``num_shards``) shared by every
    backend and by dataset creation.
  * :class:`StorageBackend` — the runtime protocol every backend satisfies:
    ranged / coalesced / scattered reads, access-trace counters, a
    ``simulated_latency_s`` PFS-emulation knob, and an open/close lifecycle
    safe under the fd-pool parallel reads of the prefetch executor.
  * :class:`BaseBackend` — the shared engine.  Subclasses implement one
    physical primitive, :meth:`BaseBackend._read_span`, and inherit bounds
    checks, latency injection, stats, adjacency coalescing in
    ``read_ranges`` and run coalescing in ``read_scattered`` — so every
    backend returns bit-identical arrays and comparable counters for the
    same access plan.
  * a tiny registry (:func:`register_backend` / :func:`open_store` /
    :func:`create_store`) that :class:`repro_torch.data.pipeline.LoaderSpec`
    resolves backend names through.

Concrete layouts live next door: ``binary`` (flat file + fd pool),
``hdf5`` (chunk-aligned aggregated h5py reads), ``memory`` (RAM-staged),
``sharded`` (multi-file, one fd pool per shard).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, Protocol, runtime_checkable

import numpy as np

from repro_torch.obs import trace as obs_trace

__all__ = [
    "DatasetSpec",
    "StorageBackend",
    "CoalescingReadsMixin",
    "BaseBackend",
    "synthetic_blocks",
    "register_backend",
    "backend_names",
    "get_backend",
    "open_store",
    "create_store",
]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Geometry of one dataset, independent of the physical layout."""

    num_samples: int
    sample_shape: tuple[int, ...]
    dtype: str = "<f4"
    #: preferred contiguous-read granularity in samples (HDF5 chunk rows);
    #: 0 means the layout is fully contiguous / has no preferred alignment.
    chunk_samples: int = 0
    #: number of physical files holding the samples (sharded layouts).
    num_shards: int = 1

    def __post_init__(self):
        object.__setattr__(self, "num_samples", int(self.num_samples))
        object.__setattr__(
            self, "sample_shape", tuple(int(x) for x in self.sample_shape)
        )
        object.__setattr__(self, "dtype", np.dtype(self.dtype).str)
        object.__setattr__(self, "chunk_samples", int(self.chunk_samples))
        object.__setattr__(self, "num_shards", int(self.num_shards))

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def sample_bytes(self) -> int:
        return int(
            self.np_dtype.itemsize * int(np.prod(self.sample_shape, dtype=np.int64))
        )

    @property
    def nbytes(self) -> int:
        return self.num_samples * self.sample_bytes


@runtime_checkable
class StorageBackend(Protocol):
    """What the loaders, prefetch executor, and benchmarks require of a store."""

    num_samples: int
    sample_shape: tuple[int, ...]
    dtype: np.dtype
    sample_bytes: int
    #: per-physical-read sleep emulating remote-PFS call latency.
    simulated_latency_s: float
    #: access trace: (sample_offset, run_length) per physical read.
    trace: list
    bytes_read: int
    read_calls: int

    def spec(self) -> DatasetSpec: ...

    def read_range(self, start: int, stop: int) -> np.ndarray: ...

    def read_one(self, idx: int) -> np.ndarray: ...

    def read_ranges(self, ranges) -> list: ...

    def read_scattered(self, ids) -> np.ndarray: ...

    def reset_counters(self) -> None: ...

    def close(self) -> None: ...


class CoalescingReadsMixin:
    """Derived read paths on top of :meth:`read_range`.

    Mixed into anything exposing ``read_range``/``sample_shape``/``dtype``:
    adjacency coalescing for ranged reads and run coalescing for scattered
    reads, exactly as ``ChunkStore`` did — kept in one place so
    every backend coalesces identically.
    """

    def read_one(self, idx: int) -> np.ndarray:
        return self.read_range(idx, idx + 1)[0]

    def read_ranges(self, ranges) -> list[np.ndarray]:
        """Ranged reads with adjacency coalescing.

        ``ranges`` is a sequence of ``(start, stop)`` pairs.  Consecutive
        pairs whose spans touch (``prev_stop == next_start``) are merged into
        one physical read and split back afterwards, so a run of adjacent
        :class:`~repro_torch.core.plan.ChunkRead`\\ s costs a single PFS call.
        Returns one array per input range, in input order.
        """
        ranges = [(int(a), int(b)) for a, b in ranges]
        out: list[np.ndarray | None] = [None] * len(ranges)
        i = 0
        while i < len(ranges):
            j = i
            while j + 1 < len(ranges) and ranges[j + 1][0] == ranges[j][1]:
                j += 1
            lo, hi = ranges[i][0], ranges[j][1]
            arr = self.read_range(lo, hi)
            for k in range(i, j + 1):
                a, b = ranges[k]
                out[k] = arr[a - lo : b - lo]
            i = j + 1
        return out  # type: ignore[return-value]

    def read_scattered(self, ids) -> np.ndarray:
        """Scattered read of k samples, coalescing consecutive ids.

        Ids are sorted, runs of adjacent ids become ranged reads (routed
        through :meth:`read_ranges`, so backends with smarter ranged paths —
        e.g. HDF5 chunk alignment — benefit here too), and rows come back in
        the caller's original order (duplicates allowed).
        """
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return np.empty((0,) + tuple(self.sample_shape), self.dtype)
        order = np.argsort(ids, kind="stable")
        sids = ids[order]
        breaks = np.flatnonzero(np.diff(sids) > 1) + 1
        starts = np.concatenate([[0], breaks])
        ends = np.concatenate([breaks, [sids.size]])
        runs = [(int(sids[a]), int(sids[b - 1]) + 1) for a, b in zip(starts, ends)]
        arrays = self.read_ranges(runs)
        out = np.empty((ids.size,) + tuple(self.sample_shape), self.dtype)
        for a, b, arr, (lo, _) in zip(starts, ends, arrays, runs):
            out[order[a:b]] = arr[sids[a:b] - lo]
        return out


class BaseBackend(CoalescingReadsMixin):
    """Shared geometry + stats + latency engine for storage backends.

    Subclasses implement :meth:`_read_span` (one physical contiguous read of
    samples ``[start, stop)``) and optionally :meth:`_close_resources`.
    Everything else — bounds checks, per-read latency injection, the access
    trace, and both coalescing read paths — is inherited.
    """

    backend_name = "base"

    def __init__(
        self,
        num_samples: int,
        sample_shape: tuple[int, ...],
        dtype,
        *,
        path: str = "<anonymous>",
        simulated_latency_s: float = 0.0,
    ):
        self.path = path
        self.num_samples = int(num_samples)
        self.sample_shape = tuple(int(x) for x in sample_shape)
        self.dtype = np.dtype(dtype)
        self.sample_bytes = int(
            self.dtype.itemsize * int(np.prod(self.sample_shape, dtype=np.int64))
        )
        #: per-physical-read sleep emulating remote-PFS call latency
        #: (``time.sleep`` releases the GIL, so injected latency overlaps
        #: across prefetch threads exactly like real PFS round-trips would).
        self.simulated_latency_s = float(simulated_latency_s)
        self._closed = False
        self._stats_lock = threading.Lock()
        #: access trace: list of (sample_offset, run_length) — consumed by
        #: the cost model and the access-pattern benchmark; cheap to record.
        self.trace: list[tuple[int, int]] = []
        self.bytes_read = 0
        self.read_calls = 0

    # -- protocol surface ------------------------------------------------------

    def spec(self) -> DatasetSpec:
        return DatasetSpec(self.num_samples, self.sample_shape, self.dtype.str)

    def read_range(self, start: int, stop: int) -> np.ndarray:
        """One ranged read: samples [start, stop) in a single physical call."""
        if not 0 <= start < stop <= self.num_samples:
            raise IndexError((start, stop, self.num_samples))
        return self._pread(int(start), int(stop))

    def reset_counters(self) -> None:
        with self._stats_lock:
            self.trace.clear()
            self.bytes_read = 0
            self.read_calls = 0

    # -- ingest (streaming writers, DESIGN.md §10) -----------------------------

    @property
    def writable(self) -> bool:
        """Whether :meth:`write_rows` is supported (streaming ingest)."""
        return False

    def write_rows(self, start: int, rows: np.ndarray) -> None:
        """Overwrite samples ``[start, start + len(rows))`` in place.

        Only writable backends (``memory``, ``sharded``) implement this; the
        store is pre-sized, so ingest never grows or shrinks the id space.
        """
        raise NotImplementedError(
            f"{self.backend_name!r} backend is read-only; streaming ingest "
            "needs a writable backend ('memory' or 'sharded')"
        )

    def flush(self) -> None:
        """Make prior :meth:`write_rows` durable/visible to other processes."""

    def _check_write(self, start: int, rows: np.ndarray) -> np.ndarray:
        if self._closed:
            raise ValueError(f"store {self.path!r} is closed")
        rows = np.ascontiguousarray(
            np.asarray(rows, self.dtype).reshape((-1,) + self.sample_shape)
        )
        stop = start + rows.shape[0]
        if not 0 <= start <= stop <= self.num_samples:
            raise IndexError((start, stop, self.num_samples))
        return rows

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        self._close_resources()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass

    # -- physical layer --------------------------------------------------------

    def _pread(self, start: int, stop: int) -> np.ndarray:
        """One physical read: latency injection + the span read + stats."""
        if self._closed:
            raise ValueError(f"store {self.path!r} is closed")
        tr = obs_trace.get()
        t0 = tr.t()
        if self.simulated_latency_s > 0.0:
            time.sleep(self.simulated_latency_s)
        arr = self._read_span(start, stop)
        tr.rec(obs_trace.CHUNK_READ, t0, a=stop - start,
               b=(stop - start) * self.sample_bytes)
        with self._stats_lock:
            self.trace.append((start, stop - start))
            self.bytes_read += (stop - start) * self.sample_bytes
            self.read_calls += 1
        return arr

    def _read_span(self, start: int, stop: int) -> np.ndarray:
        """Physically read samples ``[start, stop)`` — one call per invocation."""
        raise NotImplementedError

    def _close_resources(self) -> None:
        """Tear down descriptors/handles; called once from :meth:`close`."""


# ---------------------------------------------------------------------------
# Synthetic data generation (shared so every backend stores identical bytes)
# ---------------------------------------------------------------------------


def synthetic_blocks(
    num_samples: int,
    sample_shape: tuple[int, ...],
    dtype,
    fill: str = "zeros",
    seed: int = 0,
    block: int = 4096,
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(start, rows)`` blocks of deterministic synthetic data.

    One RNG stream across blocks, fixed block size: the concatenated output
    depends only on ``(num_samples, sample_shape, dtype, fill, seed)`` — never
    on which backend consumes the blocks — so backend-parity tests can compare
    stores bit-for-bit.
    """
    sample_shape = tuple(int(x) for x in sample_shape)
    sample_elems = int(np.prod(sample_shape, dtype=np.int64))
    dtype = np.dtype(dtype)
    rng = np.random.Generator(np.random.PCG64(seed))
    for start in range(0, num_samples, block):
        n = min(block, num_samples - start)
        if fill == "zeros":
            arr = np.zeros((n, sample_elems), dtype)
        elif fill == "random":
            if np.issubdtype(dtype, np.integer):
                arr = rng.integers(0, 255, size=(n, sample_elems)).astype(dtype)
            else:
                arr = rng.standard_normal((n, sample_elems)).astype(dtype)
        elif fill == "arange":
            # sample i filled with value i — lets tests verify reads.
            arr = np.broadcast_to(
                np.arange(start, start + n, dtype=np.int64)[:, None],
                (n, sample_elems),
            ).astype(dtype)
        else:
            raise ValueError(f"unknown fill {fill!r}")
        yield start, arr.reshape((n,) + sample_shape)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type] = {}

#: built-in backends, resolved lazily on first use — keeps this module free
#: of imports from the concrete layouts (which import ChunkStore, which
#: imports this module).
_LAZY_BACKENDS = {
    "binary": "repro_torch.data.backends.binary",
    "hdf5": "repro_torch.data.backends.hdf5",
    "memory": "repro_torch.data.backends.memory",
    "sharded": "repro_torch.data.backends.sharded",
}


def register_backend(name: str):
    """Class decorator: register a backend under ``name`` (its CLI/spec id)."""

    def _register(cls):
        cls.backend_name = name
        _REGISTRY[name] = cls
        return cls

    return _register


def backend_names() -> list[str]:
    return sorted(set(_REGISTRY) | set(_LAZY_BACKENDS))


def get_backend(name: str) -> type:
    if name not in _REGISTRY and name in _LAZY_BACKENDS:
        import importlib

        importlib.import_module(_LAZY_BACKENDS[name])  # registers itself
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown storage backend {name!r}; have {backend_names()}"
        ) from None


def open_store(path: str, backend: str = "binary", **options):
    """Open an existing dataset at ``path`` through the named backend."""
    return get_backend(backend)(path, **options)


def create_store(
    path: str,
    backend: str = "binary",
    *,
    spec: DatasetSpec | None = None,
    data: np.ndarray | None = None,
    fill: str = "zeros",
    seed: int = 0,
    **options,
):
    """Create a dataset at ``path`` in the named backend's layout and open it.

    Provide either ``data`` (an ``[num_samples, *sample_shape]`` array) or a
    :class:`DatasetSpec` plus a ``fill`` kind (``zeros``/``random``/``arange``)
    for synthetic generation.  Extra ``options`` go to the backend (both
    creation-time layout knobs and open-time options).
    """
    return get_backend(backend).create(
        path, spec=spec, data=data, fill=fill, seed=seed, **options
    )
