"""``sharded`` backend: samples split contiguously across multiple files.

Real multi-node PFS datasets are rarely one file — they are directories of
shards (one per writer rank / acquisition run).  Each shard here is a full
flat-binary :class:`~repro_torch.data.storage.ChunkStore` with its *own* fd pool,
so parallel chunk fetches against different shards never contend on one
descriptor set, and a ranged read that crosses a shard boundary splits into
one pread per shard touched (honest PFS-call accounting: ``read_calls``
counts physical preads, not logical ranges).

Layout on disk for ``path``:

  * ``path + ".shards.json"`` — ``num_samples``/``sample_shape``/``dtype``
    plus ``shard_sizes`` (samples per shard, in global order), and
  * ``path + ".shardNNNNN"`` (+ its ChunkStore header) per shard — each a
    standalone, independently-openable binary store.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np

from repro_torch.data.backends.base import (
    CoalescingReadsMixin,
    DatasetSpec,
    register_backend,
    synthetic_blocks,
)
from repro_torch.data.storage import _HEADER_SUFFIX, ChunkStore

_SHARDS_SUFFIX = ".shards.json"


def _shard_path(path: str, k: int) -> str:
    return f"{path}.shard{k:05d}"


@register_backend("sharded")
class ShardedBackend(CoalescingReadsMixin):
    """Multi-file shards; one :class:`ChunkStore` (fd pool) per shard."""

    backend_name = "sharded"

    def __init__(self, path: str, simulated_latency_s: float = 0.0):
        self.path = path
        with open(path + _SHARDS_SUFFIX) as f:
            hdr = json.load(f)
        self.num_samples = int(hdr["num_samples"])
        self.sample_shape = tuple(hdr["sample_shape"])
        self.dtype = np.dtype(hdr["dtype"])
        self.sample_bytes = int(
            self.dtype.itemsize * int(np.prod(self.sample_shape, dtype=np.int64))
        )
        sizes = [int(s) for s in hdr["shard_sizes"]]
        self.shards = [
            ChunkStore(_shard_path(path, k), simulated_latency_s=simulated_latency_s)
            for k in range(len(sizes))
        ]
        #: global start id of each shard, plus a trailing ``num_samples``.
        self._starts = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
        assert int(self._starts[-1]) == self.num_samples
        self._latency = float(simulated_latency_s)
        self._closed = False
        # Streaming-ingest write path: one lazily-opened r+b descriptor per
        # shard, serialized under a lock (readers pread their own fd pools).
        self._write_lock = threading.Lock()
        self._write_fds: dict[int, object] = {}

    # -- protocol: geometry + stats (delegated to the shards) -----------------

    def spec(self) -> DatasetSpec:
        return DatasetSpec(
            self.num_samples,
            self.sample_shape,
            self.dtype.str,
            num_shards=len(self.shards),
        )

    @property
    def simulated_latency_s(self) -> float:
        return self._latency

    @simulated_latency_s.setter
    def simulated_latency_s(self, value: float) -> None:
        self._latency = float(value)
        for s in self.shards:
            s.simulated_latency_s = self._latency

    @property
    def bytes_read(self) -> int:
        return sum(s.bytes_read for s in self.shards)

    @property
    def read_calls(self) -> int:
        return sum(s.read_calls for s in self.shards)

    @property
    def trace(self) -> list[tuple[int, int]]:
        out: list[tuple[int, int]] = []
        for s, base in zip(self.shards, self._starts.tolist()):
            out.extend((base + off, n) for off, n in s.trace)
        return out

    def reset_counters(self) -> None:
        for s in self.shards:
            s.reset_counters()

    # -- reads -----------------------------------------------------------------

    def read_range(self, start: int, stop: int) -> np.ndarray:
        """Ranged read; a span crossing shard boundaries costs one pread per
        shard touched."""
        if not 0 <= start < stop <= self.num_samples:
            raise IndexError((start, stop, self.num_samples))
        if self._closed:
            raise ValueError(f"store {self.path!r} is closed")
        k = int(np.searchsorted(self._starts, start, side="right")) - 1
        parts = []
        pos = int(start)
        while pos < stop:
            base, end = int(self._starts[k]), int(self._starts[k + 1])
            hi = min(int(stop), end)
            parts.append(self.shards[k].read_range(pos - base, hi - base))
            pos = hi
            k += 1
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    # -- ingest (streaming writers, DESIGN.md §10) -----------------------------

    @property
    def writable(self) -> bool:
        return True

    def write_rows(self, start: int, rows: np.ndarray) -> None:
        """Overwrite samples ``[start, start + len(rows))`` across shards.

        Writes go straight to the shard files (unbuffered), so same-host
        reader processes pread-ing the same inodes observe the new bytes —
        the property the distributed streaming runtime relies on.  Callers
        must :meth:`flush` before publishing a sealed manifest.
        """
        start = int(start)
        rows = np.ascontiguousarray(
            np.asarray(rows, self.dtype).reshape((-1,) + self.sample_shape)
        )
        stop = start + rows.shape[0]
        if not 0 <= start <= stop <= self.num_samples:
            raise IndexError((start, stop, self.num_samples))
        if self._closed:
            raise ValueError(f"store {self.path!r} is closed")
        if start == stop:
            return
        with self._write_lock:
            k = int(np.searchsorted(self._starts, start, side="right")) - 1
            pos = start
            while pos < stop:
                base, end = int(self._starts[k]), int(self._starts[k + 1])
                hi = min(stop, end)
                f = self._write_fds.get(k)
                if f is None:
                    f = open(_shard_path(self.path, k), "r+b", buffering=0)
                    self._write_fds[k] = f
                f.seek((pos - base) * self.sample_bytes)
                f.write(rows[pos - start : hi - start].tobytes())
                pos = hi
                k += 1

    def flush(self) -> None:
        with self._write_lock:
            for f in self._write_fds.values():
                os.fsync(f.fileno())

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        self._closed = True
        with self._write_lock:
            for f in self._write_fds.values():
                try:
                    f.close()
                except OSError:  # pragma: no cover - best effort
                    pass
            self._write_fds.clear()
        for s in self.shards:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass

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
        num_shards: int | None = None,
        **options,
    ) -> "ShardedBackend":
        if data is not None:
            spec = DatasetSpec(
                data.shape[0], data.shape[1:], np.dtype(data.dtype).str
            )
        if spec is None:
            raise ValueError("sharded create needs a DatasetSpec or a data array")
        n_shards = int(num_shards or spec.num_shards or 1)
        n_shards = max(1, min(n_shards, spec.num_samples))
        per = -(-spec.num_samples // n_shards)  # ceil division
        sizes = [
            min(per, spec.num_samples - k * per) for k in range(n_shards)
        ]
        sizes = [s for s in sizes if s > 0]
        starts = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
        with open(path + _SHARDS_SUFFIX, "w") as f:
            json.dump(
                {
                    "num_samples": spec.num_samples,
                    "sample_shape": list(spec.sample_shape),
                    "dtype": spec.dtype,
                    "shard_sizes": sizes,
                },
                f,
            )
        files = []
        try:
            for k, size in enumerate(sizes):
                sp = _shard_path(path, k)
                with open(sp + _HEADER_SUFFIX, "w") as f:
                    json.dump(
                        {
                            "num_samples": size,
                            "sample_shape": list(spec.sample_shape),
                            "dtype": spec.dtype,
                        },
                        f,
                    )
                files.append(open(sp, "wb"))
            # Stream global-order blocks across the shard boundaries, so the
            # concatenated shard bytes are identical to the binary layout.
            blocks = (
                ((0, data),)
                if data is not None
                else synthetic_blocks(
                    spec.num_samples, spec.sample_shape, spec.np_dtype, fill, seed
                )
            )
            for b_start, rows in blocks:
                b_stop = b_start + rows.shape[0]
                k = int(np.searchsorted(starts, b_start, side="right")) - 1
                pos = b_start
                while pos < b_stop:
                    hi = min(b_stop, int(starts[k + 1]))
                    np.ascontiguousarray(rows[pos - b_start : hi - b_start]).tofile(
                        files[k]
                    )
                    pos = hi
                    k += 1
        finally:
            for f in files:
                f.close()
        return cls(path, **options)

    @classmethod
    def exists(cls, path: str) -> bool:
        return os.path.exists(path + _SHARDS_SUFFIX)
