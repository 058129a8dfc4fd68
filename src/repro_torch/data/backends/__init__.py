"""Pluggable storage backends behind one :class:`StorageBackend` protocol.

Four built-in layouts resolve through the registry:

  ========== ===========================================================
  ``binary``  flat file + JSON header, lock-free fd-pool preads
  ``hdf5``    chunked h5py dataset, chunk-aligned aggregated reads
              (optional dependency — construction fails without h5py)
  ``memory``  dataset staged into host RAM (ideal lower bound / tests)
  ``sharded`` multi-file shards, one fd pool per shard (multi-node realism)
  ========== ===========================================================

Open / create through the registry (:func:`open_store` /
:func:`create_store`) or declaratively through
:class:`repro_torch.data.pipeline.LoaderSpec`.  Concrete backend classes are
imported lazily (``from repro_torch.data.backends import Hdf5Backend`` works, but
the submodule loads on first access) so that ``repro_torch.data.storage`` —
which the ``binary`` backend wraps — can import :mod:`.base` without a
cycle.
"""
from repro_torch.data.backends.base import (
    BaseBackend,
    CoalescingReadsMixin,
    DatasetSpec,
    StorageBackend,
    backend_names,
    create_store,
    get_backend,
    open_store,
    register_backend,
    synthetic_blocks,
)

_LAZY_EXPORTS = {
    "BinaryBackend": ("repro_torch.data.backends.binary", "BinaryBackend"),
    "Hdf5Backend": ("repro_torch.data.backends.hdf5", "Hdf5Backend"),
    "HAVE_H5PY": ("repro_torch.data.backends.hdf5", "HAVE_H5PY"),
    "MemoryBackend": ("repro_torch.data.backends.memory", "MemoryBackend"),
    "ShardedBackend": ("repro_torch.data.backends.sharded", "ShardedBackend"),
}


def __getattr__(name):  # PEP 562: lazy submodule exports
    if name in _LAZY_EXPORTS:
        import importlib

        module, attr = _LAZY_EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)


__all__ = [
    "BaseBackend",
    "BinaryBackend",
    "CoalescingReadsMixin",
    "DatasetSpec",
    "HAVE_H5PY",
    "Hdf5Backend",
    "MemoryBackend",
    "ShardedBackend",
    "StorageBackend",
    "backend_names",
    "create_store",
    "get_backend",
    "open_store",
    "register_backend",
    "synthetic_blocks",
]
