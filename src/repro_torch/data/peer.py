"""Peer-fetch runtime: serving planned inter-node buffer fetches.

The offline scheduler records, per node-step, which misses are served from a
sibling node's buffer instead of the PFS (:class:`~repro_torch.core.plan.PeerFetch`,
DESIGN.md §6).  This module executes those fetches behind one transport
interface.  :class:`SharedViewTransport` is the in-process transport: every
"node" is a :class:`~repro_torch.data.loaders._DataMirror` in this process,
so a fetch is a vectorized arena gather.  It is the semantic reference:
digest parity against the PFS path is proved against it.  The socket
transport over per-node buffer servers is not ported yet
(:class:`SocketTransport` raises; ROADMAP.md Queue 1 slice 6).

Ordering contract: all of a step's peer fetches must be issued against the
buffer state at the *start* of the step — i.e. before any node applies that
step's admission/eviction deltas — because the plan guarantees residency
only at step start (the source may evict the sample in the same step).
:meth:`repro_torch.data.loaders.ScheduleExecutor.gather_peers` upholds this by
gathering every node's peer rows before ``execute_step`` touches a mirror.

Samples a transport cannot produce are *not* errors here: the exchange
reports them as fallbacks and the loader re-reads them from the PFS, so the
tier degrades to correctness-preserving slow paths, never wrong bytes.
"""
from __future__ import annotations

from typing import Callable, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.plan import PeerFetch
from repro_torch.obs import trace as obs_trace

__all__ = [
    "PeerTransport",
    "SharedViewTransport",
    "SocketTransport",
    "PeerExchange",
]


@runtime_checkable
class PeerTransport(Protocol):
    """One fetch primitive: rows of ``ids`` out of ``source``'s buffer.

    Returns ``(rows, ok)`` where ``ok`` is a boolean mask over ``ids`` and
    ``rows`` holds one row per True entry, in ``ids[ok]`` order.
    """

    def fetch(
        self, source: int, ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]: ...


class SharedViewTransport:
    """In-process transport over the per-node buffer mirrors.

    ``mirror_of`` resolves a node id to its live
    :class:`~repro_torch.data.loaders._DataMirror` (the loader passes its own
    accessor, so mirrors created lazily are always current).  Rows are
    copied out of the arena (numpy fancy indexing), so later evictions on
    the source cannot corrupt an already-fetched batch.
    """

    def __init__(self, mirror_of: Callable[[int], object]):
        self._mirror_of = mirror_of

    def fetch(self, source: int, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        mirror = self._mirror_of(source)
        slots = mirror.lookup(np.asarray(ids, np.int64))
        ok = slots >= 0
        return mirror.rows(slots[ok]), ok


class SocketTransport:
    """Socket-RPC transport over per-node buffer servers: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the socket peer transport is not ported yet: ROADMAP.md Queue 1 "
            "slice 6"
        )


class PeerExchange:
    """Executes one node-step's planned peer fetches through a transport.

    Groups fetches by source node (one transport call per source), tracks
    served/fallback counts and per-source serve totals, and returns only the
    rows the transport produced — callers route the rest to the PFS.
    """

    def __init__(
        self,
        transport: PeerTransport,
        sample_shape: tuple[int, ...],
        dtype,
    ):
        self.transport = transport
        self.sample_shape = tuple(int(x) for x in sample_shape)
        self.dtype = np.dtype(dtype)
        self.served = 0
        self.fallbacks = 0
        #: samples served *by* each source node (serving-load accounting).
        self.served_by_source: dict[int, int] = {}

    def gather(
        self, fetches: Sequence[PeerFetch]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fetch every sample in ``fetches`` from its planned source.

        Returns ``(ids, rows, missing_ids)``: ``rows[i]`` is the sample
        ``ids[i]``, and ``missing_ids`` lists samples the transport could
        not serve (counted as fallbacks; the caller reads them from the
        store).
        """
        if not fetches:
            empty = np.empty(0, np.int64)
            return empty, np.empty((0,) + self.sample_shape, self.dtype), empty
        tr = obs_trace.get()
        t0 = tr.t()
        ids = np.asarray([f.sample for f in fetches], np.int64)
        srcs = np.asarray([f.source for f in fetches], np.int64)
        rows = np.empty((ids.size,) + self.sample_shape, self.dtype)
        ok_all = np.zeros(ids.size, bool)
        for src in np.unique(srcs).tolist():
            sel = np.flatnonzero(srcs == src)
            got, ok = self.transport.fetch(src, ids[sel])
            rows[sel[ok]] = got
            ok_all[sel[ok]] = True
            self.served_by_source[src] = (
                self.served_by_source.get(src, 0) + int(ok.sum())
            )
        self.served += int(ok_all.sum())
        self.fallbacks += int((~ok_all).sum())
        tr.rec(obs_trace.PEER_GATHER, t0, a=ids.size)
        return ids[ok_all], rows[ok_all], ids[~ok_all]
