"""Peer-fetch runtime: serving planned inter-node buffer fetches.

The offline scheduler records, per node-step, which misses are served from a
sibling node's buffer instead of the PFS (:class:`~repro_torch.core.plan.PeerFetch`,
DESIGN.md §6).  This module executes those fetches behind one transport
interface:

  * :class:`SharedViewTransport` — the in-process emulation used by the
    loader zoo and the benchmarks: every "node" is a
    :class:`~repro_torch.data.loaders._DataMirror` in this process, so a fetch is
    a vectorized arena gather.  This is the semantic reference: digest
    parity against the PFS path is proved against it.
  * :class:`SocketTransport` — the real deployment transport: every node
    runs a :class:`~repro_torch.runtime.server.BufferServer` over its buffer
    arena, and a fetch is one framed request/response round trip on the
    training interconnect (:mod:`repro_torch.runtime.wire` — length-prefixed
    frames, SHA-256 checksums, geometry negotiation on connect).  Any wire
    failure — truncated frame, checksum mismatch, dead peer, a stale-step
    refusal from the server — degrades to "nothing served" and the loader
    re-reads from the PFS; only a *geometry* disagreement fails loudly
    (:class:`~repro_torch.runtime.wire.HandshakeError`), because silently
    PFS-falling-back forever would mask a misconfigured deployment.
    Hand it to :func:`repro_torch.data.pipeline.execute` as
    ``peer_transport=``; the multi-process launcher that wires one per rank
    is not ported yet (ROADMAP.md Queue 1 slice 6).

Ordering contract: all of a step's peer fetches must be issued against the
buffer state at the *start* of the step — i.e. before any node applies that
step's admission/eviction deltas — because the plan guarantees residency
only at step start (the source may evict the sample in the same step).
:meth:`repro_torch.data.loaders.ScheduleExecutor.gather_peers` upholds this by
gathering every node's peer rows before ``execute_step`` touches a mirror.

Samples a transport cannot produce (possible only if the ordering contract
is broken, or a remote node died) are *not* errors here: the exchange
reports them as fallbacks and the loader re-reads them from the PFS, so the
tier degrades to correctness-preserving slow paths, never wrong bytes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import socket
import time
from typing import Callable, Mapping, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.plan import PeerFetch
from repro_torch.obs import trace as obs_trace

__all__ = [
    "AddressBookError",
    "PeerTransport",
    "RetryPolicy",
    "Breaker",
    "SharedViewTransport",
    "SocketTransport",
    "PeerExchange",
]


class AddressBookError(ValueError):
    """An invalid peer address book: duplicate ``(host, port)`` endpoints,
    a node's own endpoint listed as a peer, or an out-of-range port."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """The graded failure ladder for socket peer fetches (DESIGN.md §9).

    Rung 1 — **retry**: a failed fetch (dial error, wire error, refusal) is
    retried up to ``max_attempts`` times total, sleeping an exponentially
    growing backoff with seeded jitter between attempts.  Transient blips
    (one reset, one corrupt frame) cost one retry, not a PFS fallback.

    Rung 2 — **circuit breaker**, per source: ``breaker_threshold``
    *consecutive* exhausted fetches open the breaker; while open, fetches to
    that source short-circuit straight to PFS fallback (no dial, no
    hammering a struggling peer).  After ``breaker_cooldown_s`` the breaker
    goes half-open and admits exactly one probe fetch — success closes it,
    failure re-opens it.

    Rung 3 — **escalation**: once the breaker has opened
    ``escalate_after`` times without an intervening success, the transport
    invokes its escalation callback (the launcher routes this to the control
    plane's suspect path).  The coordinator — which sees heartbeats the data
    plane does not — arbitrates; the transport never declares anyone dead.

    All sleeps derive from ``seed`` so a chaos run's timing is reproducible.
    """

    max_attempts: int = 2
    backoff_base_s: float = 0.02
    backoff_max_s: float = 0.25
    jitter: float = 0.5
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 0.5
    escalate_after: int = 2
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}"
            )

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry ``attempt`` (0-based): exp growth + jitter."""
        base = min(self.backoff_base_s * (2 ** attempt), self.backoff_max_s)
        return base * (1.0 + self.jitter * rng.random())


class _Breaker:
    """Per-source circuit breaker state machine (clock injected for tests)."""

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.opens_in_row = 0

    def allow(self, now: float) -> bool:
        """May we attempt a fetch right now?  Open→half-open on cooldown."""
        if self.state == "open":
            if now - self.opened_at >= self.policy.breaker_cooldown_s:
                self.state = "half_open"
                return True
            return False
        return True

    def success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self.opens_in_row = 0

    def failure(self, now: float) -> bool:
        """Record an exhausted fetch; True when this transition *opened*."""
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.policy.breaker_threshold:
            self.state = "open"
            self.opened_at = now
            self.failures = 0
            self.opens_in_row += 1
            return True
        return False


#: Public alias: the serve tier's ``DataTierClient`` drives the same
#: per-endpoint breaker state machine the trainer transport does
#: (DESIGN.md §12) — one ladder, two consumers.
Breaker = _Breaker


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
    """Socket-RPC transport over per-node buffer servers.

    ``endpoints`` maps *peer* node id -> ``(host, port)`` of that node's
    :class:`~repro_torch.runtime.server.BufferServer`.  The address book is
    validated up front with named errors (:class:`AddressBookError`):
    duplicate ``(host, port)`` pairs (two nodes cannot share one server),
    ``self_node`` listed among the peers (a node never dials itself — its
    own samples are served straight from the local mirror via
    ``mirror_of``), and out-of-range ports.

    One persistent connection per source, established lazily with a
    geometry handshake (expected node id, sample shape, dtype — the server
    refuses a mismatched client, and the mismatch raises
    :class:`~repro_torch.runtime.wire.HandshakeError` here).  :meth:`at_step`
    stamps subsequent fetches with the requester's global step index, which
    the serving side uses as its step-epoch guard.

    Failure semantics follow the graded ladder in :class:`RetryPolicy`:
    bounded retries with backoff+jitter, then a per-source circuit breaker
    (open → temporary PFS routing → half-open probe → close), then
    escalation through ``escalate`` (the launcher's suspect path) once the
    breaker trips persistently.  Every rung is counted (``retries``,
    ``breaker_opens``, ``breaker_skips``, ``escalations``,
    ``unknown_source_fallbacks``) and surfaced through :meth:`stats` into
    ``LoaderReport.summary()``.  The failed connection is dropped and
    redialed on the next allowed fetch, so a restarted peer is picked back
    up automatically.

    The book is *dynamic*: the launcher's recovery path calls
    :meth:`update_endpoints` when node ownership moves to a different
    surviving rank, and :meth:`add_local` when *this* rank adopts a node —
    from then on that node's rows come from the adopted local mirror, not a
    socket.
    """

    def __init__(
        self,
        endpoints: Mapping[int, tuple[str, int]],
        *,
        timeout_s: float = 1.0,
        self_node: int | None = None,
        mirror_of: Callable[[int], object] | None = None,
        sample_shape: tuple[int, ...] | None = None,
        dtype=None,
        retry: RetryPolicy | None = None,
        escalate: Callable[[int], None] | None = None,
    ):
        self.endpoints = {
            int(node): (str(host), int(port))
            for node, (host, port) in endpoints.items()
        }
        self.timeout_s = float(timeout_s)
        self.self_node = None if self_node is None else int(self_node)
        self._mirror_of = mirror_of
        self.sample_shape = (
            None if sample_shape is None
            else tuple(int(x) for x in sample_shape)
        )
        self.dtype = None if dtype is None else np.dtype(dtype)
        self._step = -1
        self._window: int | None = None
        self._conns: dict[int, socket.socket] = {}
        self.retry = retry if retry is not None else RetryPolicy()
        self._escalate = escalate
        self._local: set[int] = set()
        self._breakers: dict[int, _Breaker] = {}
        self._rngs: dict[int, random.Random] = {}
        self.retries = 0
        self.breaker_opens = 0
        self.breaker_skips = 0
        self.escalations = 0
        self.unknown_source_fallbacks = 0
        #: fetches that ended in a peer's *stale refusal* (window-skew guard
        #: or an ownership transition) — expected under skew, so they fall
        #: back to the PFS without charging the breaker/escalation ladder.
        self.stale_refusal_fallbacks = 0
        errs = []
        seen: dict[tuple[str, int], int] = {}
        for node in sorted(self.endpoints):
            host, port = self.endpoints[node]
            if not 0 < port < 65536:
                errs.append(f"node {node}: port {port} out of range [1, 65535]")
            if (host, port) in seen:
                errs.append(
                    f"duplicate endpoint {(host, port)} for nodes "
                    f"{seen[host, port]} and {node}"
                )
            seen[host, port] = node
        if self.self_node is not None and self.self_node in self.endpoints:
            errs.append(
                f"self-endpoint: node {self.self_node} lists itself as a "
                "peer — local samples are served from the local mirror, "
                "never over a socket"
            )
        if errs:
            raise AddressBookError(
                "invalid peer address book: " + "; ".join(errs)
            )

    def at_step(self, step: int, window: int | None = None) -> None:
        """Stamp subsequent fetches with the requester's global step index
        (the serving side's step-epoch guard, DESIGN.md §8).  With
        ``window`` given, fetches ride the windowed frame (``MSG_FETCHW``)
        so the serving side applies the window-skew guard instead of the
        exact-step guard (DESIGN.md §11)."""
        self._step = int(step)
        self._window = None if window is None else int(window)

    # -- elastic membership (launcher recovery path) ------------------------

    def update_endpoints(self, moved: Mapping[int, tuple[str, int]]) -> None:
        """Re-point sources whose owner changed (re-slice / rejoin).

        Pooled connections and breaker state for a moved source are
        discarded: the new owner starts with a clean slate.
        """
        for node, (host, port) in moved.items():
            node = int(node)
            if node == self.self_node or node in self._local:
                continue
            ep = (str(host), int(port))
            if self.endpoints.get(node) == ep:
                continue
            self.endpoints[node] = ep
            conn = self._conns.pop(node, None)
            if conn is not None:
                with contextlib.suppress(OSError):
                    conn.close()
            self._breakers.pop(node, None)

    def add_local(self, node: int) -> None:
        """This rank now owns ``node``: serve it from the local mirror."""
        node = int(node)
        self._local.add(node)
        self.endpoints.pop(node, None)
        conn = self._conns.pop(node, None)
        if conn is not None:
            with contextlib.suppress(OSError):
                conn.close()
        self._breakers.pop(node, None)

    def remove_local(self, node: int) -> None:
        """Ownership of ``node`` moved away (a rejoined rank reclaimed it)."""
        self._local.discard(int(node))

    def stats(self) -> dict:
        """Failure-ladder counters for ``LoaderReport`` aggregation."""
        return {
            "retries": self.retries,
            "breaker_opens": self.breaker_opens,
            "breaker_skips": self.breaker_skips,
            "escalations": self.escalations,
            "unknown_source_fallbacks": self.unknown_source_fallbacks,
            "stale_refusal_fallbacks": self.stale_refusal_fallbacks,
        }

    def _breaker(self, source: int) -> _Breaker:
        br = self._breakers.get(source)
        if br is None:
            br = self._breakers[source] = _Breaker(self.retry)
        return br

    def _rng(self, source: int) -> random.Random:
        rng = self._rngs.get(source)
        if rng is None:
            rng = self._rngs[source] = random.Random(
                (self.retry.seed << 17) ^ (source * 1000003 + 7)
            )
        return rng

    def close(self) -> None:
        """Drop every pooled connection (idempotent)."""
        conns, self._conns = self._conns, {}
        for conn in conns.values():
            with contextlib.suppress(OSError):
                conn.close()

    def __enter__(self) -> "SocketTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _fallback(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        shape = self.sample_shape or ()
        dtype = self.dtype if self.dtype is not None else np.float32
        return np.empty((0,) + tuple(shape), dtype), np.zeros(n, bool)

    def _connect(self, source: int) -> socket.socket:
        from repro_torch.runtime import faults, wire

        if faults.on_dial():
            raise ConnectionResetError(
                f"injected connection reset dialing peer {source}"
            )
        host, port = self.endpoints[source]
        conn = socket.create_connection((host, port), timeout=self.timeout_s)
        conn.settimeout(self.timeout_s)
        try:
            wire.send_frame(conn, wire.MSG_HELLO, wire.pack_json({
                "node": int(source),
                "shape": list(self.sample_shape),
                "dtype": self.dtype.str,
            }))
            msg_type, payload = wire.recv_frame(conn)
            if msg_type == wire.MSG_ERROR:
                reason = payload.decode(errors="replace")
                if "geometry mismatch" in reason:
                    # deployment misconfiguration: fail loudly, never retry.
                    raise wire.HandshakeError(
                        f"peer {source} refused the handshake: {reason}"
                    )
                if "not serving node" in reason:
                    # mid ownership transition (window-edge re-slice or a
                    # rejoin reclaim): expected under the epoch-window
                    # protocol — retriable, but never a breaker fault.
                    raise wire.StaleRefusal(
                        f"peer {source} refused the handshake: {reason}"
                    )
                # any other refusal is transient: retriable wire error.
                raise wire.ProtocolError(
                    f"peer {source} refused the handshake: {reason}"
                )
            if msg_type != wire.MSG_HELLO_OK:
                raise wire.ProtocolError(
                    f"expected HELLO_OK from peer {source}, got {msg_type}"
                )
        except BaseException:
            with contextlib.suppress(OSError):
                conn.close()
            raise
        return conn

    def fetch(self, source: int, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        from repro_torch.runtime import wire

        ids = np.asarray(ids, np.int64)
        if self.sample_shape is None or self.dtype is None:
            raise ValueError(
                "SocketTransport needs sample_shape and dtype (the store "
                "geometry) to decode row frames — construct it with both "
                "to fetch; endpoint-only construction is for config "
                "validation"
            )
        if (
            source == self.self_node or source in self._local
        ) and self._mirror_of is not None:
            # own (or adopted) holder: a zero-cost local arena gather,
            # never a socket.
            mirror = self._mirror_of(source)
            if mirror is not None:
                slots = mirror.lookup(ids)
                ok = slots >= 0
                if not ok.any():
                    return self._fallback(ids.size)[0], ok
                return mirror.rows(slots[ok]), ok
            return self._fallback(ids.size)
        if source not in self.endpoints:
            # a peer missing from the address book (died before registering,
            # or a misconfigured book): serve nothing, the loader falls back
            # to the PFS — counted so misconfiguration is visible, not slow.
            self.unknown_source_fallbacks += 1
            return self._fallback(ids.size)
        tr = obs_trace.get()
        breaker = self._breaker(source)
        if not breaker.allow(time.monotonic()):
            # breaker open: temporary PFS routing, no dial at all.
            self.breaker_skips += 1
            tr.instant(obs_trace.PEER_BREAKER_SKIP, a=source)
            return self._fallback(ids.size)
        t0 = tr.t()
        rng = self._rng(source)
        pooled = self._conns.pop(source, None)
        # A pooled connection may have been idled out by the server between
        # steps — staleness, not a dead peer — so it rides in front of the
        # policy's fresh-dial attempts and its failure costs a retry, not a
        # fallback.
        attempts: list[socket.socket | None] = [None] * self.retry.max_attempts
        if pooled is not None:
            attempts.insert(0, pooled)
        refused_stale = False
        for i, conn in enumerate(attempts):
            last = i == len(attempts) - 1
            try:
                if conn is None:
                    conn = self._connect(source)
                if self._window is not None:
                    wire.send_frame(
                        conn, wire.MSG_FETCHW,
                        wire.pack_fetchw(self._window, self._step, ids),
                        site="transport.fetch",
                    )
                else:
                    wire.send_frame(
                        conn, wire.MSG_FETCH, wire.pack_fetch(self._step, ids),
                        site="transport.fetch",
                    )
                msg_type, payload = wire.recv_frame(conn)
                if msg_type != wire.MSG_ROWS:
                    raise wire.ProtocolError(
                        f"expected ROWS from peer {source}, got {msg_type}"
                    )
                ok, rows = wire.unpack_rows(
                    payload, ids.size, self.sample_shape, self.dtype
                )
            except (wire.WireError, OSError) as exc:
                # truncated / corrupt / reset / dead peer: never wrong bytes
                # — drop the connection and climb the ladder.
                refused_stale = isinstance(exc, wire.StaleRefusal)
                if conn is not None:
                    with contextlib.suppress(OSError):
                        conn.close()
                if not last:
                    self.retries += 1
                    tr.instant(obs_trace.PEER_RETRY, a=source, b=i)
                    time.sleep(self.retry.backoff_s(i, rng))
                continue
            except BaseException:
                if conn is not None:
                    with contextlib.suppress(OSError):
                        conn.close()
                raise
            self._conns[source] = conn
            breaker.success()
            tr.rec(obs_trace.PEER_FETCH, t0, a=source, b=0)
            return rows, ok
        if refused_stale:
            # the final word was the peer's window-skew guard refusing —
            # expected under skew (DESIGN.md §11): PFS fallback, but no
            # breaker failure and no escalation.  Charging the ladder here
            # would open breakers (and suspect healthy ranks) every time
            # ownership moves across a window edge.
            self.stale_refusal_fallbacks += 1
            tr.rec(obs_trace.PEER_FETCH, t0, a=source, b=1)
            return self._fallback(ids.size)
        # every attempt exhausted: one breaker failure for the whole fetch.
        tr.rec(obs_trace.PEER_FETCH, t0, a=source, b=2)
        if breaker.failure(time.monotonic()):
            self.breaker_opens += 1
            tr.instant(obs_trace.PEER_BREAKER_OPEN, a=source)
            if (
                breaker.opens_in_row >= self.retry.escalate_after
                and self._escalate is not None
            ):
                self.escalations += 1
                self._escalate(source)
        return self._fallback(ids.size)


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
