"""Multi-tenant data tier: the buffer tier as a cluster-wide read cache.

SOLAR's buffer tier exists so planned trainer traffic almost never touches
the PFS.  This module opens the same tier to *unplanned* consumers —
evaluators, inference replicas, anything reading samples by id — without
giving them a training plan, and without letting them disturb the training
fast path (DESIGN.md §12):

  * :class:`DataTierClient` attaches to per-node
    :class:`~repro_torch.runtime.server.BufferServer`\\ s with a tenant id + auth
    token (``MSG_ATTACH``), reads rows by sample id (``MSG_READ``), and
    honors load-shed hints (``MSG_SHED``).  Failures climb exactly the
    trainer transport's retry/breaker ladder (:class:`~repro_torch.data.peer.RetryPolicy`); sheds are
    admission control, not faults, and never charge the breaker.
  * :class:`ResidencyIndex` replays the schedule's admission/eviction
    deltas into an id -> owning-node map, so a server that misses locally
    routes the read to the peer that has the sample (via the launcher's
    address book) before falling back to the PFS — the
    :class:`TierRouter` ladder.  The index tracks *this rank's* step
    cursor; under window skew a stale route is only ever a miss (the peer
    answers all-False and the ladder falls through to the PFS), never
    wrong bytes: rows are immutable by id.
  * :class:`PlanService` exposes a :class:`~repro_torch.core.planners.PlanCache`
    over the control-plane wire format so tenants resolve schedules by
    content hash instead of shared-filesystem paths; the client refuses any
    artifact whose recomputed digest disagrees (distribution by hash, never
    by trust — the same rule ranks apply to their plan).

Deliberately numpy-only (no torch import): inference replicas wire it into
:class:`repro_torch.serve.engine.ServeEngine`, but the tier itself runs
anywhere the runtime does.

Own copy of the JAX package's ``serve/datatier.py``: its clients attach to
either package's servers and its servers serve either package's clients,
bit for bit; :func:`rows_to_prompts` maps rows to the same prompts.  The
multi-process launcher that calls :func:`wire_rank_tier` per rank is not
ported yet (ROADMAP.md Queue 1 slice 6); :class:`StandaloneTier` stands up
a one-node tier without it.
"""
from __future__ import annotations

import base64
import contextlib
import dataclasses
import os
import random
import socket
import tempfile
import threading
import time

import numpy as np

from repro_torch.data.peer import Breaker, RetryPolicy
from repro_torch.runtime import wire
from repro_torch.runtime.server import INTERNAL_TENANT, BufferServer, TokenBucket

__all__ = [
    "TierError",
    "TierAuthError",
    "TenantConfig",
    "ServeTierConfig",
    "TokenBucket",
    "ResidencyIndex",
    "TierRouter",
    "TierPeerReader",
    "DataTierClient",
    "PlanService",
    "PlanServiceClient",
    "StandaloneTier",
    "RankTier",
    "wire_rank_tier",
    "rows_to_prompts",
]


class TierError(RuntimeError):
    """A data-tier configuration or protocol failure."""


class TierAuthError(TierError):
    """The server refused this tenant's ATTACH (bad token, unknown tenant,
    or geometry disagreement).  Loud on purpose — the
    :class:`~repro_torch.runtime.wire.HandshakeError` rule: silently degrading a
    misconfigured tenant to permanent fallback would mask the bug."""


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's identity and admission budget.

    ``rate`` is samples/second through the server-side
    :class:`~repro_torch.runtime.server.TokenBucket` (``None`` = unlimited),
    ``burst`` the bucket depth (defaults to one second of ``rate``).
    """

    tenant: int
    token: str
    rate: float | None = None
    burst: float | None = None


@dataclasses.dataclass(frozen=True)
class ServeTierConfig:
    """Cluster-wide tenant-serving configuration (picklable: it rides the
    launcher's rank cfg dict into every spawned rank).

    ``cluster_token`` authenticates server-to-server proxy reads
    (:data:`~repro_torch.runtime.server.INTERNAL_TENANT`); the launcher defaults
    it to a digest-derived secret shared by construction.  ``queue_depth``
    bounds concurrently-processing tenant reads per server;
    ``tenant_wait_s`` bounds how long a read defers to trainer traffic
    before contending normally.  ``plan_service`` stands up the parent-side
    :class:`PlanService` over the run's schedule.
    """

    tenants: tuple[TenantConfig, ...]
    queue_depth: int = 8
    cluster_token: str | None = None
    plan_service: bool = True
    tenant_wait_s: float = 0.2

    def validate(self) -> None:
        if not self.tenants:
            raise TierError("ServeTierConfig needs at least one tenant")
        if self.queue_depth < 1:
            raise TierError(
                f"queue_depth must be >= 1, got {self.queue_depth}"
            )
        seen: set[int] = set()
        for t in self.tenants:
            tid = int(t.tenant)
            if tid == INTERNAL_TENANT:
                raise TierError(
                    f"tenant id {INTERNAL_TENANT} is reserved for proxy reads"
                )
            if tid in seen:
                raise TierError(f"duplicate tenant id {tid}")
            seen.add(tid)


# ---------------------------------------------------------------------------
# Residency index + miss routing
# ---------------------------------------------------------------------------


class ResidencyIndex:
    """id -> owning-node map, replayed from the schedule's planned deltas.

    The schedule IR already records, per (step, node), exactly which sample
    ids are admitted and evicted (the deltas the executor replays) — so
    residency at any step boundary is a pure fold over them, no runtime
    introspection of remote mirrors required.  :meth:`advance_to` folds up
    to start-of-step ``step`` (cheap: each delta applies once);
    :meth:`locate` answers ``-1`` for unknown ids.

    The map is *advisory*: under window skew a peer may have already
    evicted what this rank's cursor says it holds.  A wrong route costs one
    proxied miss (the peer answers all-False and the
    :class:`TierRouter` falls through to the PFS) — never wrong bytes.
    """

    def __init__(self, schedule):
        self._deltas: list[list[tuple[int, np.ndarray, np.ndarray]]] = [
            [(npn.node, npn.admissions, npn.evictions) for npn in sp.nodes]
            for ep in schedule.epochs
            for sp in ep.steps
        ]
        self._owner: dict[int, int] = {}
        self._applied = 0
        self._lock = threading.Lock()

    @property
    def applied(self) -> int:
        with self._lock:
            return self._applied

    def advance_to(self, step: int) -> None:
        """Fold deltas so the map reflects start-of-step ``step``."""
        target = min(int(step), len(self._deltas))
        with self._lock:
            while self._applied < target:
                for node, admissions, evictions in self._deltas[self._applied]:
                    # eviction before admission, matching the executor's
                    # replay order within a step.
                    for s in evictions.tolist():
                        if self._owner.get(s) == node:
                            del self._owner[s]
                    for s in admissions.tolist():
                        self._owner[s] = node
                self._applied += 1

    def locate(self, ids: np.ndarray) -> np.ndarray:
        """Owning node per id (``-1`` = not resident anywhere right now)."""
        ids = np.asarray(ids, np.int64)
        with self._lock:
            return np.fromiter(
                (self._owner.get(int(i), -1) for i in ids),
                np.int64, count=ids.size,
            )


class TierPeerReader:
    """Server-to-server proxy reads: one pooled internal connection per
    sibling :class:`~repro_torch.runtime.server.BufferServer`.

    Proxy frames attach as :data:`~repro_torch.runtime.server.INTERNAL_TENANT`
    (cluster-token auth, no per-tenant bucket — the entry server already
    admitted the read once) and carry ``forward=False`` so a miss at the
    sibling terminates there instead of bouncing onward.  Any failure —
    wire error, shed, dead sibling — is "nothing served": the router falls
    through to the PFS.  One stale-connection retry per read, like the
    transport's pooled-dial rung.
    """

    def __init__(
        self,
        endpoints: dict[int, tuple[str, int]],
        *,
        token: str,
        sample_shape: tuple[int, ...],
        dtype,
        timeout_s: float = 2.0,
    ):
        self.endpoints = {
            int(n): (str(h), int(p)) for n, (h, p) in endpoints.items()
        }
        self.token = str(token)
        self.sample_shape = tuple(int(x) for x in sample_shape)
        self.dtype = np.dtype(dtype)
        self.timeout_s = float(timeout_s)
        self._conns: dict[int, socket.socket] = {}
        self._lock = threading.Lock()

    def _attach(self, node: int) -> socket.socket:
        host, port = self.endpoints[node]
        conn = socket.create_connection((host, port), timeout=self.timeout_s)
        conn.settimeout(self.timeout_s)
        try:
            wire.send_frame(conn, wire.MSG_ATTACH, wire.pack_json({
                "tenant": INTERNAL_TENANT,
                "token": self.token,
                "shape": list(self.sample_shape),
                "dtype": self.dtype.str,
            }))
            msg_type, payload = wire.recv_frame(conn)
            if msg_type != wire.MSG_ATTACH_OK:
                raise wire.ProtocolError(
                    f"sibling {node} refused the proxy attach: "
                    f"{payload.decode(errors='replace')}"
                )
        except BaseException:
            with contextlib.suppress(OSError):
                conn.close()
            raise
        return conn

    def read(self, node: int, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Rows of ``ids`` out of ``node``'s mirrors; dense ``(rows, ok)``
        with ``rows[i]`` valid only where ``ok[i]``."""
        ids = np.asarray(ids, np.int64)
        out = np.empty((ids.size,) + self.sample_shape, self.dtype)
        none = np.zeros(ids.size, bool)
        if node not in self.endpoints:
            return out, none
        with self._lock:
            pooled = self._conns.pop(node, None)
        for conn in (pooled, None):
            try:
                if conn is None:
                    conn = self._attach(node)
                wire.send_frame(
                    conn, wire.MSG_READ,
                    wire.pack_read(INTERNAL_TENANT, ids, forward=False),
                )
                msg_type, payload = wire.recv_frame(conn)
                if msg_type == wire.MSG_SHED:
                    # a shed sibling is healthy, just busy: keep the
                    # connection, serve nothing, let the PFS cover it.
                    with self._lock:
                        self._conns[node] = conn
                    return out, none
                if msg_type != wire.MSG_ROWS:
                    raise wire.ProtocolError(
                        f"expected ROWS from sibling {node}, got {msg_type}"
                    )
                ok, rows = wire.unpack_rows(
                    payload, ids.size, self.sample_shape, self.dtype
                )
            except (wire.WireError, OSError):
                if conn is not None:
                    with contextlib.suppress(OSError):
                        conn.close()
                conn = None
                continue
            with self._lock:
                self._conns[node] = conn
            out[ok] = rows
            return out, ok
        return out, none

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, {}
        for conn in conns.values():
            with contextlib.suppress(OSError):
                conn.close()


class TierRouter:
    """The miss ladder a :class:`~repro_torch.runtime.server.BufferServer` runs
    for tenant reads its local mirrors cannot serve:

        residency-routed sibling read  ->  PFS scattered read

    Returns ``(rows, ok, peer_mask)`` dense over the asked ids so the
    server attributes hits to ``tenant_peer_reads`` vs
    ``tenant_pfs_fallbacks`` per tenant.  Every stage is optional: with no
    store the ladder bottoms out at "unserved" (the client sees a False
    mask), with no residency/peers every miss goes straight to the PFS.
    """

    def __init__(
        self,
        *,
        sample_shape: tuple[int, ...],
        dtype,
        residency: ResidencyIndex | None = None,
        peers: TierPeerReader | None = None,
        store=None,
    ):
        self.sample_shape = tuple(int(x) for x in sample_shape)
        self.dtype = np.dtype(dtype)
        self.residency = residency
        self.peers = peers
        self.store = store

    def __call__(self, ids: np.ndarray):
        ids = np.asarray(ids, np.int64)
        out = np.empty((ids.size,) + self.sample_shape, self.dtype)
        ok = np.zeros(ids.size, bool)
        peer_mask = np.zeros(ids.size, bool)
        if self.residency is not None and self.peers is not None:
            nodes = self.residency.locate(ids)
            for node in np.unique(nodes[nodes >= 0]).tolist():
                sel = np.flatnonzero(nodes == node)
                rows, got = self.peers.read(node, ids[sel])
                if got.any():
                    out[sel[got]] = rows[got]
                    ok[sel[got]] = True
                    peer_mask[sel[got]] = True
        missing = np.flatnonzero(~ok)
        if missing.size and self.store is not None:
            out[missing] = self.store.read_scattered(ids[missing])
            ok[missing] = True
        return out, ok, peer_mask


# ---------------------------------------------------------------------------
# Tenant client
# ---------------------------------------------------------------------------


class DataTierClient:
    """A tenant's handle on the cluster's buffer tier.

    ``endpoints`` maps node -> ``(host, port)`` of that node's buffer
    server; reads spread across them by ``id % len(endpoints)`` (any server
    proxies misses cluster-wide, so routing is load-spreading, not
    correctness).  Geometry is negotiated: construct without
    ``sample_shape``/``dtype`` and the first ATTACH_OK's echo is adopted.

    Failure semantics reuse the trainer transport's ladder verbatim
    (:class:`~repro_torch.data.peer.RetryPolicy` + per-endpoint breakers): wire
    errors and dead servers cost retries, then breaker opens, then
    short-circuit skips.  ``MSG_SHED`` is *not* a failure: the client
    honors the retry-after hint (clamped to ``shed_wait_s``) up to
    ``max_shed_retries`` times, counts it, and never charges the breaker.
    Ids a read cannot serve come back as a False mask, never an exception:
    tenants choose their own fallback.
    """

    def __init__(
        self,
        endpoints: dict[int, tuple[str, int]],
        *,
        tenant: int,
        token: str,
        sample_shape: tuple[int, ...] | None = None,
        dtype=None,
        timeout_s: float = 5.0,
        retry: RetryPolicy | None = None,
        shed_wait_s: float = 1.0,
        max_shed_retries: int = 3,
    ):
        if not endpoints:
            raise TierError("DataTierClient needs at least one endpoint")
        self.endpoints = {
            int(n): (str(h), int(p)) for n, (h, p) in endpoints.items()
        }
        self.tenant = int(tenant)
        self.token = str(token)
        self.sample_shape = (
            None if sample_shape is None
            else tuple(int(x) for x in sample_shape)
        )
        self.dtype = None if dtype is None else np.dtype(dtype)
        self.timeout_s = float(timeout_s)
        self.retry = retry if retry is not None else RetryPolicy()
        self.shed_wait_s = float(shed_wait_s)
        self.max_shed_retries = int(max_shed_retries)
        self._order = sorted(self.endpoints)
        self._conns: dict[int, socket.socket] = {}
        self._breakers: dict[int, Breaker] = {}
        self._rngs: dict[int, random.Random] = {}
        self._lock = threading.Lock()
        # -- counters (mirroring SocketTransport.stats() vocabulary) --------
        self.reads = 0
        self.rows_served = 0
        self.rows_unserved = 0
        self.sheds = 0
        self.shed_give_ups = 0
        self.retries = 0
        self.breaker_opens = 0
        self.breaker_skips = 0

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, {}
        for conn in conns.values():
            with contextlib.suppress(OSError):
                conn.close()

    def __enter__(self) -> "DataTierClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        return {
            "reads": self.reads,
            "rows_served": self.rows_served,
            "rows_unserved": self.rows_unserved,
            "sheds": self.sheds,
            "shed_give_ups": self.shed_give_ups,
            "retries": self.retries,
            "breaker_opens": self.breaker_opens,
            "breaker_skips": self.breaker_skips,
        }

    # -- wire ----------------------------------------------------------------

    def _attach(self, node: int) -> socket.socket:
        host, port = self.endpoints[node]
        conn = socket.create_connection((host, port), timeout=self.timeout_s)
        conn.settimeout(self.timeout_s)
        try:
            att = {"tenant": self.tenant, "token": self.token}
            if self.sample_shape is not None and self.dtype is not None:
                att["shape"] = list(self.sample_shape)
                att["dtype"] = self.dtype.str
            wire.send_frame(conn, wire.MSG_ATTACH, wire.pack_json(att))
            msg_type, payload = wire.recv_frame(conn)
            if msg_type == wire.MSG_ERROR:
                reason = payload.decode(errors="replace")
                # auth and geometry refusals are deployment bugs: loud,
                # never silently degraded (the HandshakeError rule).
                raise TierAuthError(
                    f"server for node {node} refused the attach: {reason}"
                )
            if msg_type != wire.MSG_ATTACH_OK:
                raise wire.ProtocolError(
                    f"expected ATTACH_OK from node {node}, got {msg_type}"
                )
            echo = wire.unpack_json(payload)
            shape = tuple(int(x) for x in echo.get("shape", ()))
            dtype = np.dtype(echo.get("dtype"))
            if self.sample_shape is None or self.dtype is None:
                self.sample_shape, self.dtype = shape, dtype
            elif (shape, dtype) != (self.sample_shape, self.dtype):
                raise TierAuthError(
                    f"node {node} serves geometry {(shape, dtype.str)}, "
                    f"client negotiated {(self.sample_shape, self.dtype.str)}"
                )
        except BaseException:
            with contextlib.suppress(OSError):
                conn.close()
            raise
        return conn

    def _breaker(self, node: int) -> Breaker:
        br = self._breakers.get(node)
        if br is None:
            br = self._breakers[node] = Breaker(self.retry)
        return br

    def _rng(self, node: int) -> random.Random:
        rng = self._rngs.get(node)
        if rng is None:
            rng = self._rngs[node] = random.Random(
                (self.retry.seed << 17) ^ (node * 1000003 + 13)
            )
        return rng

    def _read_node(
        self, node: int, ids: np.ndarray
    ) -> tuple[np.ndarray | None, np.ndarray | None]:
        """One node's read through the full ladder; ``(None, None)`` when
        nothing could be served (breaker open, retries exhausted, shed
        budget spent)."""
        breaker = self._breaker(node)
        if not breaker.allow(time.monotonic()):
            self.breaker_skips += 1
            return None, None
        rng = self._rng(node)
        with self._lock:
            pooled = self._conns.pop(node, None)
        sheds_left = self.max_shed_retries
        attempts: list[socket.socket | None] = [None] * self.retry.max_attempts
        if pooled is not None:
            attempts.insert(0, pooled)
        i = 0
        while i < len(attempts):
            conn = attempts[i]
            last = i == len(attempts) - 1
            try:
                if conn is None:
                    conn = self._attach(node)
                wire.send_frame(
                    conn, wire.MSG_READ, wire.pack_read(self.tenant, ids)
                )
                msg_type, payload = wire.recv_frame(conn)
                if msg_type == wire.MSG_SHED:
                    retry_after, _reason = wire.unpack_shed(payload)
                    self.sheds += 1
                    if sheds_left <= 0:
                        # shed budget spent: report unserved — the server
                        # is healthy, so the breaker stays untouched.
                        self.shed_give_ups += 1
                        with self._lock:
                            self._conns[node] = conn
                        return None, None
                    sheds_left -= 1
                    time.sleep(min(retry_after, self.shed_wait_s))
                    attempts[i] = conn  # same connection, free re-attempt
                    continue
                if msg_type != wire.MSG_ROWS:
                    raise wire.ProtocolError(
                        f"expected ROWS from node {node}, got {msg_type}"
                    )
                ok, rows = wire.unpack_rows(
                    payload, ids.size, self.sample_shape, self.dtype
                )
            except (wire.WireError, OSError):
                if conn is not None:
                    with contextlib.suppress(OSError):
                        conn.close()
                if not last:
                    self.retries += 1
                    time.sleep(self.retry.backoff_s(i, rng))
                attempts[i] = None
                i += 1
                continue
            except BaseException:
                if conn is not None:
                    with contextlib.suppress(OSError):
                        conn.close()
                raise
            with self._lock:
                self._conns[node] = conn
            breaker.success()
            return rows, ok
        if breaker.failure(time.monotonic()):
            self.breaker_opens += 1
        return None, None

    # -- public read ---------------------------------------------------------

    def read(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Rows for ``ids``: dense ``(rows, ok)`` with ``rows[i]`` valid
        where ``ok[i]``.  Requires geometry — either passed at construction
        or adopted from the first attach (call :meth:`warmup` to force the
        negotiation before the first read)."""
        ids = np.asarray(ids, np.int64)
        self.reads += 1
        if self.sample_shape is None or self.dtype is None:
            self.warmup()
        out = np.empty((ids.size,) + self.sample_shape, self.dtype)
        ok_all = np.zeros(ids.size, bool)
        targets = np.asarray(self._order, np.int64)[
            ids % len(self._order)
        ]
        for node in np.unique(targets).tolist():
            sel = np.flatnonzero(targets == node)
            rows, ok = self._read_node(int(node), ids[sel])
            if rows is None or ok is None or not ok.any():
                continue
            # ROWS frames carry one row per served id, in request order
            out[sel[ok]] = rows
            ok_all[sel[ok]] = True
        self.rows_served += int(ok_all.sum())
        self.rows_unserved += int((~ok_all).sum())
        return out, ok_all

    def warmup(self) -> None:
        """Attach to one endpoint now (adopting its geometry if none was
        given) so the first :meth:`read` doesn't pay the negotiation."""
        errors: list[str] = []
        for node in self._order:
            with self._lock:
                if node in self._conns:
                    return
            try:
                conn = self._attach(node)
            except TierAuthError:
                raise
            except (wire.WireError, OSError) as e:
                errors.append(f"node {node}: {e}")
                continue
            with self._lock:
                self._conns[node] = conn
            return
        raise TierError(
            "could not attach to any data-tier endpoint: " + "; ".join(errors)
        )


# ---------------------------------------------------------------------------
# Plan service: PlanCache over the control-plane wire format
# ---------------------------------------------------------------------------


class PlanService:
    """Serve schedule artifacts by content hash over MSG_CTRL frames.

    Backed by a :class:`~repro_torch.core.planners.PlanCache` directory; the
    index maps ``artifact_digest`` -> path, built from the entries present
    at startup plus everything :meth:`publish`\\ ed since.  One
    request/response per connection turn: ``{"kind": "plan_get", "hash"}``
    is answered with ``{"kind": "plan", "found", "data_b64"}`` — a few
    hundred KiB of npz per plan, so self-describing JSON + base64 beats a
    binary encoding nobody else speaks.
    """

    def __init__(self, cache, *, host: str = "127.0.0.1", port: int = 0):
        from repro_torch.core.plan import PlanArtifactError, Schedule

        self.cache = cache
        self._index: dict[str, str] = {}
        for name in sorted(os.listdir(cache.directory)):
            if not name.endswith(".npz"):
                continue
            path = os.path.join(cache.directory, name)
            try:
                sched = Schedule.load(path)
            except PlanArtifactError:
                continue  # corrupt entries are the cache's problem, not ours
            self._index[sched.artifact_digest()] = path
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(0.1)
        self.host, self.port = self._listener.getsockname()[:2]
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="solar-plan-service", daemon=True
        )

    def start(self) -> "PlanService":
        self._accept_thread.start()
        return self

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        with contextlib.suppress(OSError):
            self._listener.close()
        self._accept_thread.join(timeout=5.0)
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "PlanService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def publish(self, schedule, key: str | None = None) -> str:
        """Install ``schedule`` into the cache + index; returns its digest.

        The cache path is keyed by ``config_hash`` (so ``PlanCache.get``
        still finds it); the service index is keyed by *artifact* digest —
        tenants name plans by content, not by planner configuration.
        """
        digest = schedule.artifact_digest()
        path = self.cache.put(
            key if key is not None else schedule.config_hash, schedule
        )
        with self._lock:
            self._index[digest] = path
        return digest

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="solar-plan-service-conn", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        with contextlib.suppress(OSError, wire.WireError), conn:
            conn.settimeout(10.0)
            while not self._closed.is_set():
                frame = wire.recv_frame(conn, eof_ok=True)
                if frame is None:
                    return
                msg_type, payload = frame
                if msg_type != wire.MSG_CTRL:
                    wire.send_frame(
                        conn, wire.MSG_ERROR,
                        f"unexpected message type {msg_type}".encode(),
                    )
                    return
                msg = wire.unpack_json(payload)
                if msg.get("kind") != "plan_get":
                    wire.send_frame(
                        conn, wire.MSG_ERROR,
                        f"unknown plan-service request {msg.get('kind')!r}"
                        .encode(),
                    )
                    return
                digest = str(msg.get("hash", ""))
                with self._lock:
                    path = self._index.get(digest)
                reply: dict = {"kind": "plan", "hash": digest, "found": False}
                if path is not None:
                    try:
                        with open(path, "rb") as f:
                            reply["found"] = True
                            reply["data_b64"] = base64.b64encode(
                                f.read()
                            ).decode("ascii")
                    except OSError:
                        reply["found"] = False
                wire.send_frame(conn, wire.MSG_CTRL, wire.pack_json(reply))


class PlanServiceClient:
    """Resolve schedules by content hash from a :class:`PlanService`.

    The fetched artifact is staged to a temp file, reloaded, and its
    recomputed ``artifact_digest`` compared against the requested hash —
    a mismatch is a :class:`TierError`, never a silently-wrong plan.
    """

    def __init__(
        self, endpoint: tuple[str, int], *, timeout_s: float = 10.0
    ):
        self.endpoint = (str(endpoint[0]), int(endpoint[1]))
        self.timeout_s = float(timeout_s)

    def fetch(self, digest: str, dest_dir: str | None = None):
        """Fetch + verify the schedule whose artifact digest is ``digest``."""
        from repro_torch.core.plan import Schedule

        conn = socket.create_connection(self.endpoint, timeout=self.timeout_s)
        conn.settimeout(self.timeout_s)
        try:
            wire.send_frame(conn, wire.MSG_CTRL, wire.pack_json({
                "kind": "plan_get", "hash": str(digest),
            }))
            msg_type, payload = wire.recv_frame(conn)
        finally:
            with contextlib.suppress(OSError):
                conn.close()
        if msg_type != wire.MSG_CTRL:
            raise TierError(
                f"plan service answered message type {msg_type}: "
                f"{payload.decode(errors='replace')}"
            )
        msg = wire.unpack_json(payload)
        if not msg.get("found"):
            raise TierError(f"plan service has no artifact {digest!r}")
        data = base64.b64decode(str(msg.get("data_b64", "")))
        own_dir = dest_dir is None
        if own_dir:
            dest_dir = tempfile.mkdtemp(prefix="solar_plan_fetch_")
        path = os.path.join(dest_dir, f"plan_{digest[:16]}.npz")
        with open(path, "wb") as f:
            f.write(data)
        schedule = Schedule.load(path)
        got = schedule.artifact_digest()
        if got != digest:
            raise TierError(
                f"fetched plan hashes to {got}, asked for {digest} — "
                "refusing an artifact I cannot verify"
            )
        return schedule


# ---------------------------------------------------------------------------
# Rank-side wiring (the launcher calls this per rank)
# ---------------------------------------------------------------------------


class RankTier:
    """One rank's tenant-serving state: the residency index advancing with
    the executor plus the proxy reader, bound into the rank's live
    :class:`~repro_torch.runtime.server.BufferServer`."""

    def __init__(
        self,
        server: BufferServer,
        residency: ResidencyIndex,
        peers: TierPeerReader,
    ):
        self.server = server
        self.residency = residency
        self.peers = peers

    def at_step(self, step: int) -> None:
        """Advance the residency map to start-of-step ``step`` (called by
        the rank loop right where the server publishes its step)."""
        self.residency.advance_to(step)

    def stats(self) -> dict:
        return self.server.tenant_stats()

    def close(self) -> None:
        self.peers.close()


def wire_rank_tier(
    *,
    server: BufferServer,
    schedule,
    store,
    endpoints: dict[int, tuple[str, int]],
    config: ServeTierConfig,
    cluster_token: str,
) -> RankTier:
    """Enable tenant serving on one rank's buffer server.

    ``endpoints`` must exclude this rank (local residency is covered by the
    server's own mirrors); ``schedule`` is the *full* schedule (residency
    tracks every node's deltas, not just this rank's slice).
    """
    config.validate()
    residency = ResidencyIndex(schedule)
    peers = TierPeerReader(
        endpoints,
        token=cluster_token,
        sample_shape=server.sample_shape,
        dtype=server.dtype,
    )
    router = TierRouter(
        sample_shape=server.sample_shape,
        dtype=server.dtype,
        residency=residency,
        peers=peers,
        store=store,
    )
    server.enable_tenant_serving(
        config.tenants,
        queue_depth=config.queue_depth,
        internal_token=cluster_token,
        router=router,
        tenant_wait_s=config.tenant_wait_s,
    )
    return RankTier(server, residency, peers)


# ---------------------------------------------------------------------------
# Standalone tier (tests, benchmarks, the serving CLI without a training run)
# ---------------------------------------------------------------------------


class StandaloneTier:
    """A self-contained single-node data tier: one buffer server over a
    pre-staged mirror of ``store``, tenant serving enabled.

    No training run, no plan — the deterministic fixture the shedding and
    breaker tests, and the serving CLI's tier-fed runs, stand against: every admit/shed decision is a pure function of the
    injected clock, and teardown order is fully controlled.
    """

    def __init__(
        self,
        store,
        config: ServeTierConfig,
        *,
        resident_ids=None,
        clock=None,
        pfs_fallback: bool = True,
    ):
        from repro_torch.data.loaders import _DataMirror

        config.validate()
        ids = (
            np.arange(store.num_samples, dtype=np.int64)
            if resident_ids is None
            else np.asarray(resident_ids, np.int64)
        )
        self._mirror = _DataMirror(
            max(ids.size, 1), store.sample_shape, store.dtype
        )
        if ids.size:
            self._mirror.admit(ids, store.read_scattered(ids))
        self.server = BufferServer(
            0, store.sample_shape, store.dtype, port=0
        ).start()
        self.server.attach(lambda node: self._mirror)
        self.server.at_step(0)
        router = (
            TierRouter(
                sample_shape=store.sample_shape, dtype=store.dtype,
                store=store,
            )
            if pfs_fallback else None
        )
        self.server.enable_tenant_serving(
            config.tenants,
            queue_depth=config.queue_depth,
            internal_token=config.cluster_token,
            router=router,
            clock=clock,
            tenant_wait_s=config.tenant_wait_s,
        )

    @property
    def endpoint(self) -> tuple[str, int]:
        return (self.server.host, self.server.port)

    def stats(self) -> dict:
        return self.server.tenant_stats()

    def close(self) -> None:
        self.server.close()

    def __enter__(self) -> "StandaloneTier":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Row -> prompt mapping (the serving-replica input path)
# ---------------------------------------------------------------------------


def rows_to_prompts(
    rows: np.ndarray, prompt_len: int, vocab_size: int
) -> np.ndarray:
    """Deterministically map raw tier rows to int32 token prompts.

    The surrogate stores float feature rows, the serving engine wants token
    ids — this is the stand-in tokenizer: each row's bytes are viewed as
    uint8, tiled/truncated to ``prompt_len``, and folded into the vocab.
    Pure function of the row bytes, so tier-fed serving runs are replayable
    bit for bit.
    """
    rows = np.ascontiguousarray(rows)
    flat = rows.reshape(rows.shape[0], -1)
    raw = flat.view(np.uint8).reshape(rows.shape[0], -1).astype(np.int64)
    reps = -(-int(prompt_len) // max(raw.shape[1], 1))
    tiled = np.tile(raw, (1, reps))[:, : int(prompt_len)]
    # fold position in so constant rows still yield non-constant prompts
    pos = np.arange(int(prompt_len), dtype=np.int64)[None, :]
    return ((tiled * 31 + pos) % int(vocab_size)).astype(np.int32)
