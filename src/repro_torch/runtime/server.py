"""Per-node buffer server: answers peer fetches out of the live data mirror.

Each rank of a multi-process run owns one :class:`BufferServer` — a
listening TCP socket plus one handler thread per peer connection — serving
rows straight out of the rank's :class:`~repro_torch.data.loaders._DataMirror`
arena over the wire protocol (:mod:`repro_torch.runtime.wire`).

Correctness rests on two guards, both enforced *inside* :attr:`guard` (the
lock shared with the executor's delta application):

  * **step guard** (legacy ``MSG_FETCH``): a FETCH carries the requester's
    global step index; the server serves only while :meth:`at_step` has
    published that exact index — i.e. while its mirror provably reflects
    the start-of-step state the plan priced (DESIGN.md §6's ordering
    contract, stretched across processes).  A fetch racing its source's
    eviction — arriving after the source began applying that step's deltas
    — is answered with an all-False mask, so the requester falls back to
    the PFS instead of receiving bytes from a recycled arena slot.
  * **window-skew guard** (``MSG_FETCHW``, DESIGN.md §11): under the
    epoch-window protocol ranks barrier only on window boundaries, so a
    requester may be up to ``skew_window`` steps away from this server.
    The guard serves any step inside the live window from the *matching*
    snapshot: a requester *behind* this server is served from the current
    mirror overlaid with the bounded eviction history (:meth:`mutating`
    records what each step's delta replay evicted); a requester *ahead*
    waits (bounded by ``skew_wait_s``) for this rank's executor to reach
    its step.  A fetch beyond the window — or one whose wait expires — is
    refused as stale, never mis-served: sample rows are immutable by id,
    so every byte the guard does serve is bit-identical to the lockstep
    run.
  * **mutation lock**: row lookup + copy-out happen under :attr:`guard`;
    the rank's executor applies its admission/eviction deltas under the
    same lock (:meth:`mutating`), so a fetch never observes a half-applied
    delta or a recycled arena slot.

A server that has not been :meth:`attach`-ed to a mirror yet, or whose
published step falls outside the guard, is not an error — it answers
"nothing served" and the requester degrades to PFS reads, the same fallback
contract as every other failure in the tier.

Beyond the planned trainer traffic, a server can additionally serve
**tenants** — unplanned consumers (evaluators, inference replicas) reading
samples by id over ``MSG_ATTACH``/``MSG_READ`` (DESIGN.md §12, enabled via
:meth:`enable_tenant_serving`).  Tenant reads need none of the step/window
guards: sample rows are immutable by id, so any currently-resident copy is
the correct bytes — the guards exist to pin *which step's residency* a
trainer fetch observes, a notion tenants do not have.  What tenants do get:

  * **admission control** — a deterministic :class:`TokenBucket` per tenant
    plus one bounded concurrency gate for the whole server; refusals are
    ``MSG_SHED`` frames with a retry-after hint, never wrong bytes, and
    never a closed connection;
  * **strict trainer priority** — tenant reads yield (bounded) to any
    in-flight or arriving FETCH/FETCHW/delta-replay before touching the
    mirror lock, so a READ storm cannot stretch the training fast path;
  * **per-tenant accounting** — hits / peer-reads / PFS-fallbacks / sheds,
    surfaced through :meth:`tenant_stats` (the data tier's ``stats()``).

Own copy of the JAX package's ``runtime/server.py``, speaking the same
frames (:mod:`repro_torch.runtime.wire`): a client of either package is
served by a server of the other, bit for bit.
"""
from __future__ import annotations

import contextlib
import socket
import threading
import time

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import faults, wire

__all__ = ["BufferServer", "TokenBucket", "INTERNAL_TENANT"]

#: published step value meaning "serving is paused" (mirror mid-mutation).
_PAUSED = -1

#: reserved tenant id for server-to-server proxy reads (miss routing): it
#: authenticates with the cluster token, bypasses per-tenant buckets (the
#: originating server already admitted the read once), and its frames carry
#: ``forward=False`` so proxy hops can never loop.
INTERNAL_TENANT = -1


class TokenBucket:
    """Deterministic token-bucket rate limiter (clock injected by callers).

    ``rate`` is tokens (samples) per second, ``burst`` the bucket depth.
    :meth:`admit` is a pure function of the ``(n, now)`` call sequence —
    no hidden clock reads — so seeded tests replay identical admit/shed
    decisions.  ``rate=None`` disables limiting (always admits).
    """

    def __init__(self, rate: float | None, burst: float | None = None):
        self.rate = None if rate is None else float(rate)
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"rate must be > 0 (or None), got {rate!r}")
        self.burst = (
            float(burst) if burst is not None
            else (self.rate if self.rate is not None else 0.0)
        )
        self.tokens = self.burst
        self._last: float | None = None

    def admit(self, n: int, now: float) -> float:
        """Try to take ``n`` tokens at time ``now``.

        Returns ``0.0`` on admission, else the retry-after hint in seconds
        (how long until the bucket refills enough for ``n`` tokens).
        """
        if self.rate is None:
            return 0.0
        if self._last is None:
            self._last = now
        elapsed = max(now - self._last, 0.0)
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self._last = now
        if n <= self.tokens:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate


class _TenantState:
    """One tenant's auth token, rate limiter, and serve counters."""

    def __init__(self, tenant: int, token: str, bucket: TokenBucket | None):
        self.tenant = int(tenant)
        self.token = str(token)
        self.bucket = bucket
        self.hits = 0
        self.peer_reads = 0
        self.pfs_fallbacks = 0
        self.sheds = 0

    def counters(self) -> dict:
        return {
            "hits": self.hits,
            "peer_reads": self.peer_reads,
            "pfs_fallbacks": self.pfs_fallbacks,
            "sheds": self.sheds,
        }


class BufferServer:
    """Serve one node's buffer mirror to its peers over TCP.

    ``node`` is the global rank this server speaks for; ``sample_shape`` /
    ``dtype`` are the store geometry negotiated with every client.  The
    listening socket binds immediately (``port=0`` picks a free port — read
    it back from :attr:`port` for the address book); handler threads start
    on :meth:`start` and are joined by :meth:`close`.
    """

    def __init__(
        self,
        node: int,
        sample_shape: tuple[int, ...],
        dtype,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        accept_timeout_s: float = 0.1,
        skew_window: int = 0,
        skew_wait_s: float = 2.0,
    ):
        self.node = int(node)
        self.sample_shape = tuple(int(x) for x in sample_shape)
        self.dtype = np.dtype(dtype)
        #: lock shared by fetch handlers and the executor's delta replay.
        self.guard = threading.Lock()
        #: signalled whenever :attr:`_applied` advances — windowed fetches
        #: from a requester ahead of this rank park here.
        self._advanced = threading.Condition(self.guard)
        #: nodes this server currently speaks for: its own rank plus any
        #: adopted after a re-slice (elastic recovery, DESIGN.md §9).
        self.serving: set[int] = {self.node}
        self._mirror_of = None
        self._step = _PAUSED
        #: number of step-delta replays applied: the mirrors reflect the
        #: start-of-step ``_applied`` state (windowed guard's clock).
        self._applied = 0
        #: max steps of requester/server skew the windowed guard serves
        #: (``window_steps`` of the epoch-window protocol; 0 = exact-step
        #: only, the lockstep degenerate case).
        self.skew_window = int(skew_window)
        #: how long a windowed fetch for a *future* step may wait for this
        #: rank's executor to catch up before being refused as stale.
        self.skew_wait_s = float(skew_wait_s)
        #: node -> step -> (ids, rows) evicted by that step's delta replay;
        #: retained for the last ``skew_window`` steps so requesters behind
        #: this server still get start-of-their-step rows.
        self._history: dict[int, dict[int, list]] = {}
        #: fetches refused because the step/window guard fired.
        self.stale_refusals = 0
        #: largest requester/server skew the windowed guard actually served.
        self.max_observed_skew = 0
        # -- tenant serving (DESIGN.md §12; off until enable_tenant_serving)
        self._tenants: dict[int, _TenantState] | None = None
        self._tenant_lock = threading.Lock()
        self._tenant_gate: threading.BoundedSemaphore | None = None
        self._tenant_router = None
        self._tenant_clock = time.monotonic
        self._tenant_wait_s = 0.2
        self._internal_token: str | None = None
        #: trainer-priority bookkeeping: count of in-flight trainer
        #: sections (fetch handlers + delta replays); tenant reads wait
        #: (bounded) for it to hit zero before touching :attr:`guard`.
        self._prio = threading.Condition()
        self._trainer_busy = 0
        self._accept_timeout_s = float(accept_timeout_s)
        self._closed = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(self._accept_timeout_s)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "BufferServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"solar-buffer-{self.node}",
            daemon=True,
        )
        self._accept_thread.start()
        return self

    def close(self) -> None:
        """Stop accepting, close the socket, join every handler thread."""
        if self._closed.is_set():
            return
        self._closed.set()
        with self._advanced:  # unpark windowed fetches waiting on progress
            self._advanced.notify_all()
        with contextlib.suppress(OSError):
            self._listener.close()
        for conn in self._conns:  # sever live peers so handlers unblock
            with contextlib.suppress(OSError):
                conn.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                conn.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "BufferServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- executor-side surface -----------------------------------------------

    def attach(self, mirror_of) -> None:
        """Bind the live mirror accessor (``node -> _DataMirror``).

        Until attached every fetch is answered all-False — the server can
        (and does) come up before the executor exists, so the address book
        can be exchanged first.
        """
        with self.guard:
            self._mirror_of = mirror_of

    def at_step(self, step: int) -> None:
        """Publish that the mirror now reflects start-of-step ``step``."""
        with self._advanced:
            self._step = int(step)
            self._applied = int(step)
            self._advanced.notify_all()

    @contextlib.contextmanager
    def mutating(self, step: int | None = None):
        """Scope for the executor's delta application: the mirror is
        exclusively held throughout and the legacy step guard pauses.

        With ``step`` given (the epoch-window protocol), everything the
        replay evicts is captured into the bounded history and the windowed
        clock advances to ``step + 1`` on exit — peers still gathering
        ``step`` (or earlier, within the skew window) keep being served
        from the correct snapshot instead of being refused.
        """
        with self._trainer_section(), self._advanced:
            self._step = _PAUSED
            sinks: list[tuple[int, list, object]] = []
            if step is not None and self.skew_window > 0 and self._mirror_of:
                for node in sorted(self.serving):
                    mirror = self._mirror_of(node)
                    if mirror is not None:
                        sink: list = []
                        mirror.evict_sink = sink
                        sinks.append((node, sink, mirror))
            try:
                yield
            finally:
                for node, sink, mirror in sinks:
                    mirror.evict_sink = None
                    if sink:
                        self._history.setdefault(node, {})[int(step)] = sink
                if step is not None:
                    self._applied = int(step) + 1
                    floor = self._applied - self.skew_window
                    for per_node in self._history.values():
                        for s in [s for s in per_node if s < floor]:
                            del per_node[s]
                    self._advanced.notify_all()

    def adopt(self, node: int) -> None:
        """Start answering fetches for ``node`` (this rank adopted it).

        Called only after the adopted mirror has been rebuilt to the
        current step boundary, so the first served fetch already sees the
        start-of-step state the plan priced.
        """
        with self.guard:
            self.serving.add(int(node))

    def drop(self, node: int) -> None:
        """Stop speaking for ``node`` (ownership moved, e.g. a rejoin).

        A client mid-transition that still dials here gets a *transient*
        refusal ("not serving node"), retries, and lands on the new owner
        once its address book update arrives.
        """
        with self._advanced:
            self.serving.discard(int(node))
            self._history.pop(int(node), None)
            self._advanced.notify_all()

    # -- tenant serving (DESIGN.md §12) ----------------------------------------

    def enable_tenant_serving(
        self,
        tenants,
        *,
        queue_depth: int = 8,
        internal_token: str | None = None,
        router=None,
        clock=None,
        tenant_wait_s: float = 0.2,
    ) -> None:
        """Start answering ``MSG_ATTACH``/``MSG_READ`` for these tenants.

        ``tenants`` is an iterable of objects with ``tenant`` (int id),
        ``token`` (auth string), and ``rate``/``burst`` (token-bucket
        parameters; ``rate=None`` = unlimited) — e.g.
        :class:`repro_torch.serve.datatier.TenantConfig`.  ``queue_depth`` bounds
        concurrently-processing tenant reads server-wide; reads beyond it
        are shed, never queued unboundedly.  ``router`` is the miss path:
        ``router(ids) -> (rows, ok, peer_mask)`` over the ids the local
        mirrors could not serve (peer proxy first, PFS last — see
        ``repro_torch.serve.datatier.TierRouter``).  ``internal_token``
        authenticates :data:`INTERNAL_TENANT` proxy attaches from sibling
        servers.  ``clock`` injects the bucket clock for deterministic
        tests.
        """
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        states: dict[int, _TenantState] = {}
        for t in tenants:
            tid = int(t.tenant)
            if tid == INTERNAL_TENANT:
                raise ValueError(
                    f"tenant id {INTERNAL_TENANT} is reserved for proxy reads"
                )
            if tid in states:
                raise ValueError(f"duplicate tenant id {tid}")
            rate = getattr(t, "rate", None)
            burst = getattr(t, "burst", None)
            bucket = None if rate is None else TokenBucket(rate, burst)
            states[tid] = _TenantState(tid, t.token, bucket)
        with self._tenant_lock:
            self._tenants = states
            self._tenant_gate = threading.BoundedSemaphore(int(queue_depth))
            self._tenant_router = router
            self._internal_token = internal_token
            if clock is not None:
                self._tenant_clock = clock
            self._tenant_wait_s = float(tenant_wait_s)

    def tenant_stats(self) -> dict:
        """Per-tenant + aggregate serve counters."""
        with self._tenant_lock:
            if not self._tenants:
                return {}
            agg = {
                "tenant_hits": 0, "tenant_peer_reads": 0,
                "tenant_pfs_fallbacks": 0, "tenant_sheds": 0,
            }
            per: dict[str, dict] = {}
            for tid, st in sorted(self._tenants.items()):
                c = st.counters()
                per[str(tid)] = c
                agg["tenant_hits"] += c["hits"]
                agg["tenant_peer_reads"] += c["peer_reads"]
                agg["tenant_pfs_fallbacks"] += c["pfs_fallbacks"]
                agg["tenant_sheds"] += c["sheds"]
            return {**agg, "per_tenant": per}

    @contextlib.contextmanager
    def _trainer_section(self):
        """Mark a trainer fast-path operation in flight (strict priority):
        tenant reads park in :meth:`_yield_to_trainers` until none are."""
        with self._prio:
            self._trainer_busy += 1
        try:
            yield
        finally:
            with self._prio:
                self._trainer_busy -= 1
                self._prio.notify_all()

    def _yield_to_trainers(self) -> None:
        """Wait (bounded) until no trainer operation is in flight.

        The bound (:attr:`_tenant_wait_s`) keeps a continuously-busy
        trainer from starving tenants forever; after it expires the read
        proceeds and contends on :attr:`guard` normally — the copy-out it
        performs there is a few microseconds, not a latency cliff.
        """
        tr = obs_trace.get()
        t0 = tr.t()
        waited = False
        deadline = time.monotonic() + self._tenant_wait_s
        with self._prio:
            while self._trainer_busy > 0 and not self._closed.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                waited = True
                self._prio.wait(timeout=remaining)
        if waited:
            tr.rec(obs_trace.SERVE_TENANT_YIELD, t0)

    # -- serving side ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            self._conns.append(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"solar-buffer-{self.node}-conn", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        serve_node: int | None = None
        tenant: int | None = None
        with contextlib.suppress(OSError, wire.WireError), conn:
            conn.settimeout(self._accept_timeout_s * 100)
            while not self._closed.is_set():
                frame = wire.recv_frame(conn, eof_ok=True)
                if frame is None:
                    return  # client hung up cleanly
                msg_type, payload = frame
                if msg_type == wire.MSG_HELLO:
                    serve_node = self._handle_hello(conn, payload)
                    if serve_node is None:
                        return
                elif msg_type in (wire.MSG_FETCH, wire.MSG_FETCHW):
                    if serve_node is None:
                        # geometry was never negotiated on this connection:
                        # serving anyway could hand out same-row-size bytes
                        # in the wrong layout without either side noticing.
                        wire.send_frame(
                            conn, wire.MSG_ERROR,
                            b"FETCH before HELLO: negotiate geometry first",
                        )
                        return
                    if msg_type == wire.MSG_FETCHW:
                        self._handle_fetchw(conn, payload, serve_node)
                    else:
                        self._handle_fetch(conn, payload, serve_node)
                elif msg_type == wire.MSG_ATTACH:
                    tenant = self._handle_attach(conn, payload)
                    if tenant is None:
                        return
                elif msg_type == wire.MSG_READ:
                    if tenant is None:
                        wire.send_frame(
                            conn, wire.MSG_ERROR,
                            b"READ before ATTACH: authenticate first",
                        )
                        return
                    if not self._handle_read(conn, payload, tenant):
                        return
                else:
                    wire.send_frame(
                        conn, wire.MSG_ERROR,
                        f"unexpected message type {msg_type}".encode(),
                    )
                    return

    def _handle_hello(self, conn: socket.socket, payload: bytes) -> int | None:
        """Negotiate one connection; returns the node it will serve.

        Geometry (shape/dtype) disagreement is fatal for the deployment and
        stays a loud "geometry mismatch" refusal.  A HELLO for a node this
        server does not (currently) speak for is *transient* — mid-ownership
        transition a client can race the address-book update — so its
        refusal reads differently and the client retries instead of raising.
        """
        hello = wire.unpack_json(payload)
        mine = {"shape": list(self.sample_shape), "dtype": self.dtype.str}
        theirs = {
            "shape": list(hello.get("shape", ())),
            "dtype": hello.get("dtype"),
        }
        if theirs != mine:
            wire.send_frame(
                conn, wire.MSG_ERROR,
                f"geometry mismatch: client expects {theirs}, "
                f"server is {mine}".encode(),
            )
            return None
        node = hello.get("node")
        with self.guard:
            known = node in self.serving
        if not known:
            wire.send_frame(
                conn, wire.MSG_ERROR,
                f"not serving node {node} here (serves {self.node})".encode(),
            )
            return None
        wire.send_frame(
            conn, wire.MSG_HELLO_OK, wire.pack_json({"node": node, **mine})
        )
        return int(node)

    def _handle_fetch(
        self, conn: socket.socket, payload: bytes, serve_node: int
    ) -> None:
        step, ids = wire.unpack_fetch(payload)
        tr = obs_trace.get()
        t0 = tr.t()
        delay = faults.on_serve()
        if delay > 0:
            time.sleep(delay)  # injected slow-peer latency (chaos harness)
        with self._trainer_section(), self.guard:
            mirror = (
                self._mirror_of(serve_node)
                if self._mirror_of is not None and serve_node in self.serving
                else None
            )
            serveable = (
                mirror is not None
                and self._step != _PAUSED
                and self._step == step
            )
            if serveable:
                slots = mirror.lookup(ids)
                ok = slots >= 0
                rows = (
                    mirror.rows(slots[ok])  # fancy-index copy, under guard
                    if ok.any()
                    else np.empty((0,) + self.sample_shape, self.dtype)
                )
            else:
                self.stale_refusals += int(
                    mirror is not None and self._step != step
                )
                ok = np.zeros(ids.size, bool)
                rows = np.empty((0,) + self.sample_shape, self.dtype)
        tr.rec(obs_trace.SERVE_FETCH, t0, a=serve_node, b=ids.size)
        wire.send_frame(
            conn, wire.MSG_ROWS, wire.pack_rows(ok, rows), site="server.rows"
        )

    def _handle_fetchw(
        self, conn: socket.socket, payload: bytes, serve_node: int
    ) -> None:
        """Serve one windowed fetch under the window-skew guard.

        A requester *ahead* of this rank parks on :attr:`_advanced` until
        the executor's delta replay reaches its step (bounded by
        ``skew_wait_s`` — a dead or wedged rank must refuse, not hang the
        peer).  A requester *behind* is served from the current mirror with
        the bounded eviction history overlaid, reconstructing exactly the
        start-of-its-step snapshot.  Anything outside ``skew_window`` is a
        stale refusal: all-False mask, PFS fallback, never wrong bytes.
        """
        window, step, ids = wire.unpack_fetchw(payload)
        tr = obs_trace.get()
        t0 = tr.t()
        delay = faults.on_serve()
        if delay > 0:
            time.sleep(delay)  # injected slow-peer latency (chaos harness)
        with self._trainer_section(), self._advanced:
            deadline = time.monotonic() + self.skew_wait_s
            t_park = tr.t()
            parked = False
            while (
                not self._closed.is_set()
                and self._mirror_of is not None
                and serve_node in self.serving
                and self._applied < step
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                parked = True
                self._advanced.wait(timeout=remaining)
            if parked:
                # §11 lead wait: the requester ran ahead and we parked the
                # serve until the delta replay caught up (or the bound hit).
                tr.rec(obs_trace.SERVE_SKEW_PARK, t_park, a=serve_node,
                       b=int(step))
            mirror = (
                self._mirror_of(serve_node)
                if self._mirror_of is not None and serve_node in self.serving
                else None
            )
            lag = self._applied - int(step)
            # the window tag must agree with the step under this server's
            # window geometry — a frame from a peer running a different
            # window size (mixed restart, bad config) is refused, never
            # guessed at.
            tag_ok = self.skew_window <= 0 or (
                int(window) == int(step) // self.skew_window
            )
            if mirror is not None and tag_ok and 0 <= lag <= self.skew_window:
                self.max_observed_skew = max(self.max_observed_skew, lag)
                slots = mirror.lookup(ids)
                ok = slots >= 0
                out = np.empty(
                    (ids.size,) + self.sample_shape, self.dtype
                )
                if ok.any():
                    out[ok] = mirror.rows(slots[ok])
                if lag > 0 and not ok.all():
                    # rows this server evicted after the requester's step:
                    # replay the bounded history, newest capture wins (the
                    # bytes are identical either way — rows are immutable
                    # by id — only presence matters).
                    per_node = self._history.get(serve_node, {})
                    recovered: dict[int, np.ndarray] = {}
                    for s in range(int(step), self._applied):
                        for hids, hrows in per_node.get(s, ()):
                            for j, hid in enumerate(hids.tolist()):
                                recovered[int(hid)] = hrows[j]
                    for j in np.flatnonzero(~ok).tolist():
                        row = recovered.get(int(ids[j]))
                        if row is not None:
                            out[j] = row
                            ok[j] = True
                rows = out[ok] if ok.any() else np.empty(
                    (0,) + self.sample_shape, self.dtype
                )
            else:
                self.stale_refusals += int(mirror is not None)
                ok = np.zeros(ids.size, bool)
                rows = np.empty((0,) + self.sample_shape, self.dtype)
        tr.rec(obs_trace.SERVE_FETCH, t0, a=serve_node, b=ids.size)
        wire.send_frame(
            conn, wire.MSG_ROWS, wire.pack_rows(ok, rows), site="server.rows"
        )

    # -- tenant handlers (DESIGN.md §12) ---------------------------------------

    def _handle_attach(self, conn: socket.socket, payload: bytes) -> int | None:
        """Authenticate one tenant connection; returns the bound tenant id.

        Refusals mirror the HELLO taxonomy: a disabled server, a bad token,
        or a geometry disagreement are loud ``MSG_ERROR`` frames and the
        connection closes — attaching is configuration, not load, so it
        never sheds.  A client that omits shape/dtype negotiates: the
        ATTACH_OK echo carries this server's geometry and the client adopts
        it.
        """
        att = wire.unpack_json(payload)
        with self._tenant_lock:
            tenants = self._tenants
        if tenants is None:
            wire.send_frame(
                conn, wire.MSG_ERROR,
                b"tenant serving disabled on this server",
            )
            return None
        try:
            tid = int(att["tenant"])
        except (KeyError, TypeError, ValueError):
            wire.send_frame(
                conn, wire.MSG_ERROR, b"ATTACH carries no usable tenant id"
            )
            return None
        token = att.get("token")
        if tid == INTERNAL_TENANT:
            authorized = (
                self._internal_token is not None
                and token == self._internal_token
            )
        else:
            st = tenants.get(tid)
            authorized = st is not None and token == st.token
        if not authorized:
            wire.send_frame(
                conn, wire.MSG_ERROR,
                f"tenant auth failed for tenant {tid}".encode(),
            )
            return None
        mine = {"shape": list(self.sample_shape), "dtype": self.dtype.str}
        if "shape" in att or "dtype" in att:
            theirs = {
                "shape": list(att.get("shape", ())),
                "dtype": att.get("dtype"),
            }
            if theirs != mine:
                wire.send_frame(
                    conn, wire.MSG_ERROR,
                    f"geometry mismatch: client expects {theirs}, "
                    f"server is {mine}".encode(),
                )
                return None
        wire.send_frame(
            conn, wire.MSG_ATTACH_OK, wire.pack_json({"tenant": tid, **mine})
        )
        return tid

    def _handle_read(
        self, conn: socket.socket, payload: bytes, tenant: int
    ) -> bool:
        """Serve one tenant read; returns False when the connection must
        close (protocol violation), True otherwise — including sheds, which
        keep the connection alive by design.

        Admission runs first (per-tenant bucket, then the server-wide
        concurrency gate), then the read yields to any in-flight trainer
        traffic before touching the mirror lock.  Misses route through the
        tier router (peer proxy -> PFS) *outside* the mirror lock, and only
        when the frame's forward flag allows it — proxy hops never forward
        again, so routing cannot loop.
        """
        tid, forward, ids = wire.unpack_read(payload)
        if tid != tenant:
            wire.send_frame(
                conn, wire.MSG_ERROR,
                f"READ for tenant {tid} on a connection attached as "
                f"{tenant}".encode(),
            )
            return False
        st: _TenantState | None = None
        if tenant != INTERNAL_TENANT:
            with self._tenant_lock:
                st = (self._tenants or {}).get(tenant)
            if st is None:
                wire.send_frame(
                    conn, wire.MSG_ERROR,
                    f"tenant {tenant} no longer configured".encode(),
                )
                return False
            if st.bucket is not None:
                with self._tenant_lock:
                    retry = st.bucket.admit(ids.size, self._tenant_clock())
                if retry > 0:
                    with self._tenant_lock:
                        st.sheds += 1
                    obs_trace.get().instant(obs_trace.SERVE_SHED, a=tenant)
                    wire.send_frame(
                        conn, wire.MSG_SHED,
                        wire.pack_shed(retry, "rate_limited"),
                    )
                    return True
        gate = self._tenant_gate
        if gate is not None and not gate.acquire(blocking=False):
            # queue depth exhausted: shed now rather than queue unboundedly
            # behind other tenants — the retry hint is small because a slot
            # frees as soon as any in-flight read finishes its copy-out.
            if st is not None:
                with self._tenant_lock:
                    st.sheds += 1
            obs_trace.get().instant(obs_trace.SERVE_SHED, a=tenant)
            wire.send_frame(
                conn, wire.MSG_SHED, wire.pack_shed(0.05, "queue_full")
            )
            return True
        try:
            self._yield_to_trainers()
            out, ok = self._tenant_lookup(ids)
            hits = int(ok.sum())
            peer = pfs = 0
            missing = ~ok
            if missing.any() and forward and self._tenant_router is not None:
                sel = np.flatnonzero(missing)
                r_rows, r_ok, r_peer = self._tenant_router(ids[sel])
                if r_ok.any():
                    out[sel[r_ok]] = r_rows[r_ok]
                    ok[sel[r_ok]] = True
                peer = int((r_ok & r_peer).sum())
                pfs = int((r_ok & ~r_peer).sum())
            if st is not None:
                with self._tenant_lock:
                    st.hits += hits
                    st.peer_reads += peer
                    st.pfs_fallbacks += pfs
            rows = (
                out[ok] if ok.any()
                else np.empty((0,) + self.sample_shape, self.dtype)
            )
            wire.send_frame(conn, wire.MSG_ROWS, wire.pack_rows(ok, rows))
            return True
        finally:
            if gate is not None:
                gate.release()

    def _tenant_lookup(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Copy out every requested row resident in any served mirror.

        No step/window guard on purpose: rows are immutable by id, so any
        resident copy is the correct bytes; :attr:`guard` is held only for
        the lookup + copy so a half-applied delta is never observed.
        """
        out = np.empty((ids.size,) + self.sample_shape, self.dtype)
        ok = np.zeros(ids.size, bool)
        with self.guard:
            if self._mirror_of is None:
                return out, ok
            for node in sorted(self.serving):
                rest = np.flatnonzero(~ok)
                if rest.size == 0:
                    break
                mirror = self._mirror_of(node)
                if mirror is None:
                    continue
                slots = mirror.lookup(ids[rest])
                found = slots >= 0
                if found.any():
                    out[rest[found]] = mirror.rows(slots[found])
                    ok[rest[found]] = True
        return out, ok
