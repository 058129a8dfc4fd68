"""Multi-process launcher: N OS processes executing one plan over TCP.

``run_distributed(spec)`` turns the single-process loader into a real
distributed run (DESIGN.md §8), and — because every future access is
compiled into the :class:`~repro_torch.core.plan.Schedule` IR — an *elastic* one
(DESIGN.md §9):

  * the parent compiles (or loads) the :class:`~repro_torch.core.plan.Schedule`,
    saves it as one artifact, and hands every rank the *path plus the
    content digest* — each rank reloads the artifact and refuses to run if
    its recomputed digest disagrees (the plan is distributed by hash, never
    by trust);
  * each rank is a **spawned** OS process (spawn-safe: the entry point is a
    module-level function taking picklable arguments) that opens the store
    through the backend registry, slices out its share with
    :meth:`~repro_torch.core.plan.Schedule.for_node`, stands up a
    :class:`~repro_torch.runtime.server.BufferServer` over its live buffer
    mirror, and replays the slice with a
    :class:`~repro_torch.data.peer.SocketTransport` wired to every peer's server;
  * the parent runs the **control plane**: ranks register their server
    endpoints over TCP, receive the merged address book, then barrier twice
    per step — once at step start (every mirror in start-of-step state,
    every server publishing the step index) and once after all peer fetches
    (no mirror mutates while any peer still reads).  The data plane (peer
    rows) never touches the parent;
  * every rank **heartbeats** — on a timer and after each executed step —
    carrying an atomic snapshot of its per-node step cursors and its
    XOR-aggregate batch digest.  The coordinator's failure detector turns
    silence into suspicion (one probe, a grace window) and persistent
    silence into a declared death;
  * a declared death triggers **recovery by re-slicing** (the default): the
    dead rank's remaining plan — its ``for_node`` suffix from the cursor in
    its last heartbeat — is reassigned to a survivor, piggybacked on the
    next step-start barrier release together with the updated address book,
    so every rank applies the transition at the same step boundary.  The
    adopter rebuilds the orphan's buffer mirror (delta replay + one
    coalesced restage), replays any catch-up steps from the store, then
    executes the adopted plan in lockstep and serves it to peers — the
    *global* per-step sample set, and therefore the aggregate batch digest,
    is preserved.  ``recovery="degrade"`` keeps the plain failover
    (survivors eat PFS fallbacks) for comparison;
  * the same assignment message lets a **restarted rank re-join**: it
    registers again, is handed a resume step, reclaims its own slice at the
    next boundary, and the interim adopter drops it.

Digest accounting under recovery is exact: per-(step, node) single-node
batch digests are XOR-combined (order- and ownership-independent), a
rank's heartbeat carries ``(cursors, aggregate)`` snapshotted under one
lock, and re-slicing starts from exactly the last heartbeat's cursor — so
work the dead rank hashed but never reported is simply redone by the
adopter and counted once.  ``XOR(survivor finals, dead last-heartbeats)``
equals :func:`in_process_aggregate` bit for bit.  Per-rank *stream*
digests (:func:`in_process_digests`) remain own-node-only, so healthy-run
parity is unchanged by adoption.

Own copy of the JAX package's ``runtime/launcher.py``.  Its ranks run the
port's numpy-only loader, buffer server and data tier (no torch), so their
digests equal the JAX package's :func:`in_process_digests` for the same
store and spec, bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import multiprocessing
import os
import socket
import tempfile
import threading
import time
from typing import Mapping

from repro_torch.obs import log as obs_log, metrics as obs_metrics, trace as obs_trace
from repro_torch.runtime import wire

__all__ = [
    "LauncherConfigError",
    "RankResult",
    "DistributedReport",
    "run_distributed",
    "in_process_digests",
    "in_process_aggregate",
]

_HOST = "127.0.0.1"

_log = obs_log.get_logger("runtime.launcher")

#: hard cap on retained heartbeat telemetry snapshots (cluster time-series):
#: at the default 0.2 s beat this is hours of history, and a leaked
#: heartbeat loop can never grow the coordinator without bound.
_TELEMETRY_CAP = 200_000


class LauncherConfigError(ValueError):
    """An invalid launcher configuration (non-positive timeout/interval,
    unknown recovery mode) — refused up front with a named error."""


def _xor_into(acc: bytearray, digest: bytes) -> None:
    for i, b in enumerate(digest):
        acc[i] ^= b


# ---------------------------------------------------------------------------
# Control plane (parent side)
# ---------------------------------------------------------------------------


class _Coordinator:
    """Parent-side control server: registration, barriers, heartbeats,
    failure detection, re-slicing, reports.

    One handler thread per rank connection plus one monitor thread; all
    shared state is guarded by one condition variable, and every socket
    send happens under it (frames from different threads never interleave).

    Failure detection is graded: any inbound message refreshes a rank's
    liveness; silence beyond ``suspect_timeout_s`` makes it *suspected* and
    earns it a probe; any sign of life before ``probe_grace_s`` more
    seconds re-admits it (counted as a false suspect); continued silence
    gets its connection closed — fencing it off the control plane — and the
    normal death path runs.  Peers can *suggest* suspicion (the transport's
    breaker escalation), but only staleness the coordinator observes
    itself can advance the ladder: the data plane never declares deaths.

    A rank named in ``restart_ranks`` is awaited after its death: once the
    release carrying its reassignment has gone out (an interim adopter
    covers the gap), step-start releases are held until the respawned rank
    registers, or for ``barrier_timeout_s / 2`` at most.  The rejoin then
    lands on the held boundary whatever the respawn costs; without the hold
    the survivors can finish the plan before the new process registers, and
    the rejoiner runs no step.  (A departure from the JAX package's
    launcher, which does not wait.)
    """

    def __init__(
        self,
        num_ranks: int,
        *,
        barrier_timeout_s: float = 60.0,
        recovery: str = "reslice",
        heartbeat_interval_s: float = 0.2,
        suspect_timeout_s: float = 2.0,
        probe_grace_s: float = 2.0,
        window_steps: int = 1,
        restart_ranks=(),
    ):
        self.num_ranks = int(num_ranks)
        self.barrier_timeout_s = float(barrier_timeout_s)
        self.recovery = str(recovery)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.suspect_timeout_s = float(suspect_timeout_s)
        self.probe_grace_s = float(probe_grace_s)
        #: epoch-window size in steps (DESIGN.md §11): step barriers exist
        #: only at multiples of this, so rejoins and ownership transitions
        #: land exclusively on window boundaries.
        self.window_steps = max(int(window_steps), 1)
        self._listener = socket.create_server((_HOST, 0))
        self._listener.settimeout(0.1)
        self.port = self._listener.getsockname()[1]
        self._cond = threading.Condition()
        self.endpoints: dict[int, tuple[str, int]] = {}
        self.reports: dict[int, dict] = {}
        self.alive: set[int] = set()
        self.dead: set[int] = set()
        self.done: set[int] = set()
        self._conns: dict[int, socket.socket] = {}
        self._barriers: dict[str, set[int]] = {}
        self._addrbook_sent = False
        # -- elastic state ---------------------------------------------------
        #: node -> rank currently executing (and serving) that node's plan.
        self.owner_of: dict[int, int] = {r: r for r in range(self.num_ranks)}
        #: rank -> monotonic time of its last inbound control message.
        self.last_msg: dict[int, float] = {}
        #: rank -> its latest heartbeat payload ({"cursors": {...}, "agg"}).
        self.hb_state: dict[int, dict] = {}
        #: rank -> first step whose barriers it participates in (0 for a
        #: fresh rank; the resume step for a rejoiner — it is not expected
        #: at barriers for steps it never ran).
        self.joined_at: dict[int, int] = {}
        #: aggregate digests frozen from dead ranks' last heartbeats.
        self.dead_aggs: list[str] = []
        self.suspected: set[int] = set()
        self.false_suspects = 0
        self.peer_suspicions = 0
        self.probes_sent = 0
        self.rejoins = 0
        self.resliced_nodes = 0
        self.last_released_step = -1
        self._pending_assignments: list[dict] = []
        #: ranks the launcher respawns once after death (reslice only).
        self._restartable = (
            set(int(r) for r in restart_ranks)
            if self.recovery == "reslice" else set()
        )
        #: dead rank -> monotonic deadline of the release hold awaiting its
        #: re-registration.
        self._awaiting_rejoin: dict[int, float] = {}
        #: names of barriers already released (streaming parents pace their
        #: window lookahead on these).
        self.released_barriers: set[str] = set()
        #: every window announcement broadcast so far — replayed to late
        #: registrants so no rank can miss a plan segment.
        self.windows_sent: list[dict] = []
        #: cluster time-series of per-rank metric snapshots piggybacked on
        #: heartbeats (§13 live telemetry; empty unless ranks send "m").
        self.telemetry: list[dict] = []
        self._telemetry_t0 = time.monotonic()
        self._closed = threading.Event()
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="solar-coord", daemon=True
        )
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, name="solar-coord-monitor", daemon=True
        )

    def start(self) -> "_Coordinator":
        self._accept_thread.start()
        self._monitor_thread.start()
        return self

    def close(self) -> None:
        self._closed.set()
        with contextlib.suppress(OSError):
            self._listener.close()
        with self._cond:
            for conn in self._conns.values():
                with contextlib.suppress(OSError):
                    conn.close()
        self._accept_thread.join(timeout=5.0)
        self._monitor_thread.join(timeout=5.0)
        for t in self._threads:
            t.join(timeout=5.0)

    # -- accept / per-rank handler -------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._handle, args=(conn,), name="solar-coord-conn",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _handle(self, conn: socket.socket) -> None:
        rank = None
        try:
            # the only traffic lulls a healthy rank shows are barrier waits,
            # and heartbeats tick through those — so the control-plane recv
            # timeout is the same budget as the barriers it carries.
            conn.settimeout(self.barrier_timeout_s)
            msg = self._recv_ctrl(conn)
            if msg.get("kind") != "register":
                return
            rank = int(msg["rank"])
            self._register(rank, conn, msg)
            while True:
                msg = self._recv_ctrl(conn)
                kind = msg.get("kind")
                with self._cond:
                    self.last_msg[rank] = time.monotonic()
                    if rank in self.suspected:
                        # sign of life inside the grace window: re-admit.
                        self.suspected.discard(rank)
                        self.false_suspects += 1
                if kind == "barrier":
                    self._arrive(rank, str(msg["name"]))
                elif kind == "hb":
                    with self._cond:
                        self.hb_state[rank] = {
                            "cursors": dict(msg.get("cursors", {})),
                            "agg": msg.get("agg"),
                            # window cursor: which epoch window the rank is
                            # executing (skew diagnosis under DESIGN.md §11).
                            "window": msg.get("window"),
                        }
                        m = msg.get("m")
                        if m and len(self.telemetry) < _TELEMETRY_CAP:
                            self.telemetry.append({
                                "t": round(
                                    time.monotonic() - self._telemetry_t0, 3
                                ),
                                "rank": rank,
                                **{str(k): v for k, v in m.items()},
                            })
                elif kind == "suspect":
                    self._peer_suspect(rank, int(msg.get("node", -1)))
                elif kind == "report":
                    with self._cond:
                        self.reports[rank] = msg
                        self.done.add(rank)
                        self._eval_barriers()
                        self._cond.notify_all()
                else:
                    return
        except (wire.WireError, OSError, KeyError, ValueError):
            pass
        finally:
            with contextlib.suppress(OSError):
                conn.close()
            if rank is not None:
                with self._cond:
                    # a rejoined rank replaces its conn entry: the stale
                    # handler for the old socket must not kill the new one.
                    if self._conns.get(rank) is conn:
                        self.alive.discard(rank)
                        if rank not in self.done:
                            self._on_death(rank)
                    self._eval_barriers()
                    self._cond.notify_all()

    def _register(self, rank: int, conn: socket.socket, msg: dict) -> None:
        with self._cond:
            rejoin = rank in self.dead
            if rejoin:
                self.dead.discard(rank)
                self.suspected.discard(rank)
                self.rejoins += 1
                self._awaiting_rejoin.pop(rank, None)
            self.endpoints[rank] = (str(msg["host"]), int(msg["port"]))
            self._conns[rank] = conn
            self.alive.add(rank)
            self.last_msg[rank] = time.monotonic()
            _log.info(
                "rank %d registered at %s:%s%s", rank, msg["host"],
                msg["port"], " (rejoin)" if rejoin else "",
            )
            if not rejoin:
                self.joined_at.setdefault(rank, 0)
            if rejoin:
                # hand back the rank's own slice at the next unreleased
                # *window* boundary; the interim adopter drops it in the
                # same release.  Resuming mid-window would double-execute
                # the steps the adopter already ran inside the live window
                # (XOR pairs cancel out of the aggregate) — ownership only
                # ever moves on window edges.
                w = self.window_steps
                resume = (
                    0 if self.last_released_step < 0
                    else (self.last_released_step // w + 1) * w
                )
                self.joined_at[rank] = resume
                self.owner_of[rank] = rank
                pending = next(
                    (
                        a for a in self._pending_assignments
                        if int(a["node"]) == rank
                    ),
                    None,
                )
                if pending is not None:
                    # the node's reassignment was queued but never
                    # delivered: no survivor adopted it, so the rejoiner
                    # itself must cover the gap from the dead cursor.
                    pending["owner"] = rank
                    pending["endpoint"] = list(self.endpoints[rank])
                else:
                    self._pending_assignments.append({
                        "node": rank,
                        "owner": rank,
                        "from_step": resume,
                        "endpoint": list(self.endpoints[rank]),
                    })
                self._send_addrbook(conn, resume_step=resume, rejoin=True)
            elif (
                len(self.endpoints) == self.num_ranks
                and not self._addrbook_sent
            ):
                self._broadcast_addrbook()
            elif self._addrbook_sent:
                # late registrant (the others already run): it still gets
                # the book so *its* fetches work; fetches *to* it from
                # peers that never saw its endpoint fall back to PFS.
                self._send_addrbook(conn)
            for w in self.windows_sent:
                # replay every window announcement: a registrant must never
                # miss a plan segment broadcast before it connected.
                self._send_ctrl(conn, w)
            self._cond.notify_all()

    @staticmethod
    def _recv_ctrl(conn: socket.socket) -> dict:
        frame = wire.recv_frame(conn, eof_ok=True)
        if frame is None:
            raise ConnectionError("control connection closed")
        msg_type, payload = frame
        if msg_type != wire.MSG_CTRL:
            raise wire.ProtocolError(f"unexpected control frame {msg_type}")
        return wire.unpack_json(payload)

    def _send_ctrl(self, conn: socket.socket, msg: dict) -> bool:
        try:
            wire.send_frame(conn, wire.MSG_CTRL, wire.pack_json(msg))
            return True
        except OSError:
            return False

    def _send_addrbook(
        self, conn: socket.socket, *, resume_step: int = 0, rejoin: bool = False
    ) -> None:
        self._send_ctrl(conn, {
            "kind": "addrbook",
            "endpoints": {
                str(r): list(ep) for r, ep in self.endpoints.items()
            },
            "resume_step": int(resume_step),
            "rejoin": bool(rejoin),
        })

    def _broadcast_addrbook(self) -> None:  # cond held
        self._addrbook_sent = True
        for conn in self._conns.values():
            self._send_addrbook(conn)

    # -- failure detection / recovery ------------------------------------------

    def _monitor_loop(self) -> None:
        period = max(self.heartbeat_interval_s / 2.0, 0.02)
        while not self._closed.wait(period):
            with self._cond:
                now = time.monotonic()
                expired = [
                    r for r, t in self._awaiting_rejoin.items() if now > t
                ]
                if expired:
                    for r in expired:
                        _log.warning(
                            "rank %d did not rejoin in time: releasing", r
                        )
                        del self._awaiting_rejoin[r]
                    self._eval_barriers()
                for r in sorted(self.alive - self.done):
                    seen = self.last_msg.get(r)
                    if seen is None:
                        continue
                    age = now - seen
                    if r in self.suspected:
                        if age > self.suspect_timeout_s + self.probe_grace_s:
                            # fencing: close the conn; its handler thread
                            # observes the drop and runs the death path.
                            conn = self._conns.get(r)
                            if conn is not None:
                                with contextlib.suppress(OSError):
                                    conn.close()
                    elif age > self.suspect_timeout_s:
                        self.suspected.add(r)
                        self.probes_sent += 1
                        _log.warning(
                            "rank %d silent for %.2fs: suspected, probing",
                            r, age,
                        )
                        conn = self._conns.get(r)
                        if conn is not None:
                            self._send_ctrl(conn, {"kind": "probe"})

    def _peer_suspect(self, reporter: int, node: int) -> None:
        """A rank's breaker escalated on ``node``.  Advisory only: the
        coordinator acts only if the owner looks stale to *it* as well."""
        with self._cond:
            self.peer_suspicions += 1
            target = self.owner_of.get(node, node)
            if target == reporter or target not in self.alive:
                return
            seen = self.last_msg.get(target)
            if seen is None or target in self.suspected:
                return
            if time.monotonic() - seen > self.suspect_timeout_s:
                self.suspected.add(target)
                self.probes_sent += 1
                conn = self._conns.get(target)
                if conn is not None:
                    self._send_ctrl(conn, {"kind": "probe"})

    def _on_death(self, rank: int) -> None:  # cond held
        """Death bookkeeping + (in reslice mode) queue the reassignments."""
        if rank in self.dead:
            return
        self.dead.add(rank)
        self.alive.discard(rank)
        self.suspected.discard(rank)
        _log.warning("rank %d declared dead (recovery=%s)", rank, self.recovery)
        hb = self.hb_state.get(rank, {})
        if hb.get("agg"):
            # freeze the prefix the dead rank *reported* hashing; anything
            # it did after this heartbeat is redone (and counted) by the
            # adopter — exactly-once in the aggregate.
            self.dead_aggs.append(str(hb["agg"]))
        if self.recovery != "reslice":
            return
        if rank in self._restartable:
            self._restartable.discard(rank)  # respawned once
            self._awaiting_rejoin[rank] = (
                time.monotonic() + self.barrier_timeout_s / 2.0
            )
        survivors = sorted(self.alive - self.done)
        if not survivors:
            return
        cursors = hb.get("cursors", {})
        owned = sorted(n for n, o in self.owner_of.items() if o == rank)
        for i, node in enumerate(owned):
            adopter = survivors[i % len(survivors)]
            from_step = int(cursors.get(str(node), 0))
            self.owner_of[node] = adopter
            ep = self.endpoints.get(adopter)
            self._pending_assignments.append({
                "node": int(node),
                "owner": int(adopter),
                "from_step": from_step,
                "endpoint": list(ep) if ep is not None else None,
            })
            self.resliced_nodes += 1
            _log.info(
                "re-slicing node %d (from step %d) onto rank %d",
                node, from_step, adopter,
            )

    # -- barriers --------------------------------------------------------------

    def _arrive(self, rank: int, name: str) -> None:
        with self._cond:
            self._barriers.setdefault(name, set()).add(rank)
            self._eval_barriers()

    def _eval_barriers(self) -> None:  # cond held
        running = self.alive - self.done
        for name in list(self._barriers):
            # a rejoiner resuming at step r is not expected at barriers for
            # steps it never ran — without this, a registration landing
            # mid-barrier would deadlock the in-flight release.
            step = int(name.split(":", 1)[1])
            participants = {
                r for r in running if self.joined_at.get(r, 0) <= step
            }
            arrived = self._barriers[name]
            if (
                name.startswith("s:") and self._awaiting_rejoin
                and not self._pending_assignments
            ):
                # an awaited rejoin: hold step-start releases once the
                # interim adoption has gone out (class docstring).
                continue
            if participants <= arrived:
                msg = {"kind": "release", "name": name}
                if name.startswith("s:"):
                    # ownership transitions apply at step boundaries: ride
                    # the step-start release so every rank adopts/drops at
                    # the same moment, with the updated endpoints in hand.
                    step = int(name[2:])
                    self.last_released_step = max(
                        self.last_released_step, step
                    )
                    if self._pending_assignments:
                        msg["assignments"] = self._pending_assignments
                        self._pending_assignments = []
                for r in sorted(arrived & self.alive):
                    self._send_ctrl(self._conns[r], msg)
                del self._barriers[name]
                self.released_barriers.add(name)
                self._cond.notify_all()

    # -- streaming window distribution ------------------------------------------

    def broadcast_window(self, msg: dict) -> None:
        """Announce one sealed window's plan segment to every rank.

        The message is recorded and replayed to any rank that registers
        later, so delivery is reliable regardless of registration order —
        clients stash ``kind == "window"`` frames until their
        ``wait_window`` asks for that index.
        """
        with self._cond:
            msg = dict(msg, kind="window")
            self.windows_sent.append(msg)
            for conn in self._conns.values():
                self._send_ctrl(conn, msg)

    def wait_barrier(self, name: str, timeout_s: float) -> bool:
        """Block until barrier ``name`` has been released (True) or the
        timeout expires (False) — the streaming parent's lookahead pacing:
        window ``k+1`` is sealed only once every rank cut over to ``k``."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while name not in self.released_barriers:
                if self.dead and not (self.alive - self.done):
                    return False  # every remaining rank died: never releases
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    return False
            return True

    # -- parent-side waits -----------------------------------------------------

    def is_dead(self, rank: int) -> bool:
        with self._cond:
            return rank in self.dead

    def mark_dead_if_silent(self, rank: int) -> None:
        """Write off a rank whose *process* exited without ever connecting.

        Deaths of connected ranks are detected by their control connection
        dropping; a rank that crashed before registering leaves no
        connection to drop, so the launcher reports it from the process
        table.  Once every surviving rank has registered, the address book
        goes out (partial: fetches to the dead rank fall back to PFS until
        re-slicing reassigns its node).
        """
        with self._cond:
            if rank in self.done or rank in self.dead or rank in self.alive:
                return
            self._on_death(rank)
            if (
                not self._addrbook_sent
                and len(self.endpoints) + len(self.dead) >= self.num_ranks
            ):
                self._broadcast_addrbook()
            self._eval_barriers()
            self._cond.notify_all()

    def pending_detail(self) -> dict[int, float | None]:
        """Unfinished ranks -> seconds since their last control message
        (``None`` if they never spoke) — the who-is-missing for timeouts."""
        with self._cond:
            now = time.monotonic()
            pending = set(range(self.num_ranks)) - self.done - self.dead
            return {
                r: (
                    round(now - self.last_msg[r], 3)
                    if r in self.last_msg else None
                )
                for r in sorted(pending)
            }

    def wait_done(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while (self.done | self.dead) != set(range(self.num_ranks)):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    return False
            return True


# ---------------------------------------------------------------------------
# Control plane (rank side)
# ---------------------------------------------------------------------------


class _ControlClient:
    """A rank's connection to the coordinator: register, barrier, report,
    plus the liveness side-channel (heartbeat thread, probe replies,
    breaker-escalation suspicions).  All sends serialize on one lock; only
    the main thread receives."""

    def __init__(
        self, port: int, *, timeout_s: float, hb_interval_s: float = 0.2
    ):
        self.sock = socket.create_connection((_HOST, port), timeout=timeout_s)
        self.sock.settimeout(timeout_s)
        self._send_lock = threading.Lock()
        self.hb_interval_s = float(hb_interval_s)
        #: streaming window announcements received out of band (during
        #: register/barrier waits); drained by :meth:`wait_window`.
        self.windows: list[dict] = []
        #: bound by the rank loop: () -> (cursors dict, aggregate hex).
        self.progress = None
        #: optional §13 telemetry hook: () -> a small JSON-safe metric
        #: snapshot piggybacked on every heartbeat (None = no telemetry,
        #: heartbeat frames byte-identical to the pre-§13 runtime).
        self.metrics = None
        self._hb_stop = threading.Event()
        self._hb_pause_until = 0.0
        self._hb_thread: threading.Thread | None = None

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        with contextlib.suppress(OSError):
            self.sock.close()

    def _send(self, msg: dict) -> None:
        with self._send_lock:
            wire.send_frame(self.sock, wire.MSG_CTRL, wire.pack_json(msg))

    def _recv(self) -> dict:
        frame = wire.recv_frame(self.sock)
        msg_type, payload = frame
        if msg_type != wire.MSG_CTRL:
            raise wire.ProtocolError(f"unexpected control frame {msg_type}")
        return wire.unpack_json(payload)

    # -- liveness --------------------------------------------------------------

    def heartbeat(self) -> None:
        """Send one liveness beat carrying the progress snapshot."""
        snap = ({}, None) if self.progress is None else self.progress()
        cursors, agg = snap[0], snap[1]
        window = snap[2] if len(snap) > 2 else None
        msg = {
            "kind": "hb",
            "cursors": {str(k): int(v) for k, v in cursors.items()},
            "agg": agg,
            "window": window,
        }
        if self.metrics is not None:
            m = self.metrics()
            if m:
                msg["m"] = m
        self._send(msg)

    def start_heartbeats(self) -> None:
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name="solar-rank-hb", daemon=True
        )
        self._hb_thread.start()

    def _hb_loop(self) -> None:
        while not self._hb_stop.wait(self.hb_interval_s):
            if time.monotonic() < self._hb_pause_until:
                continue  # injected heartbeat loss (false-suspect harness)
            try:
                self.heartbeat()
            except OSError:
                return

    def suppress_heartbeats(self, duration_s: float) -> None:
        self._hb_pause_until = time.monotonic() + float(duration_s)

    def suspect(self, node: int) -> None:
        """Escalate a persistently-tripping breaker to the coordinator."""
        with contextlib.suppress(OSError):
            self._send({"kind": "suspect", "node": int(node)})

    # -- protocol --------------------------------------------------------------

    def register(
        self, rank: int, host: str, port: int
    ) -> tuple[dict[int, tuple[str, int]], int, bool]:
        """Announce this rank's buffer server; block for the address book.

        Returns ``(endpoints, resume_step, rejoin)``: a fresh rank resumes
        at step 0 owning its slice; a rejoining rank starts bare at
        ``resume_step`` and reclaims its slice via the assignment attached
        to that step's release.
        """
        self._send({
            "kind": "register", "rank": rank, "host": host, "port": port,
        })
        while True:
            msg = self._recv()
            if msg.get("kind") == "probe":
                self.heartbeat()
            elif msg.get("kind") == "window":
                self.windows.append(msg)
            elif msg.get("kind") == "addrbook":
                return (
                    {
                        int(r): (str(ep[0]), int(ep[1]))
                        for r, ep in msg["endpoints"].items()
                    },
                    int(msg.get("resume_step", 0)),
                    bool(msg.get("rejoin", False)),
                )

    def barrier(self, name: str) -> dict:
        """Arrive at ``name``; block for the release, answering probes.

        Returns the release message itself — step-start releases may carry
        ownership ``assignments`` and endpoint updates.
        """
        tr = obs_trace.get()
        t0 = tr.t()
        self._send({"kind": "barrier", "name": name})
        while True:
            msg = self._recv()
            if msg.get("kind") == "probe":
                self.heartbeat()
            elif msg.get("kind") == "window":
                self.windows.append(msg)
            elif msg.get("kind") == "release" and msg.get("name") == name:
                try:
                    step = int(name.split(":", 1)[1])
                except (IndexError, ValueError):
                    step = -1
                tr.rec(obs_trace.BARRIER_WAIT, t0, a=step)
                return msg

    def wait_window(self, index: int, timeout_s: float | None = None) -> dict:
        """Block until the window announcement for ``index`` arrives.

        Checks the stash first (announcements routinely land during barrier
        waits), then receives — answering probes and stashing other windows
        — until the wanted index shows up or ``timeout_s`` passes.
        """
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        while True:
            for w in self.windows:
                if int(w.get("index", -1)) == int(index):
                    return w
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"no window {index} announcement within {timeout_s}s"
                )
            msg = self._recv()
            if msg.get("kind") == "probe":
                self.heartbeat()
            elif msg.get("kind") == "window":
                self.windows.append(msg)

    def report(self, payload: dict) -> None:
        self._send(dict(payload, kind="report"))


# ---------------------------------------------------------------------------
# Rank worker (child process entry point — must stay module-level + picklable)
# ---------------------------------------------------------------------------


def _rank_main(rank: int, cfg: dict) -> None:
    """One rank: load plan by hash, serve the buffer, replay the slice —
    and, under recovery, adopt/drop orphaned slices at window boundaries.

    Epoch-window protocol (DESIGN.md §11): with ``prefetch_depth = d`` the
    window is ``d + 1`` steps; ranks barrier only at window boundaries and
    run freely (and skewed, up to ``d`` steps apart) inside one, with each
    step's coalesced chunk reads issued up to ``d`` steps ahead.  The
    buffer server absorbs the skew: its window guard serves any step in the
    live window from the matching snapshot.  ``d = 0`` degenerates to
    one-barrier-per-step lockstep.
    """
    from repro_torch.core.plan import Schedule
    from repro_torch.data.loaders import update_batch_digest
    from repro_torch.data.peer import SocketTransport
    from repro_torch.data.pipeline import build_store, execute
    from repro_torch.data.prefetch import WindowReadAhead
    from repro_torch.runtime import faults as faults_mod
    from repro_torch.runtime.server import BufferServer

    spec = cfg["spec"]
    barrier_timeout_s = float(cfg["barrier_timeout_s"])
    depth = max(int(cfg.get("prefetch_depth", 0)), 0)
    window_steps = depth + 1
    # -- observability (§13): a spawned process starts bare — re-install the
    # rank-tagged logger and, when the parent asked for a trace, the flight
    # recorder.  With no "obs" entry every tracer call below is the no-op
    # singleton and the run is byte-identical to the untraced runtime.
    obs_cfg = cfg.get("obs") or {}
    obs_log.configure(int(obs_cfg.get("verbosity", 0)), rank=rank)
    if obs_cfg.get("trace_dir"):
        obs_trace.enable(capacity=int(obs_cfg.get("capacity", 65536)))
    tr = obs_trace.get()
    step_hist = obs_metrics.Histogram()   # whole rank-loop iteration
    fetch_hist = obs_metrics.Histogram()  # peer-gather + execute (data path)
    armed = faults_mod.arm(cfg.get("fault_plan"), rank)
    crash_at = armed.crash_step() if armed is not None else None
    if cfg.get("die_at_step") is not None:
        crash_at = int(cfg["die_at_step"])

    ctrl = _ControlClient(
        cfg["control_port"], timeout_s=barrier_timeout_s,
        hb_interval_s=float(cfg.get("heartbeat_interval_s", 0.2)),
    )
    store = build_store(spec)
    server = None
    transport = None
    tier = None
    readahead = None
    owned: dict[int, object] = {}   # node -> its ScheduleExecutor
    iters: dict[int, object] = {}   # node -> that executor's plan walk
    try:
        schedule = Schedule.load(cfg["plan_path"])
        digest = schedule.artifact_digest()
        if digest != cfg["plan_digest"]:
            raise RuntimeError(
                f"rank {rank}: plan artifact digest {digest} != the "
                f"launcher's {cfg['plan_digest']} — refusing to execute a "
                "plan I cannot verify"
            )
        total_steps = schedule.num_steps

        server = BufferServer(
            rank, store.sample_shape, store.dtype, host=_HOST, port=0,
            skew_window=window_steps,
        ).start()
        endpoints, resume_step, rejoining = ctrl.register(
            rank, server.host, server.port
        )

        def _mirror_for(node):
            ex = owned.get(node)
            return None if ex is None else ex._mirror(node)

        transport = SocketTransport(
            {r: ep for r, ep in endpoints.items() if r != rank},
            self_node=rank,
            mirror_of=_mirror_for,
            sample_shape=store.sample_shape,
            dtype=store.dtype,
            timeout_s=min(barrier_timeout_s, 5.0),
            retry=cfg.get("retry"),
            escalate=ctrl.suspect,
        )
        server.attach(_mirror_for)

        if cfg.get("serve_tier") is not None:
            # multi-tenant serving (DESIGN.md §12): open this rank's buffer
            # server to attached tenants, with misses residency-routed to
            # peers before the PFS.  Strictly additive — with no tenants
            # attached the fast path never observes it.
            from repro_torch.serve.datatier import wire_rank_tier

            tier = wire_rank_tier(
                server=server,
                schedule=schedule,
                store=store,
                endpoints={
                    r: ep for r, ep in endpoints.items() if r != rank
                },
                config=cfg["serve_tier"],
                cluster_token=cfg["cluster_token"],
            )

        # -- progress accounting (heartbeat payload) -------------------------
        h = hashlib.sha256()          # own-node stream digest (parity tests)
        agg = bytearray(32)           # XOR of per-(step, node) batch digests
        cursors: dict[int, int] = {}  # node -> next step to execute
        resliced_samples = 0
        prog_lock = threading.Lock()
        #: current epoch window index (heartbeats carry it as the window
        #: cursor; mutated only by the rank loop, read by the hb thread).
        win_state = {"window": 0}
        #: boundaries at which this rank adopted orphaned nodes — the
        #: invariant chaos tests pin: adoption lands on window edges only.
        adoption_boundaries: list[int] = []

        def _record(node: int, step_idx: int, sb, *, adopted: bool) -> None:
            nonlocal resliced_samples
            d = hashlib.sha256()
            update_batch_digest(d, sb)
            with prog_lock:
                # one lock makes (cursors, agg) an atomic snapshot: the
                # coordinator re-slices from exactly what was reported.
                _xor_into(agg, d.digest())
                cursors[node] = step_idx + 1
            if adopted:
                resliced_samples += int(sum(x.size for x in sb.node_ids))

        def _progress():
            with prog_lock:
                return dict(cursors), bytes(agg).hex(), win_state["window"]

        ctrl.progress = _progress
        if obs_cfg.get("telemetry"):
            def _metrics_snap():
                # compact on purpose: a heartbeat rides the control plane,
                # so the live snapshot is quantiles + counts, never buckets.
                return {
                    "steps": step_hist.count,
                    "step_p50_ms": step_hist.quantile_us(0.50) / 1e3,
                    "step_p95_ms": step_hist.quantile_us(0.95) / 1e3,
                    "fetch_p95_ms": fetch_hist.quantile_us(0.95) / 1e3,
                }

            ctrl.metrics = _metrics_snap
        ctrl.start_heartbeats()

        #: (node, step) -> the pulled (EpochPlan, NodeStepPlan-slice,
        #: chunk-read futures) for steps not yet executed.  Pulling
        #: (``next()`` on the plan walk) is pure in steady state, so the
        #: loop runs it up to ``depth`` steps ahead and issues the chunk
        #: reads concurrently; the first pull after a fast-forward
        #: restages the node's buffer mirror, which is why each window's
        #: first step is primed *before* the boundary barrier — peers may
        #: fetch the moment the release lands.
        prefetched: dict[tuple[int, int], tuple] = {}
        #: node -> next step index to pull from its plan walk.
        pulled: dict[int, int] = {}
        readahead = (
            WindowReadAhead(spec.num_workers)
            if depth > 0 and spec.collect_data else None
        )

        if rejoining:
            # a rejoiner owns nothing until it reclaims its slice at the
            # resume boundary: refuse fetches instead of serving an
            # unstaged mirror.
            server.drop(rank)
        else:
            ex = execute(
                spec, schedule.for_node(rank), store=store,
                peer_transport=transport,
            )
            owned[rank] = ex
            iters[rank] = ex.plan_steps()
            pulled[rank] = int(resume_step)

        def _adopt(node: int, from_step: int, boundary: int) -> None:
            """Take over ``node``'s plan: rebuild its mirror at the current
            boundary (delta replay + one coalesced restage via
            ``fast_forward``), replay catch-up steps from the store, then
            start serving it.  Runs outside the server's mutation lock: the
            node is not in ``serving`` yet, so peers racing this get the
            all-False refusal (PFS fallback), never a half-built mirror.
            """
            ex = execute(
                spec, schedule.for_node(node), store=store,
                peer_transport=transport,
            )
            if from_step > 0:
                ex.fast_forward(from_step)
            it = ex.plan_steps()
            owned[node] = ex
            iters[node] = it
            if node != rank:
                transport.add_local(node)
            for s in range(from_step, boundary):
                cep, csp = next(it)
                # catch-up replays without peer traffic: a peer row's PFS
                # fallback is digest-identical, and the sources' mirrors
                # are already past these steps anyway.
                sb = ex.execute_step(
                    cep, csp, peer_arrays=[None] * len(csp.nodes)
                )
                if sb.node_ids:
                    _record(node, s, sb, adopted=True)
                else:
                    with prog_lock:
                        cursors[node] = s + 1
            if boundary < total_steps:
                # prime the boundary step now — with zero catch-up this
                # first next() performs the coalesced restage, which must
                # finish before the node becomes fetchable.
                cep, csp = next(it)
                prefetched[(node, boundary)] = (cep, csp, None)
                pulled[node] = boundary + 1
            else:
                pulled[node] = boundary
            adoption_boundaries.append(int(boundary))
            server.adopt(node)

        def _apply_release(rel: dict, boundary: int) -> None:
            assignments = rel.get("assignments", ())
            if not assignments:
                return
            # last entry per node wins: a death-reassignment and a rejoin
            # reclaim can ride the same release, and only the final owner
            # should adopt (an intermediate adopter would double-hash the
            # catch-up steps).
            final: dict[int, dict] = {}
            for a in assignments:
                final[int(a["node"])] = a
            moved: dict[int, tuple[str, int]] = {}
            for node in sorted(final):
                a = final[node]
                owner = int(a["owner"])
                from_step = int(a["from_step"])
                endpoint = a.get("endpoint")
                if owner == rank:
                    if node not in owned:
                        _adopt(node, from_step, boundary)
                else:
                    if node in owned and node != rank:
                        # ownership moved away (a rejoined rank reclaimed
                        # it): stop executing and serving it here.
                        server.drop(node)
                        owned.pop(node, None)
                        iters.pop(node, None)
                        pulled.pop(node, None)
                        for key in [k for k in prefetched if k[0] == node]:
                            del prefetched[key]
                        transport.remove_local(node)
                    if endpoint is not None and node != rank:
                        moved[node] = (str(endpoint[0]), int(endpoint[1]))
            if moved:
                transport.update_endpoints(moved)

        idx = int(resume_step)
        t0 = time.perf_counter()
        while idx < total_steps:
            tr.set_step(idx)
            t_step = time.perf_counter()
            win_state["window"] = idx // window_steps
            if idx % window_steps == 0:
                # Window boundary: the ONLY synchronization point (DESIGN.md
                # §11).  Prime each owned node's first step before
                # publishing — the first pull after a fast-forward restages
                # the mirror, and peers may fetch the moment the release
                # lands.
                t_prime = time.perf_counter()
                for node in sorted(owned):
                    if pulled[node] <= idx:
                        cep, csp = next(iters[node])
                        prefetched[(node, idx)] = (cep, csp, None)
                        pulled[node] = idx + 1
                server.at_step(idx)
                tr.rec(obs_trace.STEP_PRIME, t_prime)
                release = ctrl.barrier(f"s:{idx}")
                _apply_release(release, idx)
            if crash_at is not None and idx == crash_at:
                os._exit(17)  # fault injection: vanish mid-step, no cleanup
            if armed is not None:
                stall = armed.stall(idx)
                if stall > 0:
                    # false-suspect harness: go silent without dying —
                    # heartbeats suppressed AND the step loop wedged.
                    ctrl.suppress_heartbeats(stall)
                    time.sleep(stall)
            # Pull ahead up to `depth` steps, clipped to the window edge,
            # and issue their coalesced chunk reads concurrently.  The
            # current step's reads stay synchronous (execute_step performs
            # them); only strictly-future steps ride the read-ahead pool.
            horizon = min(total_steps, (idx // window_steps + 1) * window_steps)
            t_prime = time.perf_counter()
            for node in sorted(owned):
                tgt = min(idx + 1 + depth, horizon)
                while pulled[node] < tgt:
                    step_i = pulled[node]
                    cep, csp = next(iters[node])
                    futs = (
                        readahead.submit(owned[node].store, csp)
                        if readahead is not None and step_i > idx else None
                    )
                    prefetched[(node, step_i)] = (cep, csp, futs)
                    pulled[node] = step_i + 1
            tr.rec(obs_trace.STEP_PRIME, t_prime)
            # Inside the window ranks run skewed: no f: barrier.  The
            # serving side's window-skew guard (history overlay for lag,
            # bounded wait for lead) keeps every fetched byte exact, and a
            # refusal beyond the window degrades to the PFS fallback —
            # digest-identical either way.
            server.at_step(idx)
            if tier is not None:
                tier.at_step(idx)
            transport.at_step(idx, window=idx // window_steps)
            t_fetch = time.perf_counter()
            gathered = {
                node: owned[node].gather_peers(prefetched[(node, idx)][1])
                for node in sorted(owned)
            }
            tr.rec(obs_trace.STEP_PEER, t_fetch)
            t_exec = time.perf_counter()
            with server.mutating(idx):
                for node in sorted(owned):
                    cep, csp, futs = prefetched.pop((node, idx))
                    sb = owned[node].execute_step(
                        cep, csp,
                        chunk_arrays=WindowReadAhead.collect(futs),
                        peer_arrays=gathered[node],
                    )
                    if sb.node_ids:
                        if node == rank:
                            update_batch_digest(h, sb)
                        _record(node, idx, sb, adopted=node != rank)
                    else:
                        # an empty for_node slice at this step: nothing to
                        # hash — the reference digests only cover steps a
                        # node appears in — but the cursor still advances.
                        with prog_lock:
                            cursors[node] = idx + 1
            t_done = time.perf_counter()
            tr.rec(obs_trace.STEP_EXECUTE, t_exec, t_done)
            fetch_hist.record((t_done - t_fetch) * 1e6)
            # synchronous beat: the coordinator sees this step's cursors
            # and aggregate before the next boundary can re-slice them.
            t_hb = time.perf_counter()
            with contextlib.suppress(OSError):
                ctrl.heartbeat()
            tr.rec(obs_trace.HB_SEND, t_hb)
            t_end = time.perf_counter()
            step_hist.record((t_end - t_step) * 1e6)
            tr.rec(obs_trace.STEP, t_step, t_end)
            idx += 1
        # Closing barrier: without the per-step f: fence a fast rank could
        # tear down its buffer server while a peer up to `depth` steps
        # behind still fetches from it.  One extra rendezvous pins the
        # teardown to the run's true end (and lets a death in the final
        # window re-slice here, on a boundary, like any other).
        release = ctrl.barrier(f"s:{total_steps}")
        _apply_release(release, total_steps)
        wall = time.perf_counter() - t0

        summary: dict = {}
        served_by_source: dict[int, int] = {}
        peer_served = 0
        peer_fallbacks = 0
        for node in sorted(owned):
            ex_rep = owned[node].report.summary()
            if node == rank:
                summary = dict(ex_rep)
            else:
                for k in ("numPFS", "misses", "remote_fetches"):
                    summary[k] = summary.get(k, 0) + int(ex_rep.get(k, 0))
            pe = owned[node].peer_exchange
            if pe is not None:
                peer_served += int(pe.served)
                peer_fallbacks += int(pe.fallbacks)
                for k, v in pe.served_by_source.items():
                    served_by_source[int(k)] = (
                        served_by_source.get(int(k), 0) + int(v)
                    )
        cursors_snap, agg_hex, _ = _progress()
        reg = obs_metrics.MetricsRegistry()
        reg.fold("loader", summary)
        reg.fold("ladder", transport.stats())
        reg.fold("tenant", server.tenant_stats())
        ctrl.report({
            "rank": rank,
            "digest": h.hexdigest(),
            "agg": agg_hex,
            "steps": idx - int(resume_step),
            "summary": summary,
            "served_by_source": {
                str(k): int(v) for k, v in served_by_source.items()
            },
            "peer_served": peer_served,
            "peer_fallbacks": peer_fallbacks,
            "stale_refusals": int(server.stale_refusals),
            "resliced_samples": int(resliced_samples),
            "adopted_nodes": sorted(int(n) for n in owned if n != rank),
            "transport": transport.stats(),
            "faults_fired": armed.summary() if armed is not None else {},
            "rejoined": bool(rejoining),
            "wall_time_s": round(wall, 4),
            "cursors": {str(k): int(v) for k, v in cursors_snap.items()},
            "window_steps": int(window_steps),
            "max_observed_skew": int(server.max_observed_skew),
            "adoption_boundaries": [int(b) for b in adoption_boundaries],
            "tenants": server.tenant_stats(),
            "latency": obs_metrics.latency_summary(step_hist, fetch_hist),
            "latency_hist": {
                "step_us": step_hist.bucket_dict(),
                "fetch_us": fetch_hist.bucket_dict(),
            },
            "metrics": reg.snapshot(),
        })
    finally:
        if tier is not None:
            tier.close()
        if readahead is not None:
            readahead.close()
        if server is not None:
            server.close()
        if transport is not None:
            transport.close()
        store.close()
        ctrl.close()
        faults_mod.disarm()
        tracer = obs_trace.disable()
        if tracer is not None and obs_cfg.get("trace_dir"):
            with contextlib.suppress(OSError):
                tracer.dump(obs_cfg["trace_dir"], rank=rank)


# ---------------------------------------------------------------------------
# Aggregated run report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RankResult:
    rank: int
    #: ``ok`` (report received) or ``dead`` (process vanished mid-run).
    status: str
    digest: str | None = None
    #: the rank's XOR aggregate over every (step, node) batch it executed —
    #: including adopted nodes and catch-up replays.
    agg: str | None = None
    steps: int = 0
    #: the rank's LoaderReport summary (numPFS, misses, remote, ...).
    summary: dict = dataclasses.field(default_factory=dict)
    #: samples this rank's *peers* report were served by each source.
    served_by_source: dict[int, int] = dataclasses.field(default_factory=dict)
    peer_served: int = 0
    peer_fallbacks: int = 0
    stale_refusals: int = 0
    #: samples this rank executed on behalf of dead ranks' slices.
    resliced_samples: int = 0
    adopted_nodes: list[int] = dataclasses.field(default_factory=list)
    #: transport failure-ladder counters (retries, breaker_opens, ...).
    transport: dict = dataclasses.field(default_factory=dict)
    #: which armed faults actually fired in this rank's process.
    faults_fired: dict = dataclasses.field(default_factory=dict)
    rejoined: bool = False
    #: seconds between the rank's last control message and run collection
    #: (``None`` for ranks that reported normally).
    last_heartbeat_age_s: float | None = None
    wall_time_s: float = 0.0
    exitcode: int | None = None
    #: final per-node progress cursors (node -> next step index).
    cursors: dict[int, int] = dataclasses.field(default_factory=dict)
    #: the epoch-window length the rank ran with (``prefetch_depth + 1``).
    window_steps: int = 1
    #: widest requester-vs-server step skew the rank's buffer server
    #: actually observed while serving windowed fetches.
    max_observed_skew: int = 0
    #: window boundaries at which this rank adopted orphaned nodes.
    adoption_boundaries: list[int] = dataclasses.field(default_factory=list)
    #: tenant-serving counters from this rank's buffer server (empty when
    #: serving is off): tenant_hits / tenant_peer_reads /
    #: tenant_pfs_fallbacks / tenant_sheds + a per_tenant breakdown.
    tenants: dict = dataclasses.field(default_factory=dict)
    #: §13 step/fetch latency quantiles (step_ms_p50/p95/p99, fetch_ms_*).
    latency: dict = dataclasses.field(default_factory=dict)
    #: raw log2 histogram buckets (µs) behind ``latency`` — mergeable
    #: across ranks for the cluster quantiles in ``summary()``.
    latency_hist: dict = dataclasses.field(default_factory=dict)
    #: MetricsRegistry snapshot: the rank's loader/ladder/tenant counters
    #: re-exported under one namespace (``loader.numPFS``, ...).
    metrics: dict = dataclasses.field(default_factory=dict)

    def window_cursors(self) -> dict[int, list[int]]:
        """Each node's cursor as a ``[window, step-in-window]`` pair."""
        w = max(int(self.window_steps), 1)
        return {n: [c // w, c % w] for n, c in sorted(self.cursors.items())}


@dataclasses.dataclass
class DistributedReport:
    """What one ``run_distributed`` produced, aggregated over all ranks."""

    num_ranks: int
    ranks: list[RankResult]
    plan_digest: str
    wall_time_s: float
    recovery: str = "reslice"
    #: aggregate digests frozen from dead ranks' last heartbeats — the
    #: prefix work that does not need redoing, XORed into the aggregate.
    dead_aggs: list[str] = dataclasses.field(default_factory=list)
    false_suspects: int = 0
    peer_suspicions: int = 0
    rejoins: int = 0
    resliced_nodes: int = 0

    @property
    def dead(self) -> list[int]:
        return [r.rank for r in self.ranks if r.status != "ok"]

    @property
    def ok(self) -> bool:
        return not self.dead

    def digests(self) -> dict[int, str | None]:
        return {r.rank: r.digest for r in self.ranks}

    @property
    def resliced_samples(self) -> int:
        return sum(r.resliced_samples for r in self.ranks)

    def aggregate_digest(self) -> str:
        """XOR of every reported per-(step, node) batch digest.

        Survivor finals already include adopted and catch-up work; dead
        ranks contribute the prefix frozen in their last heartbeat.  Equal
        to :func:`in_process_aggregate` iff the run executed the planned
        global sample stream exactly once — re-sliced, rejoined, or not.
        """
        acc = bytearray(32)
        for r in self.ranks:
            if r.status == "ok" and r.agg:
                _xor_into(acc, bytes.fromhex(r.agg))
        for a in self.dead_aggs:
            _xor_into(acc, bytes.fromhex(a))
        return bytes(acc).hex()

    def summary(self) -> dict:
        """One JSON-safe run report: per-rank rows + cross-rank aggregates."""
        agg_keys = ("numPFS", "misses", "remote_fetches")
        agg = {k: 0 for k in agg_keys}
        ladder_keys = (
            "retries", "breaker_opens", "breaker_skips", "escalations",
            "unknown_source_fallbacks",
        )
        ladder = {k: 0 for k in ladder_keys}
        tenant_keys = (
            "tenant_hits", "tenant_peer_reads", "tenant_pfs_fallbacks",
            "tenant_sheds",
        )
        tenant_agg = {k: 0 for k in tenant_keys}
        serving: dict[int, int] = {}
        for r in self.ranks:
            for k in agg_keys:
                agg[k] += int(r.summary.get(k, 0))
            for k in ladder_keys:
                ladder[k] += int(r.transport.get(k, 0))
            for k in tenant_keys:
                tenant_agg[k] += int(r.tenants.get(k, 0))
            for src, n in r.served_by_source.items():
                serving[int(src)] = serving.get(int(src), 0) + int(n)
        return {
            "num_ranks": self.num_ranks,
            "dead_ranks": self.dead,
            "recovery": self.recovery,
            "plan_digest": self.plan_digest,
            "aggregate_digest": self.aggregate_digest(),
            "wall_time_s": round(self.wall_time_s, 4),
            "peer_served": sum(r.peer_served for r in self.ranks),
            "peer_fallbacks": sum(r.peer_fallbacks for r in self.ranks),
            "stale_refusals": sum(r.stale_refusals for r in self.ranks),
            "resliced_samples": self.resliced_samples,
            "resliced_nodes": self.resliced_nodes,
            "rejoins": self.rejoins,
            "false_suspects": self.false_suspects,
            "peer_suspicions": self.peer_suspicions,
            "stale_refusal_fallbacks": sum(
                int(r.transport.get("stale_refusal_fallbacks", 0))
                for r in self.ranks
            ),
            "max_observed_skew": max(
                (r.max_observed_skew for r in self.ranks), default=0
            ),
            "latency": self._cluster_latency(),
            **ladder,
            **tenant_agg,
            "served_by_source": {str(k): serving[k] for k in sorted(serving)},
            **agg,
            "ranks": [
                {
                    "rank": r.rank,
                    "status": r.status,
                    "digest": r.digest,
                    "steps": r.steps,
                    "exitcode": r.exitcode,
                    "resliced_samples": r.resliced_samples,
                    "adopted_nodes": r.adopted_nodes,
                    "rejoined": r.rejoined,
                    "faults_fired": r.faults_fired,
                    "last_heartbeat_age_s": r.last_heartbeat_age_s,
                    "wall_time_s": r.wall_time_s,
                    # window-aware progress: each node's final cursor as a
                    # (window, step-in-window) pair, plus the widest fetch
                    # skew this rank's server actually served.
                    "window_steps": r.window_steps,
                    "window_cursors": {
                        str(n): wc for n, wc in r.window_cursors().items()
                    },
                    "max_observed_skew": r.max_observed_skew,
                    "adoption_boundaries": r.adoption_boundaries,
                    "tenants": r.tenants,
                    "latency": r.latency,
                    **{k: r.summary.get(k) for k in agg_keys},
                }
                for r in self.ranks
            ],
        }

    def _cluster_latency(self) -> dict:
        """Cluster-wide step/fetch quantiles from the mergeable per-rank
        log2 histograms (§13) — exact bucket merges, not quantile averages."""
        step = obs_metrics.merge_histograms(
            r.latency_hist.get("step_us", {}) for r in self.ranks
        )
        fetch = obs_metrics.merge_histograms(
            r.latency_hist.get("fetch_us", {}) for r in self.ranks
        )
        return obs_metrics.latency_summary(step, fetch)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

_RECOVERY_MODES = ("reslice", "degrade")


def _validate_config(**kv: float) -> None:
    bad = [
        f"{name}={value!r} (must be > 0)"
        for name, value in kv.items()
        if not (isinstance(value, (int, float)) and value > 0)
    ]
    if bad:
        raise LauncherConfigError(
            "invalid launcher configuration: " + "; ".join(bad)
        )


def run_distributed(
    spec,
    *,
    schedule=None,
    run_dir: str | None = None,
    timeout_s: float = 300.0,
    barrier_timeout_s: float = 60.0,
    die_at_step: Mapping[int, int] | None = None,
    faults=None,
    recovery: str = "reslice",
    restart_ranks=None,
    heartbeat_interval_s: float = 0.2,
    suspect_timeout_s: float = 2.0,
    probe_grace_s: float = 2.0,
    retry=None,
    serve_tier=None,
    on_tier_ready=None,
    trace_dir: str | None = None,
    trace_capacity: int = 65536,
    metrics_out: str | None = None,
    telemetry: bool | None = None,
    verbosity: int = 0,
) -> DistributedReport:
    """Execute ``spec``'s plan as ``spec.num_nodes`` real OS processes.

    The spec must be **path-based** (each rank reopens the store through the
    backend registry — an open store handle cannot cross a spawn boundary)
    and is normalized for the ranks: ``transport="socket"``,
    ``collect_data=True``.  ``spec.prefetch_depth`` selects the epoch-window
    cadence (DESIGN.md §11): ranks barrier only every ``depth + 1`` steps
    and run skewed inside the window with that many steps of chunk reads in
    flight; ``0`` degenerates to one-barrier-per-step lockstep.  The
    resulting digests are depth-invariant.

    Fault injection: ``die_at_step`` maps rank -> global step index at
    which that rank is killed mid-step (``os._exit``); ``faults`` takes a
    :class:`~repro_torch.runtime.faults.FaultPlan` arming the full site catalog
    (frame corruption/truncation, dial resets, slow serving, crashes,
    heartbeat loss).

    Recovery: ``"reslice"`` (default) reassigns a dead rank's remaining
    plan to survivors at the next step boundary; ``"degrade"`` keeps the
    plain failover (survivors fall back to the PFS for the dead rank's
    rows).  ``restart_ranks`` names ranks respawned once after death — the
    restarted process re-registers and reclaims its slice (a rejoin); the
    survivors hold their next step-start release until it has registered
    (:class:`_Coordinator`).

    Raises ``TimeoutError`` — naming the pending ranks and their last
    heartbeat ages — only if the run as a whole exceeds ``timeout_s`` even
    after dead ranks are written off.

    Tenant serving (DESIGN.md §12): ``serve_tier`` takes a
    :class:`~repro_torch.serve.datatier.ServeTierConfig`; every rank then opens
    its buffer server to the configured tenants, with a shared
    digest-derived cluster token authenticating server-to-server proxy
    reads (override via ``serve_tier.cluster_token``).  When
    ``serve_tier.plan_service`` is set the parent also serves the run's
    schedule by content hash.  ``on_tier_ready`` is called once, from the
    parent, the moment the address book has been broadcast — its dict
    argument carries ``endpoints`` (rank -> buffer-server address),
    ``plan_digest``, ``cluster_token``, and ``plan_service`` (address or
    ``None``) — the hook tenant clients attach through mid-run.

    Observability (DESIGN.md §13): ``trace_dir`` turns on each rank's
    flight recorder and dumps ``trace-rank{N}.jsonl`` +
    ``trace-rank{N}.trace.json`` (Chrome trace-event) there at teardown
    (``trace_capacity`` spans per ring, oldest overwritten);
    ``metrics_out`` writes the coordinator's heartbeat-borne telemetry
    time-series plus the final ``summary()`` as one JSON file.
    ``telemetry`` forces the per-heartbeat metric snapshots on/off
    (default: on iff ``metrics_out`` is set); ``verbosity`` sets the
    ranks' structured-log level (0=WARNING, 1=INFO, 2=DEBUG, -1=ERROR).
    With all of these at their defaults every rank runs the no-op tracer
    and the run is digest- and counter-identical to an unobserved one.
    """
    import dataclasses as _dc

    from repro_torch.data.peer import RetryPolicy
    from repro_torch.data.pipeline import plan as plan_fn

    _validate_config(
        timeout_s=timeout_s,
        barrier_timeout_s=barrier_timeout_s,
        heartbeat_interval_s=heartbeat_interval_s,
        suspect_timeout_s=suspect_timeout_s,
        probe_grace_s=probe_grace_s,
    )
    if recovery not in _RECOVERY_MODES:
        raise LauncherConfigError(
            f"unknown recovery mode {recovery!r}; have {_RECOVERY_MODES}"
        )
    if spec.store is not None:
        raise ValueError(
            "run_distributed needs a path-based LoaderSpec: every rank "
            "reopens the store itself; a live store handle cannot be "
            "shipped to a spawned process"
        )
    # prefetch_depth=0 keeps execute() returning a bare ScheduleExecutor —
    # the rank loop drives the window cadence itself (cfg["prefetch_depth"]).
    child_spec = spec.replace(
        transport="socket", collect_data=True, prefetch_depth=0,
        plan_cache=None, plan_path=None,
    )
    child_spec.validate()
    prefetch_depth = max(int(spec.prefetch_depth), 0)
    if schedule is None:
        schedule = plan_fn(spec)
    if schedule.num_nodes != spec.num_nodes:
        raise ValueError(
            f"schedule plans {schedule.num_nodes} nodes, spec asks for "
            f"{spec.num_nodes}"
        )

    own_dir = run_dir is None
    if own_dir:
        run_dir = tempfile.mkdtemp(prefix="solar_dist_")
    plan_path = os.path.join(run_dir, "plan.npz")
    schedule.save(plan_path)
    plan_digest = schedule.artifact_digest()
    cleanup_dir = run_dir if own_dir else None

    cluster_token = None
    plan_svc = None
    if serve_tier is not None:
        serve_tier.validate()
        # shared by construction, never on the wire in the clear at rest:
        # every rank derives nothing — the parent mints one token per run
        # (deterministic from the plan digest unless overridden) and ships
        # it inside each rank's cfg.
        cluster_token = (
            serve_tier.cluster_token
            if serve_tier.cluster_token is not None
            else hashlib.sha256(
                ("solar-tier:" + plan_digest).encode()
            ).hexdigest()[:32]
        )
        if serve_tier.plan_service:
            from repro_torch.core.planners import PlanCache
            from repro_torch.serve.datatier import PlanService

            plan_svc = PlanService(
                PlanCache(os.path.join(run_dir, "plan_cache"))
            ).start()
            plan_svc.publish(schedule)

    obs_cfg = {
        "trace_dir": trace_dir,
        "capacity": int(trace_capacity),
        "telemetry": bool(
            telemetry if telemetry is not None else metrics_out is not None
        ),
        "verbosity": int(verbosity),
    }
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)

    base_retry = retry if retry is not None else RetryPolicy()
    restart_ranks = frozenset(int(r) for r in (restart_ranks or ()))
    coord = _Coordinator(
        spec.num_nodes,
        barrier_timeout_s=barrier_timeout_s,
        recovery=recovery,
        heartbeat_interval_s=heartbeat_interval_s,
        suspect_timeout_s=suspect_timeout_s,
        probe_grace_s=probe_grace_s,
        window_steps=prefetch_depth + 1,
        restart_ranks=restart_ranks,
    ).start()
    ctx = multiprocessing.get_context("spawn")
    procs: list = []
    old_procs: list = []
    cfgs: list[dict] = []
    restarted: set[int] = set()
    t0 = time.perf_counter()
    try:
        for rank in range(spec.num_nodes):
            cfg = {
                "spec": child_spec,
                "plan_path": plan_path,
                "plan_digest": plan_digest,
                "control_port": coord.port,
                "barrier_timeout_s": barrier_timeout_s,
                "heartbeat_interval_s": heartbeat_interval_s,
                "die_at_step": (die_at_step or {}).get(rank),
                "fault_plan": faults,
                "prefetch_depth": prefetch_depth,
                # per-rank jitter streams stay decorrelated and seeded.
                "retry": _dc.replace(base_retry, seed=base_retry.seed + rank),
                "serve_tier": serve_tier,
                "cluster_token": cluster_token,
                "obs": obs_cfg,
            }
            cfgs.append(cfg)
            p = ctx.Process(
                target=_rank_main, args=(rank, cfg),
                name=f"solar-rank-{rank}", daemon=True,
            )
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        tier_announced = on_tier_ready is None
        # a short poll: a death is respawned promptly (the survivors hold
        # their next release for the rejoiner, _Coordinator's docstring).
        while not coord.wait_done(0.1):
            if not tier_announced:
                with coord._cond:
                    book_out = coord._addrbook_sent
                    eps = dict(coord.endpoints)
                if book_out:
                    # every rank is registered and serving: tenants may
                    # attach from here on.  Fired once, from the parent —
                    # clients run concurrently with the training run.
                    tier_announced = True
                    on_tier_ready({
                        "endpoints": eps,
                        "plan_digest": plan_digest,
                        "cluster_token": cluster_token,
                        "plan_service": (
                            (plan_svc.host, plan_svc.port)
                            if plan_svc is not None else None
                        ),
                    })
            for rank in range(spec.num_nodes):
                p = procs[rank]
                if p.exitcode is None:
                    continue
                if (
                    rank in restart_ranks
                    and rank not in restarted
                    and recovery == "reslice"
                    and coord.is_dead(rank)
                ):
                    # rejoin: one respawn, with the lethal faults stripped
                    # (a restarted rank re-crashing at the same step would
                    # never make progress).
                    restarted.add(rank)
                    cfg2 = dict(
                        cfgs[rank], die_at_step=None, fault_plan=None
                    )
                    p2 = ctx.Process(
                        target=_rank_main, args=(rank, cfg2),
                        name=f"solar-rank-{rank}-rejoin", daemon=True,
                    )
                    p2.start()
                    old_procs.append(p)
                    procs[rank] = p2
                elif rank not in restarted:
                    # a child that crashed before ever connecting leaves no
                    # control connection to drop — report it from the
                    # process table.
                    coord.mark_dead_if_silent(rank)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"distributed run did not finish within {timeout_s}s: "
                    f"done={sorted(coord.done)} dead={sorted(coord.dead)} "
                    f"pending(last-contact ages s)={coord.pending_detail()}"
                )
        deadline = time.monotonic() + 10.0
        for p in procs + old_procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs + old_procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        pending_ages = coord.pending_detail()
        if plan_svc is not None:
            plan_svc.close()
        coord.close()
        if cleanup_dir is not None:  # every rank is gone: artifact done
            import shutil

            shutil.rmtree(cleanup_dir, ignore_errors=True)
    wall = time.perf_counter() - t0

    results = []
    for rank in range(spec.num_nodes):
        rep = coord.reports.get(rank)
        exitcode = procs[rank].exitcode if rank < len(procs) else None
        if rep is None:
            now = time.monotonic()
            age = coord.last_msg.get(rank)
            results.append(RankResult(
                rank=rank, status="dead", exitcode=exitcode,
                last_heartbeat_age_s=(
                    round(now - age, 3) if age is not None
                    else pending_ages.get(rank)
                ),
            ))
        else:
            results.append(RankResult(
                rank=rank,
                status="ok",
                digest=str(rep.get("digest")),
                agg=rep.get("agg"),
                steps=int(rep.get("steps", 0)),
                summary=dict(rep.get("summary", {})),
                served_by_source={
                    int(k): int(v)
                    for k, v in dict(rep.get("served_by_source", {})).items()
                },
                peer_served=int(rep.get("peer_served", 0)),
                peer_fallbacks=int(rep.get("peer_fallbacks", 0)),
                stale_refusals=int(rep.get("stale_refusals", 0)),
                resliced_samples=int(rep.get("resliced_samples", 0)),
                adopted_nodes=[
                    int(n) for n in rep.get("adopted_nodes", ())
                ],
                transport=dict(rep.get("transport", {})),
                faults_fired=dict(rep.get("faults_fired", {})),
                rejoined=bool(rep.get("rejoined", False)),
                wall_time_s=float(rep.get("wall_time_s", 0.0)),
                exitcode=exitcode,
                cursors={
                    int(k): int(v)
                    for k, v in dict(rep.get("cursors", {})).items()
                },
                window_steps=int(rep.get("window_steps", 1)),
                max_observed_skew=int(rep.get("max_observed_skew", 0)),
                adoption_boundaries=[
                    int(b) for b in rep.get("adoption_boundaries", ())
                ],
                tenants=dict(rep.get("tenants", {})),
                latency=dict(rep.get("latency", {})),
                latency_hist=dict(rep.get("latency_hist", {})),
                metrics=dict(rep.get("metrics", {})),
            ))
    report = DistributedReport(
        num_ranks=spec.num_nodes, ranks=results,
        plan_digest=plan_digest, wall_time_s=wall,
        recovery=recovery,
        dead_aggs=list(coord.dead_aggs),
        false_suspects=coord.false_suspects,
        peer_suspicions=coord.peer_suspicions,
        rejoins=coord.rejoins,
        resliced_nodes=coord.resliced_nodes,
    )
    if metrics_out:
        # live telemetry time-series (one row per heartbeat snapshot) plus
        # the final aggregated summary — one self-contained JSON artifact.
        with open(metrics_out, "w") as f:
            json.dump(
                {"telemetry": coord.telemetry, "summary": report.summary()},
                f, indent=1, sort_keys=True,
            )
    return report


# ---------------------------------------------------------------------------
# Digest parity references
# ---------------------------------------------------------------------------


def _reference_walk(spec, schedule, store):
    """Yield ``(schedule, executor, close)`` for an in-process reference run."""
    from repro_torch.data.pipeline import execute, plan as plan_fn

    ref_spec = spec.replace(
        transport="shared", collect_data=True, prefetch_depth=0,
        plan_cache=None, plan_path=None,
    )
    if store is not None:
        ref_spec = ref_spec.replace(store=store, path=None)
    if schedule is None:
        schedule = plan_fn(ref_spec)
    executor = execute(ref_spec, schedule)
    own_store = store is None and ref_spec.store is None
    return schedule, executor, own_store


def in_process_digests(spec, schedule=None, *, store=None) -> dict[int, str]:
    """Per-node stream digests of the plan executed in this process.

    Runs the full schedule through one :class:`ScheduleExecutor` with the
    in-process ``SharedViewTransport`` (the semantic reference) and feeds
    each node's rows into its own hasher with exactly the canonical
    encoding a rank-sliced run uses — so ``in_process_digests(spec)[r]``
    must equal rank ``r``'s digest from :func:`run_distributed` bit for
    bit.
    """
    from repro_torch.data.loaders import StepBatch, update_batch_digest

    schedule, executor, own_store = _reference_walk(spec, schedule, store)
    try:
        hashers = {r: hashlib.sha256() for r in range(schedule.num_nodes)}
        for ep, sp in executor.plan_steps():
            sb = executor.execute_step(ep, sp)
            for pos, npn in enumerate(sp.nodes):
                # hash through the one canonical encoding: each node's view
                # is exactly the single-node StepBatch its for_node() slice
                # would produce.
                update_batch_digest(hashers[npn.node], StepBatch(
                    sb.epoch, sb.step,
                    [sb.node_ids[pos]], [sb.node_data[pos]],
                    [sb.hit_masks[pos]],
                ))
        return {r: h.hexdigest() for r, h in hashers.items()}
    finally:
        if own_store:
            executor.store.close()


def in_process_aggregate(spec, schedule=None, *, store=None) -> str:
    """XOR-aggregate digest of the whole plan executed in this process.

    XOR of the sha256 of every (step, node) single-node batch — the
    ownership-independent counterpart of :func:`in_process_digests`:
    re-slicing moves batches *between* ranks but never changes the set, so
    :meth:`DistributedReport.aggregate_digest` must equal this even for
    runs with deaths, adoptions, and rejoins.
    """
    from repro_torch.data.loaders import StepBatch, update_batch_digest

    _schedule, executor, own_store = _reference_walk(spec, schedule, store)
    acc = bytearray(32)
    try:
        for ep, sp in executor.plan_steps():
            sb = executor.execute_step(ep, sp)
            for pos in range(len(sp.nodes)):
                d = hashlib.sha256()
                update_batch_digest(d, StepBatch(
                    sb.epoch, sb.step,
                    [sb.node_ids[pos]], [sb.node_data[pos]],
                    [sb.hit_masks[pos]],
                ))
                _xor_into(acc, d.digest())
        return bytes(acc).hex()
    finally:
        if own_store:
            executor.store.close()
