"""The port's socket runtime (``repro_torch.runtime`` and
``repro_torch.data.peer.SocketTransport``) against the JAX package's.

Mirrors the tests of ``tests/test_runtime.py`` (wire framing, the buffer
server's guards, transport failure modes), ``tests/test_window_protocol.py``
(the windowed ``MSG_FETCHW`` frame and the window-skew guard),
``tests/test_faults.py`` (fault plans, hooks, the breaker and retry
ladder) and ``tests/test_peer.py`` (the address book, an unreachable peer,
spec validation) that need no multi-process launcher, and adds the
cross-package checks: the same inputs give byte-identical frames from both
packages for every message type, and a server of either package serves a
transport of the other with bit-equal rows.

Every socket binds port 0, every client carries a timeout, and every
server is closed in a fixture's teardown or a ``finally``.
"""
import contextlib
import dataclasses
import random
import socket
import threading

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - depends on the environment
    HAVE_HYPOTHESIS = False

import repro.data.loaders as jloaders
import repro.data.peer as jpeer
from repro.runtime import faults as jfaults
from repro.runtime import server as jserver
from repro.runtime import wire as jwire
from repro_torch.core.scheduler import SolarConfig
from repro_torch.data import (
    DatasetSpec,
    LoaderSpec,
    SocketTransport,
    build_pipeline,
    create_store,
    execute,
    plan,
    stream_digest,
)
from repro_torch.data.loaders import _DataMirror
from repro_torch.data.peer import RetryPolicy, _Breaker
from repro_torch.runtime import faults, wire
from repro_torch.runtime.faults import ArmedFaults, Fault, FaultPlan
from repro_torch.runtime.server import BufferServer

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Wire protocol framing
# ---------------------------------------------------------------------------


def _pipe():
    a, b = socket.socketpair()
    a.settimeout(2.0)
    b.settimeout(2.0)
    return a, b


def test_wire_roundtrip_fetch_and_rows():
    a, b = _pipe()
    ids = np.asarray([3, 1, 4, 1, 5], np.int64)
    wire.send_frame(a, wire.MSG_FETCH, wire.pack_fetch(7, ids))
    msg_type, payload = wire.recv_frame(b)
    assert msg_type == wire.MSG_FETCH
    step, got = wire.unpack_fetch(payload)
    assert step == 7 and np.array_equal(got, ids)

    ok = np.asarray([True, False, True, False, True])
    rows = np.arange(12, dtype="<f4").reshape(3, 4)
    wire.send_frame(b, wire.MSG_ROWS, wire.pack_rows(ok, rows))
    msg_type, payload = wire.recv_frame(a)
    ok2, rows2 = wire.unpack_rows(payload, 5, (4,), "<f4")
    assert np.array_equal(ok, ok2) and np.array_equal(rows, rows2)
    a.close(), b.close()


def test_wire_truncated_frame_detected():
    a, b = _pipe()
    header = wire._HEADER.pack(wire.MAGIC, wire.WIRE_VERSION, wire.MSG_CTRL, 100)
    a.sendall(header + b"x" * 10)  # promises 100 payload bytes, sends 10
    a.close()
    with pytest.raises(wire.TruncatedFrame):
        wire.recv_frame(b)
    b.close()


def test_wire_clean_eof_vs_truncation():
    a, b = _pipe()
    a.close()  # no bytes at all: clean close at a frame boundary
    assert wire.recv_frame(b, eof_ok=True) is None
    b.close()
    a, b = _pipe()
    a.close()
    with pytest.raises(wire.TruncatedFrame):  # without eof_ok it is an error
        wire.recv_frame(b)
    b.close()


def test_wire_checksum_mismatch_detected():
    a, b = _pipe()
    payload = wire.pack_json({"kind": "x"})
    header = wire._HEADER.pack(
        wire.MAGIC, wire.WIRE_VERSION, wire.MSG_CTRL, len(payload)
    )
    good = header + payload + wire._frame_digest(header, payload)
    corrupt = bytearray(good)
    corrupt[len(header) + 2] ^= 0xFF  # flip one payload bit
    a.sendall(bytes(corrupt))
    with pytest.raises(wire.ChecksumMismatch):
        wire.recv_frame(b)
    a.close(), b.close()


def test_wire_protocol_errors():
    a, b = _pipe()
    a.sendall(b"NOPE" + bytes(wire._HEADER.size - 4 + 32))
    with pytest.raises(wire.ProtocolError, match="magic"):
        wire.recv_frame(b)
    a.close(), b.close()
    a, b = _pipe()
    header = wire._HEADER.pack(wire.MAGIC, 99, wire.MSG_CTRL, 0)
    a.sendall(header + wire._frame_digest(header, b""))
    with pytest.raises(wire.ProtocolError, match="version"):
        wire.recv_frame(b)
    a.close(), b.close()


def test_wire_rows_payload_length_is_validated():
    ok = np.asarray([True, True, False])
    rows = np.zeros((2, 4), "<f4")
    payload = wire.pack_rows(ok, rows)
    with pytest.raises(wire.ProtocolError):  # geometry says 8-float rows
        wire.unpack_rows(payload, 3, (8,), "<f4")


# ---------------------------------------------------------------------------
# Wire: MSG_FETCHW framing + legacy coexistence
# ---------------------------------------------------------------------------


def test_fetchw_roundtrip():
    a, b = _pipe()
    try:
        ids = np.asarray([3, 1, 4, 1, 5], np.int64)
        wire.send_frame(a, wire.MSG_FETCHW, wire.pack_fetchw(2, 11, ids))
        msg_type, payload = wire.recv_frame(b)
        assert msg_type == wire.MSG_FETCHW
        window, step, got = wire.unpack_fetchw(payload)
        assert (window, step) == (2, 11)
        assert np.array_equal(got, ids)
    finally:
        a.close()
        b.close()


def test_fetchw_is_a_distinct_message_type():
    assert wire.MSG_FETCHW != wire.MSG_FETCH
    assert wire.MSG_FETCHW in wire._KNOWN_TYPES
    assert wire.MSG_FETCH in wire._KNOWN_TYPES


def test_fetchw_payload_validation():
    with pytest.raises(wire.ProtocolError, match="FETCHW"):
        wire.unpack_fetchw(b"\x00" * 8)  # shorter than the fixed header
    good = wire.pack_fetchw(0, 3, np.asarray([7, 8], np.int64))
    with pytest.raises(wire.ProtocolError, match="FETCHW"):
        wire.unpack_fetchw(good[:-4])  # id vector cut short
    window, step, ids = wire.unpack_fetchw(good)
    assert (window, step, ids.tolist()) == (0, 3, [7, 8])


def test_legacy_fetch_frames_are_unchanged():
    ids = np.asarray([9, 2], np.int64)
    payload = wire.pack_fetch(4, ids)
    assert payload == wire._FETCH.pack(4, 2) + ids.astype("<i8").tobytes()
    step, got = wire.unpack_fetch(payload)
    assert step == 4 and np.array_equal(got, ids)
    assert wire.WIRE_VERSION == 1


# ---------------------------------------------------------------------------
# Cross-package: byte-identical frames for every message type
# ---------------------------------------------------------------------------


def _payload(w, msg_type: int, seed: int) -> bytes:
    """One payload of ``msg_type`` built with wire module ``w`` from inputs
    drawn by a numpy generator seeded ``seed``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2**40, size=int(rng.integers(0, 24)))
    shape = [int(x) for x in rng.integers(1, 9, size=2)]
    if msg_type in (w.MSG_HELLO, w.MSG_HELLO_OK):
        return w.pack_json({"node": int(rng.integers(8)), "shape": shape,
                            "dtype": "<f4"})
    if msg_type in (w.MSG_ATTACH, w.MSG_ATTACH_OK):
        return w.pack_json({"tenant": int(rng.integers(-1, 9)),
                            "token": f"t{int(rng.integers(1000))}",
                            "shape": shape, "dtype": "<f2"})
    if msg_type == w.MSG_CTRL:
        return w.pack_json({"kind": "barrier", "step": int(rng.integers(100)),
                            "x": float(rng.standard_normal())})
    if msg_type == w.MSG_ERROR:
        return f"geometry mismatch {int(rng.integers(1000))}".encode()
    if msg_type == w.MSG_FETCH:
        return w.pack_fetch(int(rng.integers(-1, 1000)), ids)
    if msg_type == w.MSG_FETCHW:
        return w.pack_fetchw(int(rng.integers(100)), int(rng.integers(1000)), ids)
    if msg_type == w.MSG_READ:
        return w.pack_read(int(rng.integers(-1, 9)), ids,
                           forward=bool(rng.integers(2)))
    if msg_type == w.MSG_SHED:
        return w.pack_shed(float(rng.exponential()), "rate_limited")
    assert msg_type == w.MSG_ROWS
    ok = rng.random(ids.size) < 0.6
    rows = rng.standard_normal((int(ok.sum()), *shape)).astype("<f4")
    return w.pack_rows(ok, rows)


def _framed(w, msg_type: int, payload: bytes) -> bytes:
    """The bytes ``w.send_frame`` puts on a socket."""
    a, b = _pipe()
    try:
        w.send_frame(a, msg_type, payload)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            part = b.recv(1 << 16)
            if not part:
                return b"".join(chunks)
            chunks.append(part)
    finally:
        a.close()
        b.close()


_MSG_NAMES = ["MSG_HELLO", "MSG_HELLO_OK", "MSG_FETCH", "MSG_ROWS", "MSG_ERROR",
              "MSG_CTRL", "MSG_FETCHW", "MSG_ATTACH", "MSG_ATTACH_OK", "MSG_READ",
              "MSG_SHED"]


def test_message_type_numbers_and_constants_match():
    for name in _MSG_NAMES:
        assert getattr(wire, name) == getattr(jwire, name)
    assert wire._KNOWN_TYPES == jwire._KNOWN_TYPES
    assert (wire.MAGIC, wire.WIRE_VERSION, wire.MAX_FRAME_PAYLOAD,
            wire.MAX_RETRY_AFTER_S) == (jwire.MAGIC, jwire.WIRE_VERSION,
                                        jwire.MAX_FRAME_PAYLOAD,
                                        jwire.MAX_RETRY_AFTER_S)
    assert wire._HEADER.format == jwire._HEADER.format


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", _MSG_NAMES)
def test_frames_are_byte_identical_to_the_jax_package(name, seed):
    msg_type = getattr(wire, name)
    payload = _payload(wire, msg_type, seed)
    assert payload == _payload(jwire, msg_type, seed)
    frame = _framed(wire, msg_type, payload)
    assert frame == _framed(jwire, msg_type, payload)
    # and each package decodes the other's frame
    a, b = _pipe()
    try:
        a.sendall(frame)
        assert jwire.recv_frame(b) == (msg_type, payload)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# BufferServer + SocketTransport against a live mirror
# ---------------------------------------------------------------------------


class _Arena:
    """Minimal stand-in for _DataMirror: samples value == id."""

    def __init__(self, ids, width=4):
        self.ids = np.asarray(ids, np.int64)
        self.width = width

    def lookup(self, want):
        want = np.asarray(want, np.int64)
        return np.where(np.isin(want, self.ids), want, -1)

    def rows(self, slots):
        return np.repeat(
            slots.astype("<f4")[:, None], self.width, axis=1
        )


@pytest.fixture()
def served_arena():
    arena = _Arena([5, 6, 7, 20])
    server = BufferServer(0, (4,), "<f4", port=0).start()
    server.attach(lambda n: arena)
    transport = SocketTransport(
        {0: (server.host, server.port)}, timeout_s=2.0,
        sample_shape=(4,), dtype="<f4",
    )
    yield arena, server, transport
    transport.close()
    server.close()


def test_buffer_server_serves_resident_rows(served_arena):
    _arena, server, transport = served_arena
    server.at_step(3)
    transport.at_step(3)
    rows, ok = transport.fetch(0, np.asarray([5, 9, 20]))
    assert ok.tolist() == [True, False, True]
    assert np.array_equal(rows[:, 0].astype(np.int64), [5, 20])
    assert server.stale_refusals == 0


def test_buffer_server_step_guard_refuses_stale_fetches(served_arena):
    _arena, server, transport = served_arena
    server.at_step(4)
    transport.at_step(3)  # requester believes it is step 3: too late
    rows, ok = transport.fetch(0, np.asarray([5, 6]))
    assert not ok.any() and rows.shape == (0, 4)
    assert server.stale_refusals == 1
    server.at_step(5)
    transport.at_step(5)
    with server.mutating():
        pass  # exiting leaves the guard paused until the next at_step
    rows, ok = transport.fetch(0, np.asarray([5]))
    assert not ok.any()
    server.at_step(6)
    transport.at_step(6)
    _, ok = transport.fetch(0, np.asarray([5]))
    assert ok.all()


def test_buffer_server_refuses_fetch_before_hello(served_arena):
    _arena, server, _ = served_arena
    server.at_step(0)
    conn = socket.create_connection((server.host, server.port), timeout=2.0)
    conn.settimeout(2.0)
    try:
        wire.send_frame(conn, wire.MSG_FETCH, wire.pack_fetch(0, np.asarray([5])))
        msg_type, payload = wire.recv_frame(conn)
        assert msg_type == wire.MSG_ERROR
        assert b"HELLO" in payload
    finally:
        conn.close()


def test_buffer_server_refuses_mismatched_geometry(served_arena):
    _arena, server, _ = served_arena
    bad = SocketTransport(
        {0: (server.host, server.port)}, timeout_s=2.0,
        sample_shape=(16,), dtype="<f8",
    )
    try:
        with pytest.raises(wire.HandshakeError, match="geometry mismatch"):
            bad.fetch(0, np.asarray([5]))
    finally:
        bad.close()


def test_transport_survives_peer_dying_mid_step(served_arena):
    _arena, server, transport = served_arena
    server.at_step(1)
    transport.at_step(1)
    _, ok = transport.fetch(0, np.asarray([5]))
    assert ok.all()
    server.close()  # the peer dies with a connection pooled
    rows, ok = transport.fetch(0, np.asarray([6]))
    assert not ok.any() and rows.shape == (0, 4)
    rows, ok = transport.fetch(0, np.asarray([7]))  # stays down: still clean
    assert not ok.any()


def _misbehaving_server(respond):
    """One-shot TCP server: HELLO is answered correctly, then ``respond``
    gets the raw connection to abuse after the first FETCH arrives."""
    listener = socket.create_server(("127.0.0.1", 0))
    listener.settimeout(5.0)

    def serve():
        conn, _ = listener.accept()
        with conn:
            conn.settimeout(5.0)
            _t, payload = wire.recv_frame(conn)
            wire.send_frame(conn, wire.MSG_HELLO_OK, payload)  # echo geometry
            wire.recv_frame(conn)  # the FETCH
            respond(conn)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return listener, t


def test_transport_truncated_response_falls_back():
    def respond(conn):
        header = wire._HEADER.pack(
            wire.MAGIC, wire.WIRE_VERSION, wire.MSG_ROWS, 1000
        )
        conn.sendall(header + b"q" * 8)  # then hang up mid-frame

    listener, t = _misbehaving_server(respond)
    transport = SocketTransport(
        {0: ("127.0.0.1", listener.getsockname()[1])}, timeout_s=2.0,
        sample_shape=(4,), dtype="<f4",
    )
    try:
        rows, ok = transport.fetch(0, np.asarray([1, 2]))
        assert not ok.any() and rows.shape == (0, 4)
    finally:
        t.join(timeout=5.0)
        listener.close()
        transport.close()


def test_transport_checksum_mismatch_falls_back():
    def respond(conn):
        ok = np.asarray([True, True])
        rows = np.zeros((2, 4), "<f4")
        payload = wire.pack_rows(ok, rows)
        header = wire._HEADER.pack(
            wire.MAGIC, wire.WIRE_VERSION, wire.MSG_ROWS, len(payload)
        )
        digest = bytearray(wire._frame_digest(header, payload))
        digest[0] ^= 0xFF  # corrupt the checksum
        conn.sendall(header + payload + bytes(digest))

    listener, t = _misbehaving_server(respond)
    transport = SocketTransport(
        {0: ("127.0.0.1", listener.getsockname()[1])}, timeout_s=2.0,
        sample_shape=(4,), dtype="<f4",
    )
    try:
        rows, ok = transport.fetch(0, np.asarray([1, 2]))
        assert not ok.any(), "corrupt rows must never enter a batch"
    finally:
        t.join(timeout=5.0)
        listener.close()
        transport.close()


def test_transport_self_source_serves_from_local_mirror():
    arena = _Arena([11, 12])
    transport = SocketTransport(
        {}, self_node=3, mirror_of=lambda n: arena,
        sample_shape=(4,), dtype="<f4",
    )
    rows, ok = transport.fetch(3, np.asarray([11, 99]))
    assert ok.tolist() == [True, False]
    assert np.array_equal(rows[:, 0].astype(np.int64), [11])
    transport.close()


# ---------------------------------------------------------------------------
# Cross-package: a server of either package serves a transport of the other
# ---------------------------------------------------------------------------

_PKGS = {
    "torch": (BufferServer, SocketTransport, _DataMirror),
    "jax": (jserver.BufferServer, jpeer.SocketTransport, jloaders._DataMirror),
}


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("server_pkg,client_pkg", [("jax", "torch"), ("torch", "jax")])
def test_servers_and_transports_interoperate(server_pkg, client_pkg, windowed):
    """Rows served across the package boundary are bit-equal to the store's,
    through the exact-step FETCH and the windowed FETCHW (a requester one
    step behind, served from the eviction history)."""
    Server, _, Mirror = _PKGS[server_pkg]
    _, Transport, _ = _PKGS[client_pkg]
    rng = np.random.default_rng(11)
    data = rng.standard_normal((64, 3, 5)).astype("<f4")
    mirror = Mirror(32, (3, 5), np.dtype("<f4"))
    resident = np.sort(rng.choice(64, size=24, replace=False))
    mirror.admit(resident, data[resident])
    server = Server(0, (3, 5), "<f4", port=0, skew_window=2 if windowed else 0).start()
    server.attach(lambda node: mirror)
    transport = Transport({0: (server.host, server.port)}, timeout_s=2.0,
                          sample_shape=(3, 5), dtype="<f4")
    try:
        server.at_step(0)
        want = np.concatenate([resident[:10], [resident[0], 63 + 100]])
        if windowed:
            gone = resident[:4]
            with server.mutating(0):
                mirror.evict(gone)  # the requester at step 0 still sees them
            transport.at_step(0, window=0)
        else:
            transport.at_step(0)
        rows, ok = transport.fetch(0, want)
        assert ok.tolist() == [True] * 11 + [False]
        assert rows.tobytes() == data[want[ok]].tobytes()
    finally:
        transport.close()
        server.close()


# ---------------------------------------------------------------------------
# Window-skew guard: property tests over a live server + real mirror
# ---------------------------------------------------------------------------

_SHAPE = (4,)
_ABSENT_BASE = 10_000  # ids from here up are never admitted anywhere


def _row(sample_id: int) -> np.ndarray:
    return np.full(_SHAPE, float(sample_id), "<f4")


def _rows(ids) -> np.ndarray:
    return np.stack([_row(int(s)) for s in ids])


class _WindowHarness:
    """One serving rank's mirror + server + a windowed client transport."""

    def __init__(self, skew_window: int, skew_wait_s: float = 0.5):
        self.mirror = _DataMirror(256, _SHAPE, np.dtype("<f4"))
        self.server = BufferServer(
            0, _SHAPE, "<f4", port=0,
            skew_window=skew_window, skew_wait_s=skew_wait_s,
        ).start()
        self.server.attach(lambda node: self.mirror)
        self.transport = SocketTransport(
            {0: (self.server.host, self.server.port)}, timeout_s=2.0,
            sample_shape=_SHAPE, dtype="<f4",
            retry=RetryPolicy(max_attempts=1, backoff_base_s=0.001),
        )

    def close(self):
        self.transport.close()
        self.server.close()

    def fetch_at(self, step: int, window: int, ids):
        self.transport.at_step(step, window=window)
        return self.transport.fetch(0, np.asarray(ids, np.int64))


def _check_window_guard(seed: int) -> None:
    rng = np.random.default_rng(seed)
    w = int(rng.integers(1, 5))
    steps = int(rng.integers(w + 1, w + 5))
    h = _WindowHarness(skew_window=w)
    try:
        universe = np.arange(128, dtype=np.int64)
        resident = set(
            int(s) for s in rng.choice(universe, size=48, replace=False)
        )
        h.mirror.admit(sorted(resident), _rows(sorted(resident)))
        h.server.at_step(0)
        start_of_step = {0: set(resident)}
        for s in range(steps):
            with h.server.mutating(s):
                gone = [
                    int(x) for x in rng.choice(
                        sorted(resident),
                        size=int(rng.integers(1, 6)), replace=False,
                    )
                ]
                h.mirror.evict(gone)
                resident.difference_update(gone)
                fresh = [
                    int(x) for x in universe
                    if x not in resident
                ][: int(rng.integers(0, 5))]
                if fresh:
                    h.mirror.admit(sorted(fresh), _rows(sorted(fresh)))
                    resident.update(fresh)
            start_of_step[s + 1] = set(resident)

        for lag in range(0, w + 1):
            r = steps - lag
            want = sorted(start_of_step[r])[:12] + [
                _ABSENT_BASE + int(rng.integers(64))
            ]
            rows, ok = h.fetch_at(r, r // w, want)
            assert ok[:-1].all(), f"seed {seed}: lag {lag} lost resident ids"
            assert not ok[-1], "a never-resident id must not be served"
            served = np.asarray(want)[ok]
            assert np.array_equal(rows, _rows(served)), (
                f"seed {seed}: wrong bytes at lag {lag}"
            )

        before = h.server.stale_refusals
        if steps - w - 1 >= 0:
            r = steps - w - 1
            rows, ok = h.fetch_at(r, r // w, sorted(start_of_step[r])[:4])
            assert not ok.any() and rows.shape[0] == 0
            assert h.server.stale_refusals == before + 1

        before = h.server.stale_refusals
        r = steps
        rows, ok = h.fetch_at(r, r // w + 1, sorted(start_of_step[r])[:4])
        assert not ok.any()
        assert h.server.stale_refusals == before + 1
    finally:
        h.close()


if HAVE_HYPOTHESIS:

    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2**31 - 1))
    def test_window_skew_guard_property(seed):
        _check_window_guard(seed)

else:

    @pytest.mark.parametrize("seed", range(8))
    def test_window_skew_guard_property(seed):
        _check_window_guard(seed)


def test_requester_ahead_waits_for_the_executor_bounded():
    h = _WindowHarness(skew_window=2, skew_wait_s=0.4)
    try:
        h.mirror.admit([1, 2, 3], _rows([1, 2, 3]))
        h.server.at_step(0)
        with h.server.mutating(0):
            pass
        t = threading.Timer(0.1, lambda: h.server.at_step(2))
        t.start()
        try:
            rows, ok = h.fetch_at(2, 1, [1, 3])
        finally:
            t.join()
        assert ok.all(), "catch-up within the wait budget must serve"
        assert np.array_equal(rows, _rows([1, 3]))

        before = h.server.stale_refusals
        rows, ok = h.fetch_at(4, 2, [1])
        assert not ok.any()
        assert h.server.stale_refusals == before + 1
    finally:
        h.close()


def test_stale_refusals_never_charge_the_breaker():
    escalated = []
    h = _WindowHarness(skew_window=1, skew_wait_s=0.05)
    h.transport._escalate = escalated.append
    try:
        h.mirror.admit([5, 6], _rows([5, 6]))
        h.server.at_step(0)
        with h.server.mutating(0):
            pass
        for _ in range(4):
            rows, ok = h.fetch_at(8, 8, [5])
            assert not ok.any()
        h.server.drop(0)
        h.transport.close()  # force a re-dial into the refusing server
        for _ in range(3):
            rows, ok = h.fetch_at(1, 1, [5])
            assert not ok.any()
        stats = h.transport.stats()
        assert stats["stale_refusal_fallbacks"] == 3
        assert stats["breaker_opens"] == 0
        assert stats["breaker_skips"] == 0
        assert stats["escalations"] == 0 and escalated == []
        assert h.server.stale_refusals >= 4
    finally:
        h.close()


def test_mirror_evict_sink_captures_evictions_only_when_bound():
    """With ``evict_sink`` None the mirror behaves as before; bound, it
    records each eviction's ids and rows (the window-skew history)."""
    m = _DataMirror(8, _SHAPE, np.dtype("<f4"))
    m.admit([1, 2, 3], _rows([1, 2, 3]))
    m.evict([2])
    assert m.evict_sink is None
    m.evict_sink = sink = []
    m.evict([1, 9])
    m.evict([])
    m.evict_sink = None
    m.evict([3])
    assert len(sink) == 1
    assert sink[0][0].tolist() == [1] and np.array_equal(sink[0][1], _rows([1]))
    assert m.ids.size == 0


# ---------------------------------------------------------------------------
# Wire framing under corruption: the property the checksums buy
# ---------------------------------------------------------------------------


def _valid_frame() -> bytes:
    ids = np.arange(17, dtype=np.int64)
    payload = wire.pack_fetch(5, ids)
    header = wire._HEADER.pack(
        wire.MAGIC, wire.WIRE_VERSION, wire.MSG_FETCH, len(payload)
    )
    return header + payload + wire._frame_digest(header, payload)


_FRAME = _valid_frame()


def _recv_damaged(frame_bytes: bytes):
    a, b = socket.socketpair()
    try:
        a.settimeout(2.0)
        b.settimeout(2.0)
        a.sendall(frame_bytes)
        a.shutdown(socket.SHUT_WR)
        return wire.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_valid_frame_roundtrips():
    msg_type, payload = _recv_damaged(_FRAME)
    assert msg_type == wire.MSG_FETCH
    step, ids = wire.unpack_fetch(payload)
    assert step == 5 and ids.size == 17


def _check_bit_flip(offset: int, bit: int) -> None:
    damaged = bytearray(_FRAME)
    damaged[offset] ^= 1 << bit
    try:
        got = _recv_damaged(bytes(damaged))
    except wire.WireError:
        return
    pytest.fail(f"bit {bit} at offset {offset} flipped undetected: got {got!r}")


def _check_truncation(cut: int) -> None:
    with pytest.raises(wire.WireError):
        _recv_damaged(_FRAME[:cut])


def _check_splice(offset: int, junk: bytes) -> None:
    damaged = _FRAME[:offset] + junk + _FRAME[offset + len(junk):]
    if damaged == _FRAME:
        return
    with pytest.raises(wire.WireError):
        _recv_damaged(damaged)


if HAVE_HYPOTHESIS:

    @settings(max_examples=60, deadline=None)
    @given(
        offset=st.integers(min_value=0, max_value=len(_FRAME) - 1),
        bit=st.integers(min_value=0, max_value=7),
    )
    def test_any_bit_flip_is_detected(offset, bit):
        _check_bit_flip(offset, bit)

    @settings(max_examples=60, deadline=None)
    @given(cut=st.integers(min_value=0, max_value=len(_FRAME) - 1))
    def test_any_truncation_is_detected(cut):
        _check_truncation(cut)

    @settings(max_examples=30, deadline=None)
    @given(
        offset=st.integers(min_value=0, max_value=len(_FRAME) - 1),
        junk=st.binary(min_size=1, max_size=8),
    )
    def test_random_splices_are_detected(offset, junk):
        _check_splice(offset, junk)

else:
    _rng = np.random.default_rng(0)
    _FLIPS = sorted(
        (int(off), int(_rng.integers(8)))
        for off in _rng.choice(len(_FRAME), size=48, replace=False)
    )
    _SPLICES = [
        (int(_rng.integers(len(_FRAME))),
         bytes(_rng.integers(0, 256, 4, dtype=np.uint8)))
        for _ in range(16)
    ]

    @pytest.mark.parametrize("offset,bit", _FLIPS)
    def test_any_bit_flip_is_detected(offset, bit):
        _check_bit_flip(offset, bit)

    @pytest.mark.parametrize("cut", range(len(_FRAME)))
    def test_any_truncation_is_detected(cut):
        _check_truncation(cut)

    @pytest.mark.parametrize("offset,junk", _SPLICES)
    def test_random_splices_are_detected(offset, junk):
        _check_splice(offset, junk)


# ---------------------------------------------------------------------------
# FaultPlan: deterministic compilation, rank slicing, parsing
# ---------------------------------------------------------------------------


def test_fault_plan_is_deterministic():
    a = FaultPlan.compile(42, 4, crashes=1, corrupt=3, resets=2, slow=1)
    b = FaultPlan.compile(42, 4, crashes=1, corrupt=3, resets=2, slow=1)
    assert a == b
    c = FaultPlan.compile(43, 4, crashes=1, corrupt=3, resets=2, slow=1)
    assert a != c


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_fault_plans_match_the_jax_package(seed):
    """The same seed places the same chaos in both packages."""
    kw = dict(num_steps=12, crashes=1, corrupt=3, truncate=2, resets=2, slow=1,
              hb_loss=1, spare_rank=0)
    got = FaultPlan.compile(seed, 4, **kw)
    want = jfaults.FaultPlan.compile(seed, 4, **kw)
    assert [dataclasses.asdict(f) for f in got.faults] == \
        [dataclasses.asdict(f) for f in want.faults]
    text = f"ranks=3,seed={seed},crash=1,corrupt=2,slow=1,reset=1"
    assert FaultPlan.parse(text).summary() == jfaults.FaultPlan.parse(text).summary()


def test_fault_plan_rank_slices_partition_the_plan():
    plan = FaultPlan.compile(7, 4, crashes=2, corrupt=4, truncate=2, slow=3)
    sliced = [plan.for_rank(r) for r in range(4)]
    assert sum(len(s) for s in sliced) == len(plan.faults)
    for r, s in enumerate(sliced):
        assert all(f.rank == r for f in s)


def test_fault_plan_spare_rank_never_crashes():
    for seed in range(10):
        plan = FaultPlan.compile(seed, 3, crashes=2, spare_rank=0)
        assert all(
            f.rank != 0 for f in plan.faults if f.kind in ("crash", "hb_loss")
        )


def test_fault_plan_parse_cli_form():
    plan = FaultPlan.parse("ranks=4,seed=9,crash=1,corrupt=2,slow=1")
    assert plan == FaultPlan.compile(9, 4, crashes=1, corrupt=2, slow=1)
    with pytest.raises(ValueError, match="ranks=N"):
        FaultPlan.parse("seed=9,crash=1")
    with pytest.raises(ValueError, match="unknown"):
        FaultPlan.parse("ranks=2,frobnicate=1")
    with pytest.raises(ValueError, match="key=value"):
        FaultPlan.parse("ranks=2,crash")


def test_fault_validation_rejects_malformed_faults():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("melt", 0)
    with pytest.raises(ValueError, match="send site"):
        Fault("corrupt", 0, site="nonsense", nth=1)
    with pytest.raises(ValueError, match="needs a step"):
        Fault("crash", 0)
    with pytest.raises(ValueError, match="nth"):
        Fault("reset", 0, nth=0)


def test_armed_faults_fire_on_exact_passage():
    armed = ArmedFaults(
        (
            Fault("corrupt", 0, site="server.rows", nth=2),
            Fault("reset", 0, nth=1),
            Fault("slow", 0, nth=3, delay_s=0.25),
        ),
        rank=0,
    )
    assert armed.on_send("server.rows") is None
    assert armed.on_send("server.rows") == "corrupt"
    assert armed.on_send("server.rows") is None
    assert armed.on_dial() is True
    assert armed.on_dial() is False
    assert armed.on_serve() == 0.0
    assert armed.on_serve() == 0.0
    assert armed.on_serve() == 0.25
    assert armed.summary() == {
        "corrupt:server.rows": 1, "reset:None": 1, "slow:None": 1,
    }


def test_module_hooks_are_noops_when_disarmed():
    faults.disarm()
    assert faults.on_send("server.rows") is None
    assert faults.on_dial() is False
    assert faults.on_serve() == 0.0
    assert faults.active() is None
    try:
        armed = faults.arm(FaultPlan(faults=(Fault("reset", 0, nth=1),)), 0)
        assert faults.active() is armed
        assert faults.on_dial() is True
    finally:
        faults.disarm()


@pytest.mark.parametrize("armed_pkg", ["torch", "jax"])
def test_arming_one_package_leaves_the_other_disarmed(armed_pkg):
    mods = {"torch": faults, "jax": jfaults}
    arm, other = mods[armed_pkg], mods["jax" if armed_pkg == "torch" else "torch"]
    plan = arm.FaultPlan(faults=(arm.Fault("reset", 0, nth=1),
                                 arm.Fault("slow", 0, nth=1, delay_s=0.5)))
    try:
        arm.arm(plan, 0)
        assert other.active() is None
        assert other.on_dial() is False and other.on_serve() == 0.0
        assert arm.on_dial() is True
    finally:
        arm.disarm()
    assert arm.active() is None and other.active() is None


def test_armed_send_fault_damages_the_frame():
    """An armed ``corrupt`` fault at a named site flips a bit the receiver
    catches; ``truncate`` writes half a frame and raises on the sender."""
    plan = FaultPlan(faults=(Fault("corrupt", 0, site="server.rows", nth=1),
                             Fault("truncate", 0, site="server.rows", nth=2)))
    payload = wire.pack_rows(np.ones(2, bool), np.zeros((2, 4), "<f4"))
    try:
        faults.arm(plan, 0)
        a, b = _pipe()
        try:
            wire.send_frame(a, wire.MSG_ROWS, payload, site="server.rows")
            with pytest.raises(wire.ChecksumMismatch):
                wire.recv_frame(b)
            with pytest.raises(faults.InjectedTruncation):
                wire.send_frame(a, wire.MSG_ROWS, payload, site="server.rows")
            a.close()
            with pytest.raises(wire.TruncatedFrame):
                wire.recv_frame(b)
        finally:
            a.close()
            b.close()
        assert faults.active().summary() == {
            "corrupt:server.rows": 1, "truncate:server.rows": 1}
    finally:
        faults.disarm()


# ---------------------------------------------------------------------------
# Circuit breaker: the state machine with an injected clock
# ---------------------------------------------------------------------------


def _policy(**kw) -> RetryPolicy:
    defaults = dict(
        max_attempts=1, breaker_threshold=2, breaker_cooldown_s=10.0,
        escalate_after=2,
    )
    defaults.update(kw)
    return RetryPolicy(**defaults)


def test_breaker_opens_after_threshold_consecutive_failures():
    br = _Breaker(_policy())
    assert br.allow(0.0)
    assert br.failure(0.0) is False
    assert br.state == "closed"
    assert br.failure(1.0) is True
    assert br.state == "open"
    assert br.opens_in_row == 1
    assert not br.allow(5.0), "open breaker must short-circuit"


def test_breaker_half_open_probe_then_close():
    br = _Breaker(_policy())
    br.failure(0.0)
    br.failure(0.0)
    assert br.state == "open"
    assert br.allow(10.0), "cooldown elapsed: admit one probe"
    assert br.state == "half_open"
    br.success()
    assert br.state == "closed"
    assert br.opens_in_row == 0
    assert br.allow(10.0)


def test_breaker_half_open_failure_reopens_immediately():
    br = _Breaker(_policy())
    br.failure(0.0)
    br.failure(0.0)
    assert br.allow(10.0)
    assert br.failure(10.0) is True, "half-open failure re-opens at once"
    assert br.opens_in_row == 2
    assert not br.allow(10.1)


def test_breaker_success_resets_failure_streak():
    br = _Breaker(_policy(breaker_threshold=3))
    br.failure(0.0)
    br.failure(0.0)
    br.success()
    assert br.failure(0.0) is False, "streak must restart after a success"
    assert br.state == "closed"


def test_breaker_follows_the_jax_breaker_on_a_seeded_event_walk():
    """The same (allow, failure, success) sequence on the same clock gives
    the same states and transitions in both packages."""
    rng = np.random.default_rng(5)
    pol = dict(breaker_threshold=3, breaker_cooldown_s=0.5)
    br, jbr = _Breaker(RetryPolicy(**pol)), jpeer._Breaker(jpeer.RetryPolicy(**pol))
    now = 0.0
    for _ in range(300):
        now += float(rng.exponential(0.1))
        op = int(rng.integers(3))
        if op == 0:
            assert br.allow(now) == jbr.allow(now)
        elif op == 1:
            assert br.failure(now) == jbr.failure(now)
        else:
            br.success()
            jbr.success()
        assert (br.state, br.failures, br.opens_in_row) == \
            (jbr.state, jbr.failures, jbr.opens_in_row)


def test_retry_policy_backoff_grows_and_caps():
    pol = RetryPolicy(backoff_base_s=0.01, backoff_max_s=0.04, jitter=0.0)
    rng = random.Random(0)
    waits = [pol.backoff_s(i, rng) for i in range(5)]
    assert waits[0] == pytest.approx(0.01)
    assert waits[1] == pytest.approx(0.02)
    assert waits == sorted(waits)
    assert max(waits) == pytest.approx(0.04), "backoff must cap"
    # seeded jitter: the same ladder as the JAX package's, to the bit
    jit, jjit = RetryPolicy(seed=3), jpeer.RetryPolicy(seed=3)
    r1, r2 = random.Random(9), random.Random(9)
    assert [jit.backoff_s(i, r1) for i in range(6)] == \
        [jjit.backoff_s(i, r2) for i in range(6)]


def test_retry_policy_validates():
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="breaker_threshold"):
        RetryPolicy(breaker_threshold=0)


# ---------------------------------------------------------------------------
# Transport counters: retries, breaker trips, unknown-source fallbacks
# ---------------------------------------------------------------------------


def _dead_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def test_transport_counts_retries_and_breaker_opens():
    escalated = []
    transport = SocketTransport(
        {0: ("127.0.0.1", _dead_port())}, timeout_s=0.5,
        sample_shape=(4,), dtype="<f4",
        retry=RetryPolicy(
            max_attempts=2, backoff_base_s=0.001, backoff_max_s=0.002,
            breaker_threshold=2, breaker_cooldown_s=60.0, escalate_after=1,
        ),
        escalate=escalated.append,
    )
    try:
        for _ in range(3):
            rows, ok = transport.fetch(0, np.asarray([1, 2]))
            assert not ok.any()
        stats = transport.stats()
        assert stats["retries"] >= 2
        assert stats["breaker_opens"] >= 1
        assert stats["breaker_skips"] >= 1
        assert stats["escalations"] >= 1 and escalated == [0] * stats[
            "escalations"
        ]
    finally:
        transport.close()


def test_transport_unknown_source_has_its_own_counter():
    transport = SocketTransport({}, sample_shape=(4,), dtype="<f4")
    try:
        rows, ok = transport.fetch(99, np.asarray([1, 2, 3]))
        assert not ok.any() and rows.shape == (0, 4)
        assert transport.stats()["unknown_source_fallbacks"] == 1
        assert transport.stats()["retries"] == 0
    finally:
        transport.close()


def test_transport_retry_recovers_from_one_reset():
    arena = _Arena([5, 6, 7])
    server = BufferServer(0, (4,), "<f4").start()
    server.attach(lambda node: arena)
    server.at_step(3)
    faults.arm(FaultPlan(faults=(Fault("reset", 1, nth=1),)), rank=1)
    transport = SocketTransport(
        {0: (server.host, server.port)}, self_node=1, timeout_s=2.0,
        sample_shape=(4,), dtype="<f4",
        retry=RetryPolicy(max_attempts=3, backoff_base_s=0.001),
    )
    try:
        transport.at_step(3)
        rows, ok = transport.fetch(0, np.asarray([5, 7]))
        assert ok.all(), "retry must mask a single dial reset"
        assert np.array_equal(rows[:, 0].astype(np.int64), [5, 7])
        stats = transport.stats()
        assert stats["retries"] == 1
        assert stats["breaker_opens"] == 0
    finally:
        faults.disarm()
        transport.close()
        server.close()


# ---------------------------------------------------------------------------
# Address book + spec validation
# ---------------------------------------------------------------------------


def test_socket_transport_address_book_validation():
    from repro_torch.data import AddressBookError

    t = SocketTransport({0: ("nodeA", 9000), 1: ("nodeB", 9000)})
    assert t.endpoints[0] == ("nodeA", 9000)
    with pytest.raises(ValueError, match="sample_shape and dtype"):
        t.fetch(0, np.asarray([1, 2]))
    with pytest.raises(AddressBookError, match="duplicate endpoint"):
        SocketTransport({0: ("nodeA", 9000), 1: ("nodeA", 9000)})
    with pytest.raises(AddressBookError, match="self-endpoint"):
        SocketTransport({0: ("nodeA", 9000), 1: ("nodeB", 9000)}, self_node=1)
    with pytest.raises(AddressBookError, match="out of range"):
        SocketTransport({0: ("nodeA", 0)})
    with pytest.raises(AddressBookError, match="duplicate.*self-endpoint"):
        SocketTransport({0: ("n", 9000), 1: ("n", 9000), 2: ("m", 9001)}, self_node=2)


def test_socket_transport_unreachable_peer_falls_back():
    t = SocketTransport(
        {0: ("127.0.0.1", _dead_port())}, timeout_s=0.2,
        sample_shape=(8,), dtype="<f4",
    )
    try:
        rows, ok = t.fetch(0, np.asarray([1, 2, 3]))
        assert rows.shape == (0, 8) and not ok.any()
        rows, ok = t.fetch(9, np.asarray([4]))
        assert rows.shape == (0, 8) and not ok.any()
    finally:
        t.close()


def test_loaderspec_transport_validation(tmp_path):
    with pytest.raises(ValueError, match="unknown transport"):
        LoaderSpec(loader="solar", path="x", transport="carrier-pigeon").validate()
    LoaderSpec(loader="solar", path="x", transport="socket").validate()
    path = str(tmp_path / "ts_store")
    store = create_store(path, "binary", spec=DatasetSpec(64, (4,), "<f4"),
                         fill="arange")
    spec = LoaderSpec(
        loader="solar", store=store, num_nodes=2, local_batch=2,
        num_epochs=1, buffer_size=8, transport="socket",
    )
    try:
        with pytest.raises(ValueError, match="run_distributed"):
            execute(spec, plan(spec))
    finally:
        store.close()


def test_execute_replays_a_socket_spec_through_live_buffer_servers(tmp_path):
    """``execute(spec, plan, peer_transport=...)`` with one live BufferServer
    per node, stepped in lockstep as a rank loop steps them: every planned
    peer fetch is served over the wire, none falls back, and the batch
    stream equals the in-process shared transport's bit for bit."""
    path = str(tmp_path / "sock_store")
    store = create_store(path, "binary", spec=DatasetSpec(512, (8,), "<f4"),
                         fill="random", seed=4)
    geo = dict(num_nodes=2, local_batch=8, num_epochs=2, buffer_size=64, seed=0)
    solar = SolarConfig(num_nodes=2, local_batch=8, buffer_size=64,
                        capacity_factor=1.0, enable_peer=True, seed=0)
    shared = LoaderSpec(loader="solar", store=store, collect_data=True,
                        peer_fetch=True, solar=solar, **geo)
    spec = shared.replace(transport="socket")
    servers = [BufferServer(n, (8,), "<f4", port=0).start() for n in range(2)]
    transport = SocketTransport({s.node: (s.host, s.port) for s in servers},
                                timeout_s=2.0, sample_shape=(8,), dtype="<f4")
    try:
        want = stream_digest(build_pipeline(shared))
        executor = execute(spec, plan(spec), peer_transport=transport)
        for s in servers:
            s.attach(executor._mirror)
        batches = []
        for g, (ep, sp) in enumerate(executor.plan_steps()):
            for s in servers:
                s.at_step(g)
            transport.at_step(g)
            peers = executor.gather_peers(sp)
            with contextlib.ExitStack() as stack:
                for s in servers:
                    stack.enter_context(s.mutating())
                batches.append(executor.execute_step(ep, sp, peer_arrays=peers))
        assert stream_digest(batches) == want
        assert executor.peer_exchange.served > 0
        assert executor.peer_exchange.fallbacks == 0
        assert sum(s.stale_refusals for s in servers) == 0
        assert executor.report.transport_stats["retries"] == 0
    finally:
        transport.close()
        for s in servers:
            s.close()
        store.close()
