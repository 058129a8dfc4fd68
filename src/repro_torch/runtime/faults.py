"""Deterministic, seeded fault injection for the distributed runtime.

Own copy of the JAX package's ``runtime/faults.py``: the same plans from
the same seeds, and a process-global armed plan of its own (arming one
package leaves the other disarmed).  The rank step loop of
:mod:`repro_torch.runtime.launcher` consults the ``crash``/``hb_loss``
faults.

Every recovery path in the elastic runtime (DESIGN.md §9) — the wire
framing's corruption detection, the transport's retry/backoff/circuit-breaker
ladder, the launcher's suspect→probe→declare-dead detector, and plan
re-slicing — is exercised through *named injection sites* threaded through
the production code:

  ==================  =====================================================
  site                where it fires
  ==================  =====================================================
  ``server.rows``     a ``BufferServer`` sending a ROWS frame
                      (``corrupt`` / ``truncate`` faults)
  ``server.fetch``    a ``BufferServer`` about to serve a fetch
                      (``slow`` faults: injected latency)
  ``transport.dial``  a ``SocketTransport`` dialing a peer
                      (``reset`` faults: connection reset mid-dial)
  ``rank.crash``      the rank step loop, at a step boundary
                      (``crash`` faults: ``os._exit``, no cleanup)
  ``rank.stall``      the rank step loop + heartbeat thread
                      (``hb_loss`` faults: heartbeats suppressed and the
                      step loop stalled — a wedged-but-alive process, the
                      false-suspect case)
  ==================  =====================================================

A :class:`FaultPlan` is **pure data** (picklable, spawn-safe): each fault
names its rank, its site or step, and when it fires (the n-th passage
through the site).  :func:`FaultPlan.compile` places a requested mix of
fault classes pseudo-randomly but *deterministically* from a seed — the
same seed always produces the same chaos, so every failure a chaos run
finds is reproducible bit for bit.  Inside a rank process :func:`arm`
activates the rank's slice of the plan; the production modules consult the
module-global hooks (:func:`on_send`, :func:`on_dial`, :func:`on_serve`)
which are no-ops (``None`` returns) when nothing is armed — the happy path
costs one ``is None`` check per site.

Every firing is counted per site in :attr:`ArmedFaults.fired` and reported
through the rank report into the launcher's report — a chaos run that
injected nothing is visible, not silently green.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from repro_torch.obs import trace as obs_trace

__all__ = [
    "Fault",
    "FaultPlan",
    "ArmedFaults",
    "InjectedTruncation",
    "FAULT_KINDS",
    "arm",
    "disarm",
    "active",
    "on_send",
    "on_dial",
    "on_serve",
]

#: the fault classes the harness knows how to inject.
FAULT_KINDS = ("corrupt", "truncate", "reset", "slow", "crash", "hb_loss")

#: sites that frame-level faults (corrupt/truncate) may name.
_SEND_SITES = ("server.rows", "transport.fetch")


class InjectedTruncation(OSError):
    """Raised at a send site after deliberately writing a partial frame —
    the caller's normal OSError handling closes the connection, and the
    receiving end observes a :class:`~repro_torch.runtime.wire.TruncatedFrame`."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One armed fault.  Which fields matter depends on ``kind``:

    * ``corrupt`` / ``truncate``: ``rank`` + ``site`` + ``nth`` (fire on the
      n-th frame sent through that site in that rank's process).
    * ``reset``: ``rank`` + ``nth`` (fire on the n-th peer dial).
    * ``slow``: ``rank`` + ``nth`` + ``delay_s`` (sleep before serving the
      n-th fetch).
    * ``crash``: ``rank`` + ``step`` (``os._exit`` at that step boundary).
    * ``hb_loss``: ``rank`` + ``step`` + ``delay_s`` (suppress heartbeats
      and stall the step loop for ``delay_s`` at that boundary — process
      alive, silent: the false-suspect case).
    """

    kind: str
    rank: int
    site: str | None = None
    step: int | None = None
    nth: int | None = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}"
            )
        if self.kind in ("corrupt", "truncate") and self.site not in _SEND_SITES:
            raise ValueError(
                f"{self.kind} fault needs a send site in {_SEND_SITES}, "
                f"got {self.site!r}"
            )
        if self.kind in ("crash", "hb_loss") and self.step is None:
            raise ValueError(f"{self.kind} fault needs a step")
        if self.kind in ("corrupt", "truncate", "reset", "slow") and (
            self.nth is None or self.nth < 1
        ):
            raise ValueError(f"{self.kind} fault needs nth >= 1")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible set of faults for one distributed run (pure data)."""

    seed: int = 0
    faults: tuple[Fault, ...] = ()

    @classmethod
    def compile(
        cls,
        seed: int,
        num_ranks: int,
        *,
        num_steps: int = 8,
        crashes: int = 0,
        corrupt: int = 0,
        truncate: int = 0,
        resets: int = 0,
        slow: int = 0,
        hb_loss: int = 0,
        slow_delay_s: float = 0.05,
        hb_pause_s: float = 1.0,
        spare_rank: int | None = None,
    ) -> "FaultPlan":
        """Place the requested fault mix deterministically from ``seed``.

        ``crashes`` ranks are chosen without replacement (a rank crashes at
        most once); frame/dial faults land on any rank with ``nth`` drawn
        from the early passages so they actually fire at toy scale.
        ``spare_rank`` (when given) is excluded from crash/stall placement —
        chaos runs keep at least one designated survivor.
        """
        if num_ranks < 1:
            raise ValueError(f"num_ranks must be >= 1, got {num_ranks}")
        rng = np.random.default_rng(int(seed))
        candidates = [
            r for r in range(num_ranks) if r != spare_rank
        ] or list(range(num_ranks))
        faults: list[Fault] = []

        def pick_rank() -> int:
            return int(rng.choice(num_ranks))

        def pick_step() -> int:
            return int(rng.integers(1, max(num_steps, 2)))

        crash_ranks = rng.choice(
            candidates, size=min(crashes, len(candidates)), replace=False
        )
        for r in crash_ranks:
            faults.append(Fault("crash", int(r), step=pick_step()))
        for _ in range(hb_loss):
            faults.append(Fault(
                "hb_loss", int(rng.choice(candidates)), step=pick_step(),
                delay_s=float(hb_pause_s),
            ))
        for _ in range(corrupt):
            faults.append(Fault(
                "corrupt", pick_rank(),
                site=_SEND_SITES[int(rng.integers(len(_SEND_SITES)))],
                nth=int(rng.integers(1, 6)),
            ))
        for _ in range(truncate):
            faults.append(Fault(
                "truncate", pick_rank(),
                site=_SEND_SITES[int(rng.integers(len(_SEND_SITES)))],
                nth=int(rng.integers(1, 6)),
            ))
        for _ in range(resets):
            faults.append(Fault("reset", pick_rank(), nth=int(rng.integers(1, 4))))
        for _ in range(slow):
            faults.append(Fault(
                "slow", pick_rank(), nth=int(rng.integers(1, 6)),
                delay_s=float(slow_delay_s),
            ))
        return cls(seed=int(seed), faults=tuple(faults))

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the CLI form: ``seed=3,crash=1,corrupt=2,slow=1,...``.

        Keys: ``seed``, ``steps`` (placement horizon), every kind in
        :data:`FAULT_KINDS` (count), ``ranks`` (required for placement),
        ``slow_delay``/``hb_pause`` (seconds).
        """
        kv: dict[str, float] = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad --faults token {part!r}: expected key=value"
                )
            k, v = part.split("=", 1)
            kv[k.strip()] = float(v)
        ranks = int(kv.pop("ranks", 0))
        if ranks < 1:
            raise ValueError("--faults needs ranks=N (the rank count)")
        seed = int(kv.pop("seed", 0))
        num_steps = int(kv.pop("steps", 8))
        crashes = int(kv.pop("crash", 0))
        corrupt = int(kv.pop("corrupt", 0))
        truncate = int(kv.pop("truncate", 0))
        resets = int(kv.pop("reset", 0))
        slow = int(kv.pop("slow", 0))
        hb_loss = int(kv.pop("hb_loss", 0))
        slow_delay_s = float(kv.pop("slow_delay", 0.05))
        hb_pause_s = float(kv.pop("hb_pause", 1.0))
        spare_rank = int(kv.pop("spare")) if "spare" in kv else None
        if kv:
            raise ValueError(f"unknown --faults keys: {sorted(kv)}")
        return cls.compile(
            seed, ranks,
            num_steps=num_steps, crashes=crashes, corrupt=corrupt,
            truncate=truncate, resets=resets, slow=slow, hb_loss=hb_loss,
            slow_delay_s=slow_delay_s, hb_pause_s=hb_pause_s,
            spare_rank=spare_rank,
        )

    def for_rank(self, rank: int) -> tuple[Fault, ...]:
        return tuple(f for f in self.faults if f.rank == int(rank))

    def summary(self) -> dict:
        out: dict[str, int] = {}
        for f in self.faults:
            out[f.kind] = out.get(f.kind, 0) + 1
        return {"seed": self.seed, **out}


class ArmedFaults:
    """One rank process's live view of its :class:`FaultPlan` slice.

    Passage counters are per site; a fault with ``nth=k`` fires on exactly
    the k-th passage.  Everything that fires is tallied in :attr:`fired`
    (``kind:site`` -> count) for the rank report.
    """

    def __init__(self, faults: Iterable[Fault], rank: int, seed: int = 0):
        self.rank = int(rank)
        self.seed = int(seed)
        self.faults = tuple(faults)
        self._calls: dict[str, int] = {}
        self.fired: dict[str, int] = {}

    def _tally(self, fault: Fault) -> None:
        key = f"{fault.kind}:{fault.site or fault.step}"
        self.fired[key] = self.fired.get(key, 0) + 1
        # every firing is also a trace instant (kind + site interned into
        # the span name; a = the nth-passage/step it fired on, b = the plan
        # seed) — a chaos run's trace shows each fault next to its latency
        # effect (DESIGN.md §13).
        tr = obs_trace.get()
        if tr.enabled:
            tr.instant(
                obs_trace.kind_id(f"fault.{key}"),
                a=int(fault.nth if fault.nth is not None else fault.step or 0),
                b=self.seed,
            )

    def _bump(self, site: str) -> int:
        n = self._calls.get(site, 0) + 1
        self._calls[site] = n
        return n

    # -- site hooks ----------------------------------------------------------

    def on_send(self, site: str) -> str | None:
        """``corrupt`` / ``truncate`` / None for the n-th frame at ``site``."""
        n = self._bump(site)
        for f in self.faults:
            if f.kind in ("corrupt", "truncate") and f.site == site and f.nth == n:
                self._tally(f)
                return f.kind
        return None

    def on_dial(self) -> bool:
        """True when the n-th peer dial should be reset."""
        n = self._bump("transport.dial")
        for f in self.faults:
            if f.kind == "reset" and f.nth == n:
                self._tally(f)
                return True
        return False

    def on_serve(self) -> float:
        """Injected latency (seconds) before serving the n-th fetch."""
        n = self._bump("server.fetch")
        for f in self.faults:
            if f.kind == "slow" and f.nth == n:
                self._tally(f)
                return f.delay_s
        return 0.0

    # -- step-indexed faults (consulted by the rank loop directly) -----------

    def crash_step(self) -> int | None:
        for f in self.faults:
            if f.kind == "crash":
                return f.step
        return None

    def stall(self, step: int) -> float:
        """Stall duration for ``hb_loss`` faults armed at ``step``."""
        for f in self.faults:
            if f.kind == "hb_loss" and f.step == step:
                self._tally(f)
                return f.delay_s
        return 0.0

    def summary(self) -> dict:
        return dict(self.fired)


# ---------------------------------------------------------------------------
# Process-global arming (one rank process == at most one armed plan)
# ---------------------------------------------------------------------------

_ACTIVE: ArmedFaults | None = None


def arm(plan: FaultPlan | None, rank: int) -> ArmedFaults | None:
    """Activate ``plan``'s slice for ``rank`` in this process (or disarm)."""
    global _ACTIVE
    if plan is None:
        _ACTIVE = None
        return None
    _ACTIVE = ArmedFaults(plan.for_rank(rank), rank, seed=plan.seed)
    return _ACTIVE


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> ArmedFaults | None:
    return _ACTIVE


def on_send(site: str) -> str | None:
    return None if _ACTIVE is None else _ACTIVE.on_send(site)


def on_dial() -> bool:
    return False if _ACTIVE is None else _ACTIVE.on_dial()


def on_serve() -> float:
    return 0.0 if _ACTIVE is None else _ACTIVE.on_serve()
