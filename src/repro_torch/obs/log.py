"""Structured, rank-tagged logging shared by the runtime and the CLIs (§13).

Thin wrapper over stdlib :mod:`logging` so every progress/diagnostic event
in the launcher, the streaming loop, and the benchmark harness goes
through one vocabulary (and one ``--quiet``/``--verbose`` switch) instead
of bare prints.  Machine-readable outputs — benchmark CSV rows, JSON
reports — are a separate contract and never route through here.

Own copy of the JAX package's ``obs/log.py``; its loggers live under
``repro_torch`` and print the same ``[level rN name]`` lines.
"""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "configure", "add_verbosity_args", "verbosity_from"]

_ROOT = "repro_torch"
_configured = False


class _RankFormatter(logging.Formatter):
    """``[level name] message`` with an optional ``rN`` rank tag."""

    def __init__(self, rank: int | None):
        super().__init__()
        self.rank = rank

    def format(self, record: logging.LogRecord) -> str:
        tag = "" if self.rank is None else f" r{self.rank}"
        name = record.name
        if name.startswith(_ROOT + "."):
            name = name[len(_ROOT) + 1:]
        return (
            f"[{record.levelname.lower()}{tag} {name}] {record.getMessage()}"
        )


def get_logger(name: str) -> logging.Logger:
    """A namespaced logger (``repro_torch.<name>``); silent until configured."""
    return logging.getLogger(f"{_ROOT}.{name}")


def configure(
    verbosity: int = 0, *, rank: int | None = None, stream=None
) -> logging.Logger:
    """Install one stderr handler on the ``repro_torch`` root.

    ``verbosity``: -1 (``--quiet``) -> ERROR, 0 -> WARNING, 1 (``-v``) ->
    INFO, >=2 (``-vv``) -> DEBUG.  Reconfiguring replaces the handler (the
    spawned rank processes call this with their own rank tag).
    """
    global _configured
    root = logging.getLogger(_ROOT)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(_RankFormatter(rank))
    root.addHandler(handler)
    if verbosity <= -1:
        root.setLevel(logging.ERROR)
    elif verbosity == 0:
        root.setLevel(logging.WARNING)
    elif verbosity == 1:
        root.setLevel(logging.INFO)
    else:
        root.setLevel(logging.DEBUG)
    root.propagate = False
    _configured = True
    return root


def add_verbosity_args(parser) -> None:
    """Attach the shared ``--quiet`` / ``--verbose`` flags to an argparser."""
    parser.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="log progress events (-v: info, -vv: debug)",
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true",
        help="suppress warnings (errors only)",
    )


def verbosity_from(args) -> int:
    """Collapse parsed ``--quiet``/``--verbose`` into one verbosity int."""
    if getattr(args, "quiet", False):
        return -1
    return int(getattr(args, "verbose", 0))
