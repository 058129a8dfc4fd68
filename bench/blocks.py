"""The interleaved family's block spans on the device trace's clock: for
each thread and kind, the spans, their host time and the card's idle time
inside them, per traced step.  Run by hand on the card; the benchmark's
runs record no spans.

    python3 bench/blocks.py --workload jamba2-3b.train-solar-4k --seed <n> \
        --seconds <s> [--out spans.jsonl]

``bench/spans.py``'s run and line (its arguments), with ``blocks`` added
to the line's ``spans``: ``"<kind> @ <thread>"`` for ``block.mamba`` and
``block.attention`` on each thread that recorded them (the steps' thread
for a block's forward, autograd's for its recompute under remat).  The
reduction imports nothing of the port."""
from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    HERE = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != HERE]
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from bench import spans as S  # noqa: E402

__all__ = ["KINDS", "block_split"]

KINDS = ("block.mamba", "block.attention")


def block_split(spans: list, trace, stretch: tuple, trace_steps: int) -> dict:
    """Per thread and block kind inside ``stretch``: spans, host ms and the
    card's idle ms in them, each per traced step."""
    s0, s1 = stretch
    out = {}
    for thread in sorted({sp[3] for sp in spans if sp[2] in KINDS}):
        for kind in KINDS:
            mine = [sp for sp in spans if sp[2] == kind and sp[3] == thread
                    and sp[1] > s0 and sp[0] < s1]
            out[f"{kind} @ {thread}"] = {
                "spans_per_step": len(mine) / trace_steps,
                "host_ms_per_step": 1e3 * sum(min(e, s1) - max(s, s0)
                                              for s, e, *_ in mine) / trace_steps,
                "idle_ms_per_step": 1e3 * S.idle_in(trace, spans, (kind,), thread, s0, s1)
                / trace_steps}
    return out


def main(argv=None) -> int:
    readings = S.readings

    def with_blocks(spans, dropped, trace, window, stretch, steps, trace_steps, *rest):
        out = readings(spans, dropped, trace, window, stretch, steps, trace_steps, *rest)
        if not dropped and trace is not None and trace.device_ops:
            out["blocks"] = block_split(spans, trace, stretch, trace_steps)
        return out

    S.readings = with_blocks
    try:
        return S.main(argv)
    finally:
        S.readings = readings


if __name__ == "__main__":
    sys.exit(main())
