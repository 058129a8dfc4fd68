"""The program spans' reductions on a synthetic device trace: the mapping
onto the profiler's clock, device idle time inside spans by interval
intersection, idle gaps labelled by the runtime call, else the steps'
innermost span, else nothing, and the per-step readings."""
from __future__ import annotations

import numpy as np
import pytest

from bench import spans as sp
from bench.devtrace import Trace

MAIN = "MainThread"


def _trace():
    dev = [(0.0, 1.0, "k1"), (2.0, 3.0, "k2"), (5.0, 6.0, "k3"), (8.0, 9.0, "k4")]
    host = [(0.1, 0.2, "cudaLaunchKernel"), (2.05, 2.1, "cudaLaunchKernel"),
            (3.0, 3.05, "cudaLaunchKernel"), (3.5, 4.5, "cudaStreamSynchronize"),
            (7.1, 7.15, "cudaLaunchKernel")]
    return Trace(dev, host, window_s=9.0)


def _spans():
    def s(a, b, kind, thread=MAIN, step=0, x=0):
        return (a, b, kind, thread, step, x, 0)

    return [s(0.5, 2.5, "train.make_batch"), s(0.6, 1.8, "batch.to_global"),
            s(2.5, 6.5, "train.compute"), s(2.5, 4.5, "step.forward"),
            s(6.5, 6.9, "prefetch.qwait", step=1, x=2), s(7.5, 8.5, "train.make_batch", step=1),
            s(7.6, 7.8, "batch.to_global", step=1), s(8.5, 9.0, "train.compute", step=1),
            s(0.0, 0.4, "prefetch.qwait", x=1),
            s(1.0, 7.5, "prefetch.assemble", "solar-pipeline", 1),
            s(1.0, 3.0, "chunk.read", "solar-io_0", 1), s(2.0, 4.0, "chunk.read", "solar-io_1", 1)]


def test_records_map_through_the_anchor():
    recs = np.array([(1.0, 1.5, 1, 3, 7, 8)],
                    dtype=[("t0", "f8"), ("t1", "f8"), ("kind", "u2"), ("step", "i8"),
                           ("a", "i8"), ("b", "i8")])
    (got,) = sp.map_spans(recs, ["io"], ["x", "chunk.read"], lambda t: 1.7e9 - 100.0 + t)
    assert got[0] == pytest.approx(1.7e9 - 99.0) and got[1] == pytest.approx(1.7e9 - 98.5)
    assert got[2:] == ("chunk.read", "io", 3, 7, 8)


def test_merge_and_overlap_against_a_fine_grid():
    rng = np.random.default_rng(4)
    a, b = ([(int(x), int(x + w)) for x, w in zip(rng.integers(0, 90, 12),
                                                   rng.integers(1, 9, 12))] for _ in range(2))
    ga, gb = np.zeros(100, bool), np.zeros(100, bool)
    for x, y in a:
        ga[x:y] = True
    for x, y in b:
        gb[x:y] = True
    ma, mb = sp.merge(a), sp.merge(b)
    assert sum(y - x for x, y in ma) == ga.sum()
    assert sp.overlap(ma, mb) == (ga & gb).sum()


def test_idle_inside_spans_is_every_gap_they_cover():
    t, s = _trace(), _spans()
    # make-batch (0.5, 2.5) holds the gap (1, 2); (7.5, 8.5) holds (7.5, 8)
    assert sp.idle_in(t, s, ("train.make_batch",), MAIN, 0.0, 9.0) == pytest.approx(1.5)
    # compute (2.5, 6.5) is busy 0.5 + 1.0 of its 4 s; (8.5, 9) is busy
    assert sp.idle_in(t, s, ("train.compute",), MAIN, 0.0, 9.0) == pytest.approx(2.5)
    assert sp.idle_in(t, s, ("train.compute",), MAIN, 0.0, 4.0) == pytest.approx(1.0)
    # another thread's spans are not the steps'
    assert sp.idle_in(t, s, ("prefetch.assemble",), MAIN, 0.0, 9.0) == 0.0
    assert sp.idle_in(t, s, None, MAIN, 0.0, 9.0) == pytest.approx(1.5 + 2.5 + 0.4)


def test_gaps_take_the_runtime_call_else_the_steps_innermost_span_else_none():
    got = dict(sp.labelled_gaps(_trace(), _spans(), MAIN))
    # (1, 2) inside to_global; (3, 5) under the synchronize; (6, 8) in no
    # span of the steps' thread (the pipeline's assembly does not count)
    assert got == {"span:batch.to_global": pytest.approx(1.0),
                   "cudaStreamSynchronize": pytest.approx(2.0),
                   "host: none": pytest.approx(2.0)}
    # without spans, the labels are the trace's own
    assert dict(sp.labelled_gaps(_trace(), [], MAIN)) == pytest.approx(
        dict(_trace().idle_gaps()))


def test_window_readings():
    s = _spans()
    assert sp.per_step_ms(s, "batch.to_global", 0.0, 9.0, 2) == pytest.approx(700.0)
    assert sp.per_step_ms(s, "batch.to_global", 7.0, 9.0, 1) == pytest.approx(200.0)
    assert sp.per_step_ms(s, "batch.stage", 0.0, 9.0, 2) is None
    assert sp.queue_depth(s, 0.0, 9.0) == pytest.approx(1.5)
    assert sp.busy_share(s, "chunk.read", 0.0, 10.0, 2) == pytest.approx(0.2)
    assert sp.busy_share(s, "chunk.read", 2.5, 3.5, 2) == pytest.approx(0.75)


def test_launches_of_the_first_step_outside_its_spans():
    # the first step runs from its make-batch at 0.5 to the next at 7.5:
    # launches at 2.05 and 3.0 fall inside its spans, 7.1 (after the wait) not
    assert sp.launches_outside(_trace(), _spans(), MAIN, 0.0, 9.0) == (3, 1)
    assert sp.launches_outside(_trace(), [], MAIN, 0.0, 9.0) == (0, 0)


def test_readings_per_step_and_none_after_drops():
    t, s = _trace(), _spans()
    got = sp.readings(s, 0, t, (0.0, 9.0), (0.0, 9.0), 2, 2, 2, MAIN, "surrogate")
    assert got["to_global_ms.surrogate"] == pytest.approx(700.0)
    assert got["loader_assemble_ms.surrogate"] == pytest.approx(3250.0)
    assert got["idle_in_batch_ms.surrogate"] == pytest.approx(750.0)
    assert got["idle_in_step_ms.surrogate"] == pytest.approx(1250.0)
    assert got["idle_ms_per_step"] == pytest.approx(2500.0)
    # the idle time outside make-batch, compute and the waits: (6.9, 7.5)
    assert got["idle_in_ms"]["outside the step's spans"] == pytest.approx(300.0)
    assert got["idle_in_ms"]["prefetch.qwait"] == pytest.approx(200.0)
    assert sp.readings(s, 3, t, (0.0, 9.0), (0.0, 9.0), 2, 2, 2, MAIN, "lm") == {"dropped": 3}
