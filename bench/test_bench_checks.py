"""The by-hand tools' reductions on the CPU: ``checks.py``'s split of a
bfloat16 update difference into one-ulp elements and gradient sign flips,
its batch digests, and ``blocks.py``'s per-thread split of the block
spans' host and idle time on a synthetic device trace."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import blocks, checks
from bench.devtrace import Trace


@pytest.mark.parametrize("x, ulp", [(1.0, 2.0 ** -7), (0.75, 2.0 ** -8), (-3.0, 2.0 ** -6),
                                    (0.0, 2.0 ** -133)])
def test_bf16_ulp_is_the_spacing_of_bfloat16_values(x, ulp):
    got = float(checks.bf16_ulp(torch.tensor([x]))[0])
    assert got == ulp
    if x:
        v = torch.tensor([abs(x)], dtype=torch.bfloat16)
        assert float(torch.nextafter(v.float(), torch.tensor([9.0])).bfloat16().float()[0]) \
            in (abs(x), abs(x) + ulp)


def test_ulp_split_counts_one_ulp_elements_and_sign_flips():
    p0 = torch.tensor([1.0, 1.0, 0.5, 0.25], dtype=torch.bfloat16)
    ref = torch.tensor([2.0 ** -6, -2.0 ** -6, 2.0 ** -7, 0.0])
    prog = ref.clone()
    prog[0] += 2.0 ** -7                   # one ulp at 1.0
    prog[1] = 2.0 ** -6                    # the other sign: four ulps
    g_ref = torch.tensor([1.0, -1e-3, 2.0, 3.0])
    g_prog = torch.tensor([1.0, 1e-3, 2.0, 3.0])
    s = checks.ulp_split(p0, prog, ref, g_prog, g_ref)
    assert (s["elements"], s["differ"], s["one_ulp"], s["grad_sign_flips"]) == (4, 2, 1, 1)
    assert s["diff_sq"] == pytest.approx(2.0 ** -14 + 2.0 ** -10)
    m = checks.merge_splits([s, s])
    assert m["differ"] == 4
    assert m["share_of_diff_sq_one_ulp"] == pytest.approx(2.0 ** -14 / (2.0 ** -14 + 2.0 ** -10))
    assert m["share_of_diff_sq_sign_flips"] == pytest.approx(2.0 ** -10 / (2.0 ** -14 + 2.0 ** -10))
    assert m["update_err"] == pytest.approx(
        ((2.0 ** -14 + 2.0 ** -10) / float(ref.double().square().sum())) ** 0.5)


def test_ids_digest_follows_the_order_of_the_ids():
    a = checks.ids_digest([np.array([3, 1, 2]), [5, 4]])
    assert a == checks.ids_digest([[3, 1, 2], np.array([5, 4], np.int32)])
    assert a[0] != checks.ids_digest([[1, 2, 3]])[0] and len(a[0]) == 16


def test_block_split_reads_each_thread_and_kind_apart():
    trace = Trace([(0.0, 1.0, "k1"), (2.0, 3.0, "k2"), (4.0, 6.0, "k3")], [], window_s=6.0)

    def s(a, b, kind, thread):
        return (a, b, kind, thread, 0, 0, 0)

    spans = [s(0.5, 2.5, "block.mamba", "MainThread"), s(2.5, 4.5, "block.attention", "MainThread"),
             s(3.5, 5.0, "block.mamba", "autograd"), s(0.0, 6.0, "train.compute", "MainThread")]
    out = blocks.block_split(spans, trace, (0.0, 6.0), trace_steps=2)
    assert set(out) == {f"{k} @ {t}" for k in blocks.KINDS for t in ("MainThread", "autograd")}
    main_m, main_a = out["block.mamba @ MainThread"], out["block.attention @ MainThread"]
    assert main_m["spans_per_step"] == 0.5
    assert main_m["host_ms_per_step"] == pytest.approx(1e3)
    assert main_m["idle_ms_per_step"] == pytest.approx(1e3 * 1.0 / 2)      # 1.0-2.0
    assert main_a["idle_ms_per_step"] == pytest.approx(1e3 * 1.0 / 2)      # 3.0-4.0
    assert out["block.mamba @ autograd"]["idle_ms_per_step"] == pytest.approx(1e3 * 0.5 / 2)
    assert out["block.attention @ autograd"]["spans_per_step"] == 0.0
    # the stretch clips the spans
    clipped = blocks.block_split(spans, trace, (1.0, 2.0), trace_steps=1)
    assert clipped["block.mamba @ MainThread"]["host_ms_per_step"] == pytest.approx(1e3)
