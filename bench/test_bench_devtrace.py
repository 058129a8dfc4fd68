"""The trace reduction and the per-layer readers on synthetic readings:
busy time as a union, device time by name, idle stretches labelled by the
host call under them, and each reader's arithmetic (or None where it finds
nothing to read)."""
from __future__ import annotations

import pytest

from bench import kinds, manifest, readers
from bench.cell import Readings
from bench.counts import kernels
from bench.devtrace import Trace


def _trace():
    dev = [(0.0, 1.0, "void selective_scan_fwd_kernel<16>"),
           (0.5, 1.5, "void flash_fwd_tc_kernel<64>"),      # overlaps: counted once
           (3.0, 4.0, "void selective_scan_bwd_kernel<16, 8>"),
           (4.0, 4.5, "void sum_parts_kernel<bf16>"),
           (4.5, 5.0, "void attn_bwd_dot_kernel<64>"),
           (5.0, 6.0, "void attn_bwd_dkdv_tc_kernel<64>")]
    host = [(1.4, 3.2, "cudaStreamSynchronize"), (2.0, 2.2, "cudaLaunchKernel")]
    return Trace(dev, host, window_s=8.0)


def test_busy_is_the_union_of_device_intervals():
    assert _trace().busy_s == pytest.approx(4.5)


def test_device_ops_by_name_and_idle_gaps_by_host_call():
    t = _trace()
    top = dict(t.top_device_ops())
    assert top["void selective_scan_fwd_kernel<16>"] == pytest.approx(1.0)
    gaps = dict(t.idle_gaps())
    assert gaps == {"cudaStreamSynchronize": pytest.approx(1.5)}


def _readings(**kw):
    cfg = manifest.config("hymba-1.5b")
    base = dict(config=cfg, mix={"seq_len": 2048, "num_nodes": 2}, kind=kinds.get("lm"),
                capacity=8, window_s=10.0, pfs_reads=30, trace=None, window_trace=None,
                steps=[{"wait_s": 0.001, "load_s": 0.002, "compute_s": 0.1 * (i + 1)}
                       for i in range(20)],
                real_rows=[10.0] * 20, rows=[16] * 20)
    base.update(kw)
    return Readings(**base)


def test_step_readers():
    r = _readings()
    assert readers.mean_ms(r, "wait_s") == pytest.approx(1.0)
    assert readers.mean_ms(r, "compute_s") == pytest.approx(1050.0)
    assert readers.pad_share(r) == pytest.approx(0.375)
    assert readers.pfs_reads_per_step(r) == pytest.approx(1.5)
    assert 1900 < readers.step_p95_ms(r) < 2003


def test_mfu_divides_the_weighted_rows_flops_by_the_window_and_the_peak():
    r = _readings()
    flops = 200 * kinds.get("lm").model_flops_per_row(r.config, r.mix)
    assert readers.mfu_percent(r) == pytest.approx(100 * flops / 10.0 / 989e12)


def test_roofline_shares_count_the_calls_in_the_trace():
    r = _readings(trace=_trace())
    scan = kernels.scan(2, 2048, 3200, 16, 2)
    scan_bwd = kernels.scan_bwd(2, 2048, 3200, 16, 2)
    want = 100 * (kernels.bound_s(scan) + kernels.bound_s(scan_bwd)) / 2.5
    assert readers.k3_roofline(r) == pytest.approx(want)
    att = kernels.attention(2, 25, 5, 2048, 2048, 64, True, 1024, 2)
    att_bwd = kernels.attention_bwd(2, 25, 5, 2048, 2048, 64, True, 1024, 2)
    want = 100 * (kernels.bound_s(att) + kernels.bound_s(att_bwd)) / 2.5
    assert readers.k2_roofline(r) == pytest.approx(want)
    assert readers.idle_share(r) == pytest.approx(1 - 4.5 / 8.0)


def test_device_step_time_is_the_busy_union_over_the_traced_steps():
    r = _readings(trace=_trace(), mix={"seq_len": 2048, "num_nodes": 2, "trace_steps": 3})
    assert readers.device_step_ms(r) == pytest.approx(1e3 * 4.5 / 3)


def test_window_rate_divides_all_the_window_work_by_its_time():
    r = _readings()
    assert readers.window_rate(r) == pytest.approx(200 * 2048 / 10.0)
    cosmo = _readings(config=manifest.config("cosmoflow"), kind=kinds.get("surrogate"))
    assert readers.window_rate(cosmo) == pytest.approx(200 / 10.0)


def test_device_time_per_sample_is_the_window_traces_busy_union_over_its_samples():
    cosmo = dict(config=manifest.config("cosmoflow"), kind=kinds.get("surrogate"))
    assert readers.device_ms_per_unit(_readings(**cosmo)) is None
    assert readers.device_ms_per_unit(_readings(trace=_trace(), **cosmo)) is None
    r = _readings(window_trace=_trace(), **cosmo)
    assert readers.device_ms_per_unit(r) == pytest.approx(1e3 * 4.5 / 200)
    assert manifest.metric_reader("device_ms_per_sample").read(r) == pytest.approx(22.5)


@pytest.mark.parametrize("reader", ["k2_roofline", "k3_roofline", "idle_share",
                                    "device_step_ms"])
def test_trace_readers_find_nothing_without_a_trace_or_its_kernels(reader):
    assert getattr(readers, reader)(_readings()) is None
    empty = Trace([(0.0, 1.0, "void some_other_kernel")], [], 2.0)
    if reader not in ("idle_share", "device_step_ms"):
        assert getattr(readers, reader)(_readings(trace=empty)) is None
