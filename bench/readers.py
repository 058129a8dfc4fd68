"""What the per-layer metric files share.  Each ``metrics/<name>.py``
declares its layer, unit, source and the end-to-end metric it moves, and
``read(r)`` takes a :class:`bench.cell.Readings`; it returns None where it
finds nothing to read."""
from __future__ import annotations

from bench.counts import kernels, peaks
from bench.counts.models import lm_dims
from bench.window import percentile, rate


def step_periods_ms(r) -> list:
    return [1e3 * (t["wait_s"] + t["load_s"] + t["compute_s"]) for t in r.steps]


def step_p95_ms(r):
    return percentile(step_periods_ms(r), 95) if r.steps else None


def mean_ms(r, key: str):
    return 1e3 * sum(t[key] for t in r.steps) / len(r.steps) if r.steps else None


def pfs_reads_per_step(r):
    return r.pfs_reads / len(r.steps) if r.steps else None


def pad_share(r):
    return 1.0 - sum(r.real_rows) / sum(r.rows) if r.rows else None


def mfu_percent(r):
    """Model FLOPs of the weighted rows over the window's time and the peak
    of the precision the configuration computes in."""
    flops = sum(r.real_rows) * r.kind.model_flops_per_row(r.config, r.mix)
    return 100.0 * flops / r.window_s / peaks.peak_flops(r.config["precision"])


def window_rate(r):
    """The window's weighted work units (samples, tokens) over its whole
    wall time."""
    if not r.steps:
        return None
    return rate(sum(r.real_rows) * r.kind.units_per_row(r.config, r.mix), r.window_s)


def device_ms_per_unit(r):
    """The device's busy time over the whole window (the union of its
    operations' intervals in the window's own trace) per weighted work unit:
    what the card spends on a trained sample, whatever the host's pace."""
    t = r.window_trace
    if t is None or not t.device_ops or not r.real_rows:
        return None
    return 1e3 * t.busy_s / (sum(r.real_rows) * r.kind.units_per_row(r.config, r.mix))


def idle_share(r):
    if r.trace is None or not r.trace.device_ops:
        return None
    return 1.0 - r.trace.busy_s / r.trace.window_s


def device_step_ms(r):
    """Device time of a traced step: the union of device intervals over the
    steps traced.  Unlike the window's rate, the host's pace does not move it."""
    if r.trace is None or not r.trace.device_ops:
        return None
    return 1e3 * r.trace.busy_s / r.mix["trace_steps"]


def _microbatch(r) -> int:
    return r.capacity * r.mix["num_nodes"] // r.config["model"].get("grad_accum", 1)


def _share(r, fwd_ops, bwd_ops, n_bwd, fwd_work, bwd_work, dot_precision="bfloat16"):
    t = sum(e - s for s, e, _ in fwd_ops + bwd_ops)
    if not fwd_ops or t <= 0:
        return None
    bound = (len(fwd_ops) * kernels.bound_s(fwd_work, dot_precision)
             + n_bwd * kernels.bound_s(bwd_work, dot_precision))
    return 100.0 * bound / t


def k3_roofline(r):
    """The selective scan's bound over its device time, forward and
    backward, at the cell's microbatch."""
    if r.trace is None:
        return None
    z = lm_dims(r.config["model"])
    fwd = r.trace.kernels("selective_scan_fwd")
    bwd = r.trace.kernels("selective_scan_bwd", "sum_parts_kernel")
    n_bwd = len(r.trace.kernels("selective_scan_bwd_kernel"))
    shape = (_microbatch(r), r.mix["seq_len"], z["di"], z["n"], 2)
    return _share(r, fwd, bwd, n_bwd, kernels.scan(*shape), kernels.scan_bwd(*shape))


def k2_roofline(r):
    """Flash attention's bound over its device time, forward and backward,
    at the cell's microbatch."""
    if r.trace is None:
        return None
    z = lm_dims(r.config["model"])
    fwd = r.trace.kernels("flash_fwd")
    bwd = r.trace.kernels("attn_bwd", "gqa_sum_kernel")
    n_bwd = len(r.trace.kernels("attn_bwd_dot_kernel"))
    s = r.mix["seq_len"]
    shape = (_microbatch(r), z["h"], z["k"], s, s, z["hd"], True, z["window"], 2)
    return _share(r, fwd, bwd, n_bwd, kernels.attention(*shape),
                  kernels.attention_bwd(*shape))

