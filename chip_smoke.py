#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build   — compile the hand-written kernel from ``src/repro_torch/
               kernels/csrc`` with nvcc;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card: the shape sweep of ``tests/test_kernels.py`` in f32 and
               bf16, plus the shape the serving path gives it;
  3. small   — qwen2-0.5b at ``reduced()`` in f32: the card's engine
               (through the kernel) against the CPU engine (plain version);
  4. serve   — qwen2-0.5b at full width in bf16, random weights from a seed:
               ``ServeEngine(attn_impl="pallas").generate`` for 4 prompts of
               512 tokens and 32 new tokens; the kernel must be launched once
               per layer per prefill, tokens must repeat, the prefill
               logits must agree with ``attn_impl="ref"`` while planted
               attention faults must not, and the default ``"auto"`` must
               take the kernel too;
  5. report  — a ``{"kernels": [...]}`` JSON line (times are CUDA-event
               medians of CUDA-graph replays at the serving shape), the
               card's name and power limit, and last the
               ``{"ok": true, "device": ...}`` line.

Exits non-zero and prints no result when there is no card or a phase fails.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate.
PEAK_BF16_FLOP_S = 989e12
HBM_BYTE_S = 3.35e12

ARCH = "qwen2-0.5b"
BATCH, PROMPT, GEN = 4, 512, 32

# Kernel vs plain version, as in tests/test_kernels.py:35.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SWEEP = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 2, 1, 96, 96, 16, False, 0),
    (1, 4, 2, 128, 128, 32, True, 32),
    (1, 2, 2, 80, 112, 32, False, 0),
]
# The shape prefill gives the kernel: B=4, H=14, K=2, S=512, hd=64, causal.
SERVE_SHAPE = (BATCH, 14, 2, PROMPT, PROMPT, 64, True, 0)
# Prefill logits through the kernel vs through the plain version, full width
# in bf16.  The two attention outputs differ only by f32 summation order
# before the cast to bf16, so some elements land one bf16 ulp apart (<0.4%);
# 24 residual layers carry that to the logits, whose values are O(1) (std ~1
# at this init).  On an H100 the correct kernel reads 0.075 and the planted
# faults of ``planted_fault_diffs`` read 4.3-6.9; the limit sits between,
# near their geometric mean.
LOGIT_ATOL = 0.5
# Small f32 check, card kernel vs CPU plain version: a few f32 ulps per op.
SMALL_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, *, iters: int = 20, repeats: int = 7, warmup: int = 3) -> float:
    """Median over ``repeats`` of CUDA-event time per call, ``iters`` eager
    calls between two events, after ``warmup`` calls.  Where a call's device
    time is near its host cost this reads the host's launch rate."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, *, iters: int = 20, repeats: int = 7, warmup: int = 3) -> float:
    """Median over ``repeats`` of device time per call: ``iters`` calls of
    ``fn`` captured in one CUDA graph and replayed between two CUDA events,
    so the host's launch rate stays out of the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def host_ms(fn, *, repeats: int = 5) -> float:
    """Median wall time of ``fn`` ending in a device synchronise."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profiled_run(fn):
    torch.cuda.synchronize()
    with profiled() as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def device_time(run, wall_ms: float, calls: int) -> dict:
    """Device kernel time per call from a ``torch.profiler`` trace of
    ``run()`` (which returns the profiler), against the unprofiled wall
    time ``wall_ms`` of one call: one stream, so kernels do not overlap and
    their sum over the wall time is the device's busy share.  None where the
    trace holds no device time."""
    from torch.autograd import DeviceType

    # Device-side events only (kernels, copies): a host op's own device total
    # counts the kernels it launched a second time.
    events = [e for e in run().key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return e.self_device_time_total

    total_ms = sum(dev_us(e) for e in events) / 1e3 / calls
    top = sorted(events, key=dev_us, reverse=True)[:5]
    return {
        "device_ms": total_ms or None,
        "wall_ms": wall_ms,
        "busy_share": total_ms / wall_ms if total_ms else None,
        "top": [(e.key[:48], round(dev_us(e) / 1e3 / calls, 4)) for e in top
                if dev_us(e)],
    }


def attention_inputs(shape, dtype, seed=7):
    b, h, kh, sq, sk, hd, _, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd))]


def attention_bound(q, k, causal: bool, window: int):
    """Least time (ms) for attention on these inputs: the larger of the bytes
    (q, k, v read once, o written once) over HBM and the FLOPs of the
    unmasked score/value products over the bf16 tensor-core peak."""
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    flops = 4 * hd * int(ok.sum()) * b * h
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOP_S, nbytes / HBM_BYTE_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s")
    report = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
              if "registers" in ln or "spill" in ln]
    log("[build] ptxas: " + " | ".join(report))


def phase_kernels():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    worst = {}
    for shape in SWEEP + [SERVE_SHAPE]:
        dtypes = [torch.bfloat16] if shape == SERVE_SHAPE else list(TOL)
        for dtype in dtypes:
            q, k, v = attention_inputs(shape, dtype)
            causal, window = shape[6], shape[7]
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            ok = torch.allclose(out.float(), want.float(), atol=tol, rtol=tol)
            log(f"[kernels] flash_attention {shape} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
            if not ok or not math.isfinite(err):
                raise AssertionError(f"flash_attention disagrees at {shape} {dtype}")
            key = "serve" if shape == SERVE_SHAPE else str(dtype)[6:]
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def phase_small():
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(ARCH).reduced()
    params = lm.init_lm(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(2)
    for leaf in [params["final_norm"], *params["layers"].values()]:
        leaf.add_(0.05 * torch.randn(leaf.shape, generator=g))  # nonzero biases, scales
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    card = ServeEngine(cfg, params, max_len=49, attn_impl="pallas", device="cuda")
    host = ServeEngine(cfg, params, max_len=49, attn_impl="pallas", device="cpu")
    got, want = card.prefill(prompts)[0].cpu(), host.prefill(prompts)[0]
    err = (got - want).abs().max().item()
    toks, want_toks = card.generate(prompts, 8), host.generate(prompts, 8)
    log(f"[small] reduced f32 prefill logits card vs cpu: max_abs_err {err:.3e} "
        f"(tol {SMALL_TOL:g}); greedy tokens equal: {np.array_equal(toks, want_toks)}")
    if not err <= SMALL_TOL or not np.array_equal(toks, want_toks):
        raise AssertionError("reduced model on the card disagrees with the CPU")


def planted_fault_diffs(eng, prompts, ref_logits) -> dict:
    """Max abs prefill-logit difference from ``ref_logits`` when the kernel is
    fed a planted fault: no causal mask, scale 1/hd instead of 1/sqrt(hd),
    or each query head reading the other group's kv head.  The negative
    control of ``LOGIT_ATOL``."""
    from repro_torch.kernels import ops

    real = ops.flash_attention

    def faulty(fault):
        def attend(q, k, v, *, causal=True, window=0, **kw):
            if fault == "no_causal_mask":
                causal = False
            elif fault == "scale_1/hd":
                q = (q.float() / math.sqrt(q.shape[-1])).to(q.dtype)
            else:
                k, v = k.roll(1, dims=1).contiguous(), v.roll(1, dims=1).contiguous()
            return real(q, k, v, causal=causal, window=window, **kw)
        return attend

    diffs = {}
    try:
        for fault in ("no_causal_mask", "scale_1/hd", "wrong_kv_head"):
            ops.flash_attention = faulty(fault)
            got, _ = eng.prefill(prompts)
            diffs[fault] = (got - ref_logits).abs().max().item()
    finally:
        ops.flash_attention = real
    return diffs


def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] {ARCH} full width ({cfg.num_layers}L d={cfg.d_model} "
        f"h={cfg.num_heads} kv={cfg.num_kv_heads} vocab={cfg.vocab_size}) "
        f"{cfg.param_dtype}, init {time.perf_counter() - t0:.1f}s")
    max_len = PROMPT + GEN + 1
    eng = ServeEngine(cfg, params, max_len=max_len, attn_impl="pallas", device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)

    # The main path: counts set to 0 just before, read just after.
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    out = eng.generate(prompts, GEN)
    first_s = time.perf_counter() - t0
    launches = fa.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] generate {out.shape} first run {first_s * 1e3:.1f} ms; "
        f"flash_attention launches {launches} (want {cfg.num_layers})")
    if launches != cfg.num_layers:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"want {cfg.num_layers} (one per layer per prefill)")
    if out.shape != (BATCH, GEN) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens: shape {out.shape}")

    fa.launches = 0
    t0 = time.perf_counter()
    again = eng.generate(prompts, GEN)
    gen_s = time.perf_counter() - t0
    if fa.launches != cfg.num_layers or not np.array_equal(out, again):
        raise AssertionError("repeat run differs")

    logits, _ = eng.prefill(prompts)
    ref_eng = ServeEngine(cfg, eng.params, max_len=max_len, attn_impl="ref",
                          device="cuda")
    ref_logits, _ = ref_eng.prefill(prompts)
    diff = (logits - ref_logits).abs().max().item()
    agree = (eng.generate(prompts, GEN) == ref_eng.generate(prompts, GEN)).mean()
    log(f"[serve] prefill logits pallas vs ref: max_abs_diff {diff:.4f} "
        f"(tol {LOGIT_ATOL}); |logits| max {ref_logits.abs().max().item():.2f}; "
        f"greedy token agreement {agree:.3f}")
    if not torch.isfinite(logits).all() or not diff <= LOGIT_ATOL:
        raise AssertionError("prefill logits disagree with attn_impl='ref'")
    fault_diffs = planted_fault_diffs(eng, prompts, ref_logits)
    log(f"[serve] planted faults, prefill logits vs ref: max_abs_diff {fault_diffs} "
        f"(each must exceed tol {LOGIT_ATOL})")
    if not all(d > LOGIT_ATOL for d in fault_diffs.values()):
        raise AssertionError("the logit tolerance does not catch a planted fault")

    # The engine's default attn_impl ("auto") takes the kernel on the card.
    auto_eng = ServeEngine(cfg, eng.params, max_len=max_len, device="cuda")
    fa.launches = 0
    auto_logits, _ = auto_eng.prefill(prompts)
    log(f"[serve] attn_impl='auto' prefill: flash_attention launches {fa.launches}")
    if fa.launches != cfg.num_layers or not torch.equal(auto_logits, logits):
        raise AssertionError("attn_impl='auto' does not run the kernel on the card")

    prefill_ms = host_ms(lambda: eng.prefill(prompts))
    ref_prefill_ms = host_ms(lambda: ref_eng.prefill(prompts))

    def decode():
        _, cache = eng.prefill(prompts)
        tok = torch.zeros(BATCH, dtype=torch.long, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GEN):
            logits, cache = eng.step(cache, tok)
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / GEN

    decode_ms = statistics.median(decode() for _ in range(3))

    def decode_steps():
        _, cache = eng.prefill(prompts)
        torch.cuda.synchronize()
        with profiled() as prof:
            tok = torch.zeros(BATCH, dtype=torch.long, device="cuda")
            for _ in range(GEN):
                logits, cache = eng.step(cache, tok)
                tok = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
        return prof

    busy = {"prefill": device_time(lambda: profiled_run(lambda: eng.prefill(prompts)),
                                   prefill_ms, 1),
            "decode_step": device_time(decode_steps, decode_ms, GEN)}
    for name, b in busy.items():
        log(f"[serve] {name} device busy {b['device_ms']} ms of {b['wall_ms']:.3f} ms "
            f"wall (share {b['busy_share']}); top kernels {b['top']}")
    metrics = {
        "prefill_ms": prefill_ms, "prefill_ref_ms": ref_prefill_ms,
        "decode_ms_per_token": decode_ms,
        "generate_tokens_per_s": BATCH * GEN / gen_s,
        "generate_ms": gen_s * 1e3, "peak_mem_gib": peak_gib,
        "logit_max_abs_diff": diff, "greedy_agreement_vs_ref": float(agree),
        "prefill_device_busy_share": busy["prefill"]["busy_share"],
        "decode_device_busy_share": busy["decode_step"]["busy_share"],
    }
    log("[serve] " + json.dumps(metrics))
    return launches


def phase_report(launches: int, worst: dict) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    q, k, v = attention_inputs(SERVE_SHAPE, torch.bfloat16)
    causal, window = SERVE_SHAPE[6], SERVE_SHAPE[7]
    calls = {
        "kernel": lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
        "plain": lambda: ref.attention_ref(q, k, v, causal=causal, window=window),
        "library": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True),
    }
    # Reported: device time from CUDA-graph replays.  Logged beside it: the
    # same calls issued eagerly, which the host's launch rate can bound.
    graph = {name: graph_ms(fn) for name, fn in calls.items()}
    eager = {name: cuda_ms(fn) for name, fn in calls.items()}
    log(f"[report] flash_attention serving shape, ms per call: graph {graph}; "
        f"eager {eager}")
    kernel_ms, plain_ms, library_ms = graph["kernel"], graph["plain"], graph["library"]
    bound_ms, bound_by = attention_bound(q, k, causal, window)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "shape": "q [4,14,512,64] k/v [4,2,512,64] bf16 causal",
        "launches": launches,
        "max_abs_err": worst["serve"],
        "tolerance": TOL[torch.bfloat16],
        "sweep_max_abs_err": {"float32": worst["float32"], "bfloat16": worst["bfloat16"]},
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        card = gpu_name_and_limit()
        log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}")
        # Plain versions in full f32: no TF32 in matmuls or convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("[device] allow_tf32 = False (matmul and cudnn)")
        phase_build()
        worst = phase_kernels()
        phase_small()
        launches = phase_serve()
        row = phase_report(launches, worst)
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": [row]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
