#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, all run in order, each of which must pass:
  1. build   — compile every hand-written kernel under ``src/repro_torch/
               kernels/csrc`` with nvcc, one process per source, in parallel;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card: the shape sweeps of ``tests/test_kernels.py`` in f32 and
               bf16, the edges of the bf16 tensor-core attention kernel, plus
               the shapes the serving paths give it (the scan there in f32
               too);
  3. small   — qwen2-0.5b, hymba-1.5b and falcon-mamba-7b at ``reduced()``
               in f32: the card's engine (through the kernels) against the
               CPU engine (plain versions), the hymba ring cache wrapped; then
               qwen2-0.5b and hymba-1.5b at full width and 2 layers in bf16:
               prefill logits through the kernels against the plain versions,
               planted attention faults must land above the limit;
  4. serve   — each serving path at full width in bf16, random weights from
               seed 0, through ``ServeEngine.generate``: qwen2-0.5b (dense:
               K2, K1), hymba-1.5b (hybrid, full depth: K2, K3, K1) and
               falcon-mamba-7b (ssm: K3, K1).  Each path is one main run with
               the launch counts set to 0 just before and read just after;
               the counts must be exact, tokens must repeat, and the default
               ``"auto"`` engine must take every kernel too.  With the same
               weights in f32, prefill logits must agree with the all-plain
               engine while planted kernel faults must not; in bf16 the
               kernels must drift from the f32 run no further than twice
               what the plain versions drift;
  5. report  — a ``{"kernels": [...]}`` JSON line (times are CUDA-event
               medians of CUDA-graph replays at the serving shapes; the
               attention row adds its TFLOP/s, the share of computed scores
               the mask admits and the f32 kernel's time, the scan row the
               time of its earlier design (built from ``kernels/baselines/``
               and timed in the same run) and its f32 error, the norm row its
               decode-row times), the
               card's name and power limit, and last the
               ``{"ok": true, "device": ...}`` line.

Exits non-zero and prints no result when there is no card or a phase
fails.  Imports nothing of JAX and nothing of the JAX
package.
"""
from __future__ import annotations

import gc
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

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, f32 CUDA-core
# peak, HBM3 rate; special function units (exp2) per SM per clock and SMs.
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
HBM_BYTE_S = 3.35e12
SFU_PER_SM_CLK = 16
SMS = 132

# Kernel vs plain version, as in tests/test_kernels.py:35,60,72.
TOL = {
    "flash_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    "selective_scan": {torch.float32: 1e-4, torch.bfloat16: 5e-2},
    "rms_norm": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
}
ATTN_SWEEP = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 2, 1, 96, 96, 16, False, 0),
    (1, 4, 2, 128, 128, 32, True, 32),
    (1, 2, 2, 80, 112, 32, False, 0),
]
# Edges of the bf16 tensor-core kernel (64-row query tiles over 64-key
# tiles), as in tests/test_torch_cuda.py: ragged Sq/Sk and Sq != Sk, windows
# that start mid-tile, GQA groups 5 and 7, hd 16/32/128, one query tile.
ATTN_TC_EDGES = [
    (1, 2, 1, 100, 150, 64, True, 0),
    (1, 2, 2, 130, 70, 64, False, 0),
    (1, 4, 2, 300, 300, 64, True, 100),
    (1, 2, 1, 200, 230, 32, False, 37),
    (1, 10, 2, 128, 128, 64, True, 0),
    (1, 14, 2, 96, 96, 64, True, 0),
    (2, 2, 1, 128, 128, 16, True, 0),
    (1, 2, 1, 160, 200, 128, True, 70),
    (2, 3, 1, 40, 40, 64, True, 0),
]
# The shapes prefill gives the flash kernel: qwen2-0.5b (B=4, H=14, K=2,
# S=512, causal) and hymba-1.5b (B=4, H=25, K=5, S=1536, window 1024).
ATTN_QWEN = (4, 14, 2, 512, 512, 64, True, 0)
ATTN_HYMBA = (4, 25, 5, 1536, 1536, 64, True, 1024)
# (B, S, DI, N): tests/test_kernels.py:46-48, a ragged DI, and the serving
# shapes of hymba-1.5b and falcon-mamba-7b.
SCAN_SWEEP = [(2, 64, 32, 8), (1, 96, 64, 16), (2, 50, 32, 4), (1, 100, 200, 16)]
SCAN_HYMBA = (4, 1536, 3200, 16)
SCAN_FALCON = (4, 512, 8192, 16)
# (rows, d): tests/test_kernels.py:66, then the rows of the serving paths:
# prefill (batch x prompt) and decode (batch) for qwen2-0.5b (d=896),
# hymba-1.5b (d=1600) and falcon-mamba-7b (d=4096).
NORM_SWEEP = [(64, 128), (37, 256), (5, 64)]
NORM_HYMBA = (6144, 1600)
NORM_FALCON = (2048, 4096)
NORM_DECODE = [(4, 896), (4, 1600), (4, 4096)]
NORM_SERVE = [(2048, 896), NORM_HYMBA, NORM_FALCON] + NORM_DECODE

# Serving paths, each at full width and depth: (arch, batch, prompt, new tokens).
SERVE = [
    ("qwen2-0.5b", 4, 512, 32),
    ("hymba-1.5b", 4, 1536, 32),
    ("falcon-mamba-7b", 4, 512, 32),
]
# Prefill logits through the kernels vs through the plain versions, full
# width and depth, with the weights widened to f32 and the model run in f32.
# In bf16 the comparison cannot tell a fault from rounding: with random
# weights any two bf16 paths drift apart layer by layer, and on an H100
# hymba-1.5b's bf16 plain engine lands 2.55 from its f32 run at 32 layers,
# falcon-mamba-7b's 4.70 at 64 (PERF.md §6).  In f32 the kernels read
# 1.0e-3 (hymba) and 1.9e-3 (falcon) from the plain versions; the limit sits
# 5x above that and below every planted fault.
LOGIT_ATOL_F32 = 1e-2
# The bf16 engine through the kernels must not drift from the f32 plain
# engine by more than this multiple of the bf16 plain engine's own drift.
BF16_DRIFT_RATIO = 2.0
# Small f32 check, card kernels vs CPU plain versions: a few f32 ulps per op.
SMALL_TOL = 1e-4
# bf16 prefill logits through the kernels against the plain versions at full
# width and 2 layers, the serving batch and prompt: shallow enough that bf16
# rounding cannot hide a fault of the bf16 tensor-core attention kernel,
# which the f32 checks above do not run.  On an H100 the gap read 0.049
# (qwen2) and 0.038 (hymba), the planted attention faults 0.33-6.96; the
# limit sits 3x above the gap and 2x below the smallest fault (PERF.md §6).
SMALL_BF16 = [("qwen2-0.5b", 4, 512), ("hymba-1.5b", 4, 1536)]
SMALL_BF16_ATOL = 0.15


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def counters():
    from repro_torch.kernels import flash_attention, rmsnorm, selective_scan

    return {"flash_attention": flash_attention, "selective_scan": selective_scan,
            "rms_norm": rmsnorm}


def reset_counts():
    for mod in counters().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in counters().items()}


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
    top = sorted(events, key=dev_us, reverse=True)[:6]
    return {
        "device_ms": total_ms or None,
        "wall_ms": wall_ms,
        "busy_share": total_ms / wall_ms if total_ms else None,
        "top": [(e.key[:48], round(dev_us(e) / 1e3 / calls, 4)) for e in top
                if dev_us(e)],
    }


# ---------------------------------------------------------------------------
# Inputs and bounds
# ---------------------------------------------------------------------------


def attention_inputs(shape, dtype, seed=7):
    b, h, kh, sq, sk, hd, _, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd))]


def scan_inputs(shape, dtype, seed=7):
    """u, dt, a, b, c, d_skip as the Mamba block makes them: dt = softplus,
    a = -exp(.) < 0, working-dtype u/dt/b/c, f32 a and d_skip."""
    b, s, di, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=g, device="cuda")

    u, bm, cm = randn(b, s, di), randn(b, s, n), randn(b, s, n)
    dt = torch.nn.functional.softplus(randn(b, s, di))
    a = -torch.exp(0.3 * randn(di, n))
    d = 1.0 + 0.1 * randn(di)
    return [u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype), d]


def norm_inputs(shape, dtype, seed=7):
    rows, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    return x, (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)


def mask_ok(sq, sk, causal, window, device="cpu"):
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    return ok


def score_entries(shape) -> tuple:
    """(admitted, computed): the score entries the mask admits, and those the
    bf16 kernel computes (whole 64x64 tiles over each query tile's
    ``key_tile_range``), over all heads."""
    from repro_torch.kernels import flash_attention as fa

    b, h, _, sq, sk, _, causal, window = shape
    admitted = int(mask_ok(sq, sk, causal, window).sum())
    tiles = 0
    for q0 in range(0, sq, fa.BLOCK_Q):
        begin, end = fa.key_tile_range(q0, sq, sk, causal, window)
        tiles += -(-(end - begin) // fa.BLOCK_K)
    return admitted * b * h, tiles * fa.BLOCK_Q * fa.BLOCK_K * b * h


def attention_bound(q, k, causal: bool, window: int):
    """Least time (ms) for attention on these inputs: the larger of the bytes
    (q, k, v read once, o written once) over HBM and the FLOPs of the
    unmasked score/value products over the bf16 tensor-core peak."""
    b, h, sq, hd = q.shape
    flops = 4 * hd * int(mask_ok(sq, k.shape[2], causal, window).sum()) * b * h
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOP_S, nbytes / HBM_BYTE_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def scan_bound(u, a, clock_hz: float):
    """Least time (ms) for the selective scan on these inputs: the largest of
    the bytes (u, dt, B, C, a, d_skip read once; y and h_last written once
    in f32) over HBM, one exp per (b, t, d, n) over the special function
    units (16 per clock per SM at the card's maximum SM clock), and six f32
    operations per (b, t, d, n) (dt*a; decay*h + du*B; y += h*C) over the f32
    peak.  Returns (ms, 'bytes'|'operations', parts)."""
    b, s, di = u.shape
    n = a.shape[1]
    elems = b * s * di * n
    nbytes = (2 * u.numel() + 2 * b * s * n) * u.element_size() \
        + (a.numel() + di) * 4 + (u.numel() + b * di * n) * 4
    parts = {"bytes": nbytes / HBM_BYTE_S * 1e3,
             "exp": elems / (SFU_PER_SM_CLK * SMS * clock_hz) * 1e3,
             "f32_ops": 6 * elems / PEAK_F32_FLOP_S * 1e3}
    worst = max(parts, key=parts.get)
    return parts[worst], ("bytes" if worst == "bytes" else "operations"), parts


def norm_bound(x, scale):
    """Least time (ms) for RMSNorm: x read once, out written once, scale
    read once, over HBM (a few f32 operations per element are far below)."""
    nbytes = 2 * x.numel() * x.element_size() + scale.numel() * scale.element_size()
    return nbytes / HBM_BYTE_S * 1e3, "bytes"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    kernels = _build.names()
    if kernels != ["flash_attention", "rms_norm", "selective_scan"]:
        raise AssertionError(f"unexpected kernel set {kernels}")
    t0 = time.perf_counter()
    # the scan's earlier design too, built only to time the current one against
    libs = _build.build_all(kernels + ["selective_scan_per_channel"])
    log(f"[build] {len(libs)} kernel(s) in {time.perf_counter() - t0:.1f}s")
    for name, lib in libs.items():
        log(f"[build] {name}: {lib.name}; ptxas, per entry function:")
        for fn, info in _build.ptxas_report(lib.with_suffix(".log").read_text()):
            log(f"[build]   {fn}: {info}")
    log("[build] flash_attention bf16 dynamic shared memory per block: "
        + ", ".join(f"hd {hd}: {fa.tc_smem_bytes(hd)} B" for hd in fa.HEAD_DIMS))


def _agree(name, label, got, want, dtype) -> float:
    torch.cuda.synchronize()
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    tol = TOL[name][dtype]
    ok = all(torch.allclose(g.float(), w.float(), atol=tol, rtol=tol)
             for g, w in zip(got, want))
    log(f"[kernels] {name} {label} {str(dtype)[6:]}: max_abs_err {err:.3e} "
        f"(tol {tol:g}) {'ok' if ok and math.isfinite(err) else 'FAIL'}")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{name} disagrees with its plain version at {label} {dtype}")
    return err


def phase_kernels():
    """Returns {kernel: {"float32"|"bfloat16"|"serve": worst max abs err}}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import selective_scan as ss

    worst = {name: {} for name in TOL}

    def note(name, key, err):
        worst[name][key] = max(worst[name].get(key, 0.0), err)

    for shape in ATTN_SWEEP + ATTN_TC_EDGES + [ATTN_QWEN, ATTN_HYMBA]:
        serve = shape in (ATTN_QWEN, ATTN_HYMBA)
        bf16_only = serve or shape in ATTN_TC_EDGES
        for dtype in [torch.bfloat16] if bf16_only else list(TOL["flash_attention"]):
            q, k, v = attention_inputs(shape, dtype)
            causal, window = shape[6], shape[7]
            err = _agree("flash_attention", str(shape), [fa.flash_attention(
                q, k, v, causal=causal, window=window)], [ref.attention_ref(
                    q, k, v, causal=causal, window=window)], dtype)
            note("flash_attention", "serve" if serve else str(dtype)[6:], err)
    # K3 in both dtypes at every shape: in f32 the serving shapes check the
    # order of summation of the lanes' reduce-scatter at 1e-4.
    for shape in SCAN_SWEEP + [SCAN_HYMBA, SCAN_FALCON]:
        serve = shape in (SCAN_HYMBA, SCAN_FALCON)
        for dtype in TOL["selective_scan"]:
            args = scan_inputs(shape, dtype)
            err = _agree("selective_scan", str(shape), ss.selective_scan(*args),
                         ref.selective_scan_ref(*args), dtype)
            key = ("serve" if dtype == torch.bfloat16 else "serve_f32") if serve \
                else str(dtype)[6:]
            note("selective_scan", key, err)
    for shape in NORM_SWEEP + NORM_SERVE:
        serve = shape in NORM_SERVE
        for dtype in TOL["rms_norm"]:
            x, scale = norm_inputs(shape, dtype)
            # the sweep's scale is f32; a serving path's is in the param dtype
            scale = scale if serve else scale.float()
            err = _agree("rms_norm", str(shape), [rn.rms_norm(x, scale, eps=1e-6)],
                         [ref.rms_norm_ref(x, scale, 1e-6)], dtype)
            bf16_serve = serve and dtype == torch.bfloat16
            note("rms_norm", "serve" if bf16_serve else str(dtype)[6:], err)
    return worst


def phase_small():
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    impls = dict(attn_impl="pallas", ssm_impl="pallas", norm_impl="pallas")
    for arch in ("qwen2-0.5b", "hymba-1.5b", "falcon-mamba-7b"):
        cfg = get_config(arch).reduced()
        params = lm.init_lm(cfg, seed=1, device="cpu")
        g = torch.Generator().manual_seed(2)
        leaves = [params["final_norm"]]
        stack = [params["layers"]]
        while stack:
            for leaf in stack.pop().values():
                (stack if isinstance(leaf, dict) else leaves).append(leaf)
        for leaf in leaves:  # nonzero biases and norm scales
            leaf.add_(0.05 * torch.randn(leaf.shape, generator=g))
        # 40 prompt tokens: past hymba's reduced window of 32, so the ring
        # cache wraps (max_len 49 > 32) and decode continues the ring.
        prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
        card = ServeEngine(cfg, params, max_len=49, device="cuda", **impls)
        host = ServeEngine(cfg, params, max_len=49, device="cpu", **impls)
        reset_counts()
        got = card.prefill(prompts)[0].cpu()
        counts = read_counts()
        want = host.prefill(prompts)[0]
        err = (got - want).abs().max().item()
        toks, want_toks = card.generate(prompts, 8), host.generate(prompts, 8)
        log(f"[small] {arch} reduced f32 (ring {card.spec.ring}) prefill logits card vs "
            f"cpu: max_abs_err {err:.3e} (tol {SMALL_TOL:g}); greedy tokens equal: "
            f"{np.array_equal(toks, want_toks)}; prefill launches {counts}")
        if not err <= SMALL_TOL or not np.array_equal(toks, want_toks):
            raise AssertionError(f"reduced {arch} on the card disagrees with the CPU")
    phase_small_bf16()


def phase_small_bf16():
    """``SMALL_BF16``'s models at full width and 2 layers in bf16: prefill
    logits through the kernels within ``SMALL_BF16_ATOL`` of the plain
    versions', every planted attention fault beyond it."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    for arch, batch, prompt in SMALL_BF16:
        cfg = get_config(arch).replace(num_layers=2)
        params = lm.init_lm(cfg, seed=0, device="cuda")
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
        kernels = ServeEngine(cfg, params, max_len=prompt + 1, device="cuda",
                              attn_impl="pallas", ssm_impl="pallas", norm_impl="pallas")
        plain = ServeEngine(cfg, params, max_len=prompt + 1, device="cuda",
                            attn_impl="ref", ssm_impl="ref", norm_impl="ref")
        reset_counts()
        got = kernels.prefill(prompts)[0]
        counts = read_counts()
        want = plain.prefill(prompts)[0]
        err = (got.float() - want.float()).abs().max().item()
        faults = planted_fault_diffs(kernels, prompts, want.float(), cfg,
                                     only="flash_attention")
        want_counts = expected_counts(cfg, 0)
        log(f"[small] {arch} full width, 2 layers, bf16, batch {batch} prompt {prompt}: "
            f"prefill logits kernels vs plain max_abs_err {err:.4f} (tol "
            f"{SMALL_BF16_ATOL}); planted attention faults "
            f"{ {k: round(v, 4) for k, v in faults.items()} } (each must exceed the tol); "
            f"|logits| max {want.float().abs().max().item():.2f}; launches {counts}")
        if any(counts[k] != want_counts[k] for k in counts):
            raise AssertionError(f"{arch}: launches {counts}, want {want_counts}")
        if not torch.isfinite(got).all() or not err <= SMALL_BF16_ATOL:
            raise AssertionError(f"{arch}: 2-layer bf16 prefill logits disagree")
        if not all(d > SMALL_BF16_ATOL for d in faults.values()):
            raise AssertionError(f"{arch}: the 2-layer bf16 limit misses a planted fault")
        del kernels, plain, params
        gc.collect()
        torch.cuda.empty_cache()


def expected_counts(cfg, gen: int) -> dict:
    """Kernel launches of one ``generate``: K2 and K3 once per layer in
    prefill; K1 per layer (ln1, ln2; hybrid also ln_ssm; ssm ln1 only) plus
    the final norm, in prefill and in every decode step."""
    layers = cfg.num_layers
    attn = cfg.family != "ssm"
    scan = cfg.family in ("ssm", "hybrid")
    norms = {"dense": 2, "hybrid": 3, "ssm": 1}[cfg.family] * layers + 1
    return {"flash_attention": layers if attn else 0,
            "selective_scan": layers if scan else 0,
            "rms_norm": norms * (1 + gen), "rms_norm_per_pass": norms}


def planted_fault_diffs(eng, prompts, ref_logits, cfg, only: str | None = None) -> dict:
    """Max abs prefill-logit difference from ``ref_logits`` when a kernel is
    fed a planted fault (``only``: the faults of that kernel alone).  The
    negative control of the logit tolerance.
    Attention: no causal mask, scale 1/hd instead of 1/sqrt(hd), each query
    head reading the next kv head.  Scan: no D*u skip, exp(A) in place of
    exp(dt*A), B and C swapped.  Norm: scale in place of 1 + scale."""
    from repro_torch.kernels import ops

    real = {"flash_attention": ops.flash_attention,
            "selective_scan": ops.selective_scan, "rms_norm": ops.rms_norm}

    def attend(fault):
        def run(q, k, v, *, causal=True, window=0, **kw):
            if fault == "no_causal_mask":
                causal, window = False, 0
            elif fault == "scale_1/hd":
                q = (q.float() / math.sqrt(q.shape[-1])).to(q.dtype)
            else:
                k, v = k.roll(1, dims=1).contiguous(), v.roll(1, dims=1).contiguous()
            return real["flash_attention"](q, k, v, causal=causal, window=window, **kw)
        return run

    def scan(fault):
        def run(u, dt, a, b, c, d_skip, **kw):
            if fault == "no_D_skip":
                return real["selective_scan"](u, dt, a, b, c, torch.zeros_like(d_skip), **kw)
            if fault == "exp(A)_not_exp(dt*A)":
                # exp(1*A) h + 1*(dt u) B, then D u restored outside
                du = (dt.float() * u.float()).to(u.dtype)
                y, h = real["selective_scan"](du, torch.ones_like(dt), a, b, c, d_skip, **kw)
                return y + d_skip * (u.float() - du.float()), h
            return real["selective_scan"](u, dt, a, c, b, d_skip, **kw)
        return run

    def norm(x, scale, **kw):
        return real["rms_norm"](x, scale - 1, **kw)

    faults = {}
    if cfg.family != "ssm":
        faults.update({f: ("flash_attention", attend(f)) for f in
                       ("no_causal_mask", "scale_1/hd", "wrong_kv_head")})
    if cfg.family in ("ssm", "hybrid"):
        faults.update({f: ("selective_scan", scan(f)) for f in
                       ("no_D_skip", "exp(A)_not_exp(dt*A)", "B_C_swapped")})
    faults["norm_scale_not_1+scale"] = ("rms_norm", norm)
    if only:
        faults = {f: v for f, v in faults.items() if v[0] == only}
    diffs = {}
    try:
        for fault, (name, fn) in faults.items():
            setattr(ops, name, fn)
            got, _ = eng.prefill(prompts)
            setattr(ops, name, real[name])
            diffs[fault] = (got.float() - ref_logits).abs().max().item()
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    return diffs


def serve_model(arch, batch, prompt, gen) -> dict:
    """One serving path at full width and depth; returns its main-run launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {arch} full width and depth ({cfg.family}, {cfg.num_layers}L "
        f"d={cfg.d_model} h={cfg.num_heads} kv={cfg.num_kv_heads} DI={cfg.ssm_d_inner} "
        f"N={cfg.ssm_state} window={cfg.sliding_window} vocab={cfg.vocab_size}) "
        f"{cfg.param_dtype}, {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f}s; batch {batch}, prompt {prompt}, {gen} new tokens")
    max_len = prompt + gen + 1
    kernels = dict(attn_impl="pallas", ssm_impl="pallas", norm_impl="pallas")
    eng = ServeEngine(cfg, params, max_len=max_len, device="cuda", **kernels)
    if eng.spec.ring:
        log(f"[serve] {arch} ring KV cache of {eng.spec.cache_len} positions, prefill "
            f"roll shift {prompt % eng.spec.cache_len}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    want = expected_counts(cfg, gen)

    # The main path: counts set to 0 just before, read just after.
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, gen)
    first_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] {arch} generate {out.shape} first run {first_s * 1e3:.1f} ms; "
        f"launches {counts} (want {want})")
    if any(counts[k] != want[k] for k in counts):
        raise AssertionError(f"{arch}: launches {counts}, want {want}")
    if out.shape != (batch, gen) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens: shape {out.shape}")

    reset_counts()
    logits, cache = eng.prefill(prompts)
    prefill_counts = read_counts()
    reset_counts()
    eng.step(cache, torch.argmax(logits, dim=-1))
    step_counts = read_counts()
    log(f"[serve] {arch} launches per prefill {prefill_counts}, per decode step "
        f"{step_counts}")
    if prefill_counts["rms_norm"] != want["rms_norm_per_pass"] or \
            step_counts != {"flash_attention": 0, "selective_scan": 0,
                            "rms_norm": want["rms_norm_per_pass"]}:
        raise AssertionError(f"{arch}: per-pass launches differ from {want}")

    reset_counts()
    t0 = time.perf_counter()
    again = eng.generate(prompts, gen)
    gen_s = time.perf_counter() - t0
    if read_counts() != counts or not np.array_equal(out, again):
        raise AssertionError(f"{arch}: repeat run differs")

    plain = dict(attn_impl="ref", ssm_impl="ref", norm_impl="ref")
    ref_eng = ServeEngine(cfg, eng.params, max_len=max_len, device="cuda", **plain)
    reset_counts()
    ref_logits, _ = ref_eng.prefill(prompts)
    if any(read_counts().values()):
        raise AssertionError(f"{arch}: the all-plain engine launched a kernel")
    diff = (logits - ref_logits).abs().max().item()
    agree = (out == ref_eng.generate(prompts, gen)).mean()
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: prefill logits are not finite")

    # The same weights in f32: kernels against plain versions, then planted
    # faults, then how far each bf16 engine drifts from the f32 plain run.
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params32 = _to_f32(eng.params)
    eng32 = ServeEngine(cfg32, params32, max_len=max_len, device="cuda", **kernels)
    ref32 = ServeEngine(cfg32, params32, max_len=max_len, device="cuda", **plain)
    logits32, ref_logits32 = eng32.prefill(prompts)[0], ref32.prefill(prompts)[0]
    diff32 = (logits32 - ref_logits32).abs().max().item()
    drift = (logits.float() - ref_logits32).abs().max().item()
    plain_drift = (ref_logits.float() - ref_logits32).abs().max().item()
    tol = LOGIT_ATOL_F32
    log(f"[serve] {arch} prefill logits kernels vs plain: f32 max_abs_diff {diff32:.3e} "
        f"(tol {tol}); bf16 max_abs_diff {diff:.4f}; bf16 drift from the f32 plain run: "
        f"kernels {drift:.4f}, plain {plain_drift:.4f} (ratio limit {BF16_DRIFT_RATIO}); "
        f"|logits| max {ref_logits.abs().max().item():.2f}; bf16 greedy token agreement "
        f"{agree:.3f}")
    if not diff32 <= tol:
        raise AssertionError(f"{arch}: f32 prefill logits disagree with the plain engine")
    if not drift <= BF16_DRIFT_RATIO * plain_drift:
        raise AssertionError(f"{arch}: the bf16 kernels drift further than the plain path")
    fault_diffs = planted_fault_diffs(eng32, prompts, ref_logits32, cfg)
    log(f"[serve] {arch} planted faults, f32 prefill logits vs plain: max_abs_diff "
        f"{ {k: round(v, 4) for k, v in fault_diffs.items()} } (each must exceed tol {tol})")
    if not all(d > tol for d in fault_diffs.values()):
        raise AssertionError(f"{arch}: the logit tolerance does not catch a planted fault")
    del eng32, ref32, params32
    gc.collect()
    torch.cuda.empty_cache()

    # The engine's defaults ("auto") take every kernel on the card.
    auto_eng = ServeEngine(cfg, eng.params, max_len=max_len, device="cuda")
    reset_counts()
    auto_logits, _ = auto_eng.prefill(prompts)
    auto_counts = read_counts()
    log(f"[serve] {arch} default 'auto' prefill launches {auto_counts}")
    if auto_counts != prefill_counts or not torch.equal(auto_logits, logits):
        raise AssertionError(f"{arch}: 'auto' does not run the kernels on the card")

    prefill_ms = host_ms(lambda: eng.prefill(prompts), repeats=3)
    ref_prefill_ms = host_ms(lambda: ref_eng.prefill(prompts), repeats=3)

    def decode(profile=False):
        _, cache = eng.prefill(prompts)
        tok = torch.zeros(batch, dtype=torch.long, device="cuda")
        torch.cuda.synchronize()
        prof = profiled() if profile else None
        if prof:
            prof.__enter__()
        t0 = time.perf_counter()
        for _ in range(gen):
            logits, cache = eng.step(cache, tok)
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / gen
        if prof:
            prof.__exit__(None, None, None)
            return prof
        return ms

    decode_ms = statistics.median(decode() for _ in range(3))
    busy = {"prefill": device_time(lambda: profiled_run(lambda: eng.prefill(prompts)),
                                   prefill_ms, 1),
            "decode_step": device_time(lambda: decode(profile=True), decode_ms, gen)}
    for name, b in busy.items():
        log(f"[serve] {arch} {name} device busy {b['device_ms']} ms of {b['wall_ms']:.3f} "
            f"ms wall (share {b['busy_share']}); top kernels {b['top']}")
    metrics = {
        "arch": arch, "layers": cfg.num_layers,
        "batch": batch, "prompt": prompt, "gen": gen,
        "prefill_ms": prefill_ms, "prefill_plain_ms": ref_prefill_ms,
        "decode_ms_per_token": decode_ms,
        "generate_tokens_per_s": batch * gen / gen_s,
        "generate_ms": gen_s * 1e3, "peak_mem_gib": peak_gib,
        "logit_f32_max_abs_diff": diff32, "logit_f32_tol": tol,
        "logit_bf16_max_abs_diff": diff, "bf16_drift_kernels": drift,
        "bf16_drift_plain": plain_drift,
        "planted_fault_min_diff": min(fault_diffs.values()),
        "greedy_agreement_vs_plain": float(agree),
        "prefill_device_ms": busy["prefill"]["device_ms"],
        "decode_device_ms": busy["decode_step"]["device_ms"],
        "prefill_device_busy_share": busy["prefill"]["busy_share"],
        "decode_device_busy_share": busy["decode_step"]["busy_share"],
        "launches": counts,
    }
    log("[serve] " + json.dumps(metrics))
    del eng, ref_eng, auto_eng, params, cache, logits, ref_logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _to_f32(tree):
    return {k: _to_f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def phase_serve() -> dict:
    """Returns {kernel: {arch: launches of that path's main run}}."""
    launches = {name: {} for name in TOL}
    for arch, batch, prompt, gen in SERVE:
        t0 = time.perf_counter()
        counts = serve_model(arch, batch, prompt, gen)
        for name, n in counts.items():
            launches[name][arch] = n
        log(f"[serve] {arch} phase {time.perf_counter() - t0:.1f}s")
    return launches


def time_calls(calls: dict, **kw) -> dict:
    """Graph-replay device ms per call of each entry (eager logged beside)."""
    graph = {name: graph_ms(fn, **kw) for name, fn in calls.items()}
    eager = {name: cuda_ms(fn, iters=kw.get("iters", 20)) for name, fn in calls.items()}
    return {"graph": graph, "eager": eager}


def phase_report(launches: dict, worst: dict) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import scan_variants
    from repro_torch.kernels import selective_scan as ss

    clock_hz = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []

    def attn_times(shape):
        q, k, v = attention_inputs(shape, torch.bfloat16)
        causal, window = shape[6], shape[7]
        mask = mask_ok(shape[3], shape[4], causal, window, "cuda")
        t = time_calls({
            "kernel": lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
            "plain": lambda: ref.attention_ref(q, k, v, causal=causal, window=window),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=None if window == 0 else mask,
                is_causal=causal and window == 0, enable_gqa=True),
        })
        bound_ms, bound_by = attention_bound(q, k, causal, window)
        admitted, computed = score_entries(shape)
        g = t["graph"]
        g["tflop_s"] = 4 * shape[5] * admitted / (g["kernel"] * 1e-3) / 1e12
        g["admitted_share"] = admitted / computed
        log(f"[report] flash_attention {shape} ms per call: {t}; bound {bound_ms:.4f} "
            f"({bound_by}); {g['tflop_s']:.1f} TFLOP/s of admitted scores; mask admits "
            f"{admitted} of {computed} computed scores ({g['admitted_share']:.4f})")
        return g, bound_ms, bound_by

    hy, hy_bound, hy_by = attn_times(ATTN_HYMBA)
    qw, qw_bound, qw_by = attn_times(ATTN_QWEN)
    q32, k32, v32 = attention_inputs(ATTN_QWEN, torch.float32)
    f32_ms = graph_ms(lambda: fa.flash_attention(q32, k32, v32, causal=True))
    log(f"[report] flash_attention {ATTN_QWEN} f32 (SIMT kernel) ms per call (graph): "
        f"{f32_ms:.4f}")
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "shape": "q [4,25,1536,64] k/v [4,5,1536,64] bf16 causal window 1024 (hymba-1.5b)",
        "launches": sum(launches["flash_attention"].values()),
        "launches_by_path": launches["flash_attention"],
        "max_abs_err": worst["flash_attention"]["serve"],
        "tolerance": TOL["flash_attention"][torch.bfloat16],
        "sweep_max_abs_err": {k: v for k, v in worst["flash_attention"].items() if k != "serve"},
        "ms": hy["kernel"], "kernel_ms": hy["kernel"], "plain_ms": hy["plain"],
        "bound_ms": hy_bound, "bound_by": hy_by, "library_ms": hy["library"],
        "tflop_s": hy["tflop_s"], "admitted_share": hy["admitted_share"],
        "qwen2_shape": {"shape": "q [4,14,512,64] k/v [4,2,512,64] bf16 causal",
                        "kernel_ms": qw["kernel"], "plain_ms": qw["plain"],
                        "bound_ms": qw_bound, "bound_by": qw_by,
                        "library_ms": qw["library"], "tflop_s": qw["tflop_s"],
                        "admitted_share": qw["admitted_share"],
                        "f32_simt_kernel_ms": f32_ms},
    })

    def scan_times(shape):
        args = scan_inputs(shape, torch.bfloat16)
        # the earlier one-thread-per-channel design, timed beside the kernel
        earlier = scan_variants.per_channel(args)
        err = max((g - w).abs().max().item()
                  for g, w in zip(earlier(), ref.selective_scan_ref(*args)))
        if err > TOL["selective_scan"][torch.bfloat16]:
            raise AssertionError(f"earlier scan kernel {shape}: max_abs_err {err:.3e}")
        g = time_calls({"kernel": lambda: ss.selective_scan(*args), "earlier": earlier})["graph"]
        # the plain version is ~7 launches per timestep: fewer calls per graph
        t = {**g, "plain": graph_ms(lambda: ref.selective_scan_ref(*args), iters=2, repeats=3,
                                    warmup=1)}
        bound_ms, bound_by, parts = scan_bound(args[0], args[2], clock_hz)
        log(f"[report] selective_scan {shape} bf16 ms per call: {t}; bound "
            f"{bound_ms:.4f} ({bound_by}; parts {parts}, max SM clock {clock_hz / 1e6:.0f} "
            f"MHz); {ss.launch_plan(*shape, sms=sms)}; earlier design's max_abs_err {err:.3e}")
        return t, bound_ms, bound_by

    sh, sh_bound, sh_by = scan_times(SCAN_HYMBA)
    sf, sf_bound, sf_by = scan_times(SCAN_FALCON)
    rows.append({
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:61",
        "shape": "u/dt [4,1536,3200] B/C [4,1536,16] bf16, a [3200,16] f32 (hymba-1.5b)",
        "launches": sum(launches["selective_scan"].values()),
        "launches_by_path": launches["selective_scan"],
        "max_abs_err": worst["selective_scan"]["serve"],
        "tolerance": TOL["selective_scan"][torch.bfloat16],
        "sweep_max_abs_err": {k: v for k, v in worst["selective_scan"].items()
                              if not k.startswith("serve")},
        "ms": sh["kernel"], "kernel_ms": sh["kernel"], "plain_ms": sh["plain"],
        "bound_ms": sh_bound, "bound_by": sh_by,
        "library_ms": None,  # no PyTorch call computes a selective scan
        "earlier_ms": sh["earlier"],
        "f32_max_abs_err": worst["selective_scan"]["serve_f32"],
        "f32_tolerance": TOL["selective_scan"][torch.float32],
        "falcon_shape": {"shape": "u/dt [4,512,8192] B/C [4,512,16] bf16",
                         "kernel_ms": sf["kernel"], "plain_ms": sf["plain"],
                         "bound_ms": sf_bound, "bound_by": sf_by, "library_ms": None,
                         "earlier_ms": sf["earlier"]},
    })

    def norm_times(shape):
        x, scale = norm_inputs(shape, torch.bfloat16)
        weight = 1 + scale  # precomputed outside the timed library call
        t = time_calls({
            "kernel": lambda: rn.rms_norm(x, scale, eps=1e-6),
            "plain": lambda: ref.rms_norm_ref(x, scale, 1e-6),
            "library": lambda: F.rms_norm(x, (shape[1],), weight=weight, eps=1e-6),
        })["graph"]
        bound_ms, bound_by = norm_bound(x, scale)
        log(f"[report] rms_norm {shape} bf16 ms per call (graph): {t}; bound "
            f"{bound_ms:.4f} ({bound_by}); {rn.launch_shape(*shape, x.dtype)}")
        return t, bound_ms, bound_by

    nh, nh_bound, nh_by = norm_times(NORM_HYMBA)
    nf, nf_bound, nf_by = norm_times(NORM_FALCON)
    decode = {}
    for shape in NORM_DECODE:
        t, bound_ms, _ = norm_times(shape)
        decode[f"{shape[0]}x{shape[1]}"] = {
            "kernel_ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound_ms,
            "library_ms": t["library"]}
    rows.append({
        "name": "rms_norm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rms_norm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:26",
        "shape": "x [6144,1600] bf16, scale [1600] bf16 (hymba-1.5b prefill)",
        "launches": sum(launches["rms_norm"].values()),
        "launches_by_path": launches["rms_norm"],
        "max_abs_err": worst["rms_norm"]["serve"],
        "tolerance": TOL["rms_norm"][torch.bfloat16],
        "sweep_max_abs_err": {k: v for k, v in worst["rms_norm"].items() if k != "serve"},
        "ms": nh["kernel"], "kernel_ms": nh["kernel"], "plain_ms": nh["plain"],
        "bound_ms": nh_bound, "bound_by": nh_by, "library_ms": nh["library"],
        "falcon_shape": {"shape": "x [2048,4096] bf16", "kernel_ms": nf["kernel"],
                         "plain_ms": nf["plain"], "bound_ms": nf_bound,
                         "bound_by": nf_by, "library_ms": nf["library"]},
        "decode_rows": decode,
    })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        card = nvidia_smi("name,power.limit")
        log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}")
        # Plain versions in full f32: no TF32 in matmuls or convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("[device] allow_tf32 = False (matmul and cudnn)")
        start = t0 = time.perf_counter()

        def done(phase):
            nonlocal t0
            log(f"[time] {phase} {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()

        phase_build()
        done("build")
        worst = phase_kernels()
        done("kernels")
        phase_small()
        done("small")
        launches = phase_serve()
        done("serve")
        rows = phase_report(launches, worst)
        done("report")
        log(f"[time] all phases {time.perf_counter() - start:.1f}s")
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
