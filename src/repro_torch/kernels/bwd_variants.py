"""Time variants of the backward kernels on the card, in rounds: the
selective scan's backward (K3) at every plan its code takes, the bf16
flash-attention backward (K2) with each GQA group cut into every number of
chunks, and the RMSNorm backward (K1) at every register plan and grid.

    PYTHONPATH=src python -m repro_torch.kernels.bwd_variants \\
        [--kernels scan attention norm] [--out build/bwd_variants/table.json]

K3: a copy of ``csrc/selective_scan_bwd.cu`` with ``picked`` edited so that
every plan of 4 or more lanes a group that its code takes is instantiated
(``selective_scan.bwd_plan_fits``; with 2 lanes, a warp's 16 groups would
hold 16 steps of dB and dC partials a state in registers), compiled under
``build/bwd_variants/`` with ``_build.NVCC_FLAGS`` and each plan forced
through its C entry point: at hymba-1.5b's and falcon-mamba-7b's training
microbatches (``chip_smoke.py``'s ``SCAN_TRAIN``), at a batch of 1, where
fewer blocks than SMs hold the wider plans, and at hymba-1.5b's width with
N 8 and 4.  K2: the library ``_build`` builds from
``csrc/flash_attention_bwd.cu``, its C entry point called with every number
of chunks from 1 to the GQA group, at ``ATTN_TRAIN``'s shapes and at
qwen2-0.5b's with a batch of 1.  K1: a copy of ``csrc/rms_norm_bwd.cu``
with ``picked`` edited to instantiate 1, 2, 4 and 8 vectors a lane over 1,
2 and 4 warps a row, its C entry point called, at each of ``chip_smoke.py``'s
``NORM_TRAIN`` shapes (bf16), with every such plan that holds the row in the
fewest lanes' vectors, in blocks of 4 and 8 warps, 1-4 blocks an SM.

Each variant is first held against its plain version (``ref.
selective_scan_ref_bwd``, ``ref.attention_ref_bwd``: max |diff| / max(1,
max |plain|) within 3e-2 in bf16 and 1e-4 in f32) and against its own
second call, bit for bit, then timed as CUDA-event medians of CUDA-graph
replays, bf16, in three rounds.  Prints one line per variant and shape and
writes the table, with the picks of ``selective_scan.BWD_PLANS``,
``flash_attention.bwd_gqa_splits`` and ``rmsnorm.bwd_launch_shape``, as
JSON.  ``--kernels`` runs only the families named.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels.scan_variants import (_edit, finish_builds, graph_ms, scan_inputs,
                                               start_builds)

SCAN_SHAPES = {"hymba": (2, 2048, 3200, 16), "falcon": (2, 2048, 8192, 16),
               "hymba_b1": (1, 2048, 3200, 16), "falcon_b1": (1, 2048, 8192, 16),
               "hymba_n8": (2, 2048, 3200, 8), "hymba_n4": (2, 2048, 3200, 4)}
# S = 150: two chunks and a ragged third; DI = 200: a ragged last block.
SCAN_CHECK = [(2, 150, 200, n) for n in ss.STATES]
ATTN_SHAPES = {"hymba": (2, 25, 5, 2048, 2048, 64, True, 1024),
               "qwen2": (4, 14, 2, 2048, 2048, 64, True, 0),
               "qwen2_b1": (1, 14, 2, 2048, 2048, 64, True, 0)}
ATTN_CHECK = (2, 14, 2, 300, 260, 64, True, 0)
NORM_SHAPES = {"hymba": (4096, 1600), "qwen2": (8192, 896), "falcon": (4096, 4096)}
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
OUT_DIR = _build.BUILD_DIR.parent / "bwd_variants"
ROUNDS = 3


def scan_plans(n: int, dtype) -> list:
    """Every plan of 4 or more lanes the backward's code takes at N in
    ``dtype`` (the instantiated ones: their shared memory fits a block)."""
    return [(lanes, k) for lanes in (4, 8, 16) for k in (1, 2, 4)
            if ss.bwd_plan_fits(n, lanes, k)
            and ss.bwd_smem_bytes(n, lanes, k, dtype.itemsize) <= 227 * 1024]


def scan_entry(lib):
    fn = lib.selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scan_runner(fn, args, hck, dy, plan):
    """A call of the scan's backward entry ``fn`` at ``plan`` (lanes,
    per_lane), outputs and partials allocated once, as the wrapper does."""
    u, dt, a, b, c, d = args
    bsz, s, di = u.shape
    n = a.shape[1]
    blocks = -(-di // ss.block_channels(*plan))
    out = [torch.empty_like(t) for t in (u, dt, a, b, c, d)]  # du, ddt, da, db, dc, dd
    f32 = dict(dtype=torch.float32, device=u.device)
    parts = [torch.empty((blocks, bsz, s, n), **f32), torch.empty((blocks, bsz, s, n), **f32),
             torch.empty((bsz, di, n), **f32), torch.empty((bsz, di), **f32)]
    tensors = (u, dt, a, b, c, d, hck, dy, *out, *parts)  # held as long as the call
    vec = ss.bwd_launch_plan(bsz, s, di, n, u.dtype).vec
    extra = [bsz, s, di, n, plan[0], plan[1], int(vec), int(u.dtype == torch.bfloat16)]

    def call():
        err = fn(*(t.data_ptr() for t in tensors), *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"selective_scan_bwd plan {plan} launch failed ({err})")
        return tuple(out)
    return call


def attn_inputs(shape, dtype, seed=11):
    b, h, kh, sq, sk, hd, causal, window = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(sh, generator=g, device="cuda").to(dtype)
                   for sh in ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd), (b, h, sq, hd)))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, with_lse=True)
    return q, k, v, o, lse, do


def attn_runner(inputs, causal, window, splits):
    """A call of the bf16 attention backward's entry point with the GQA group
    cut into ``splits`` chunks, scratch allocated once, as the wrapper does."""
    fn, _ = fa._bwd_kernel()
    q, k, v, o, lse, do = inputs
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, splits, b * kh, sk, hd), dtype=torch.float32, device=q.device)
            if splits > 1 else None)

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if part is None else part.data_ptr(), b, h, kh, sq, sk, hd, int(causal),
                 int(window), splits, 1, 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd splits {splits} launch failed ({err})")
        return dq, dk, dv
    return call


def norm_plans(d: int, dtype) -> list:
    """(per_lane, split) of the register path whose lanes hold a row of d
    elements of ``dtype`` in the fewest vectors: 8 vectors a lane and the
    plans ``rmsnorm.BWD_PLANS`` names among them."""
    nvec = d // (16 // dtype.itemsize)
    fits = [(k, s) for k in (1, 2, 4, 8) for s in (1, 2, 4) if 32 * s * k >= nvec]
    least = min(32 * s * k for k, s in fits)
    return [(k, s) for k, s in fits if 32 * s * k == least]


def norm_entry(lib):
    fn = lib.rms_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def norm_runner(fn, x, scale, dy, per_lane, split, warps, blocks):
    """A call of the RMSNorm backward's entry ``fn`` at a register plan and
    grid, outputs and partial rows allocated once, as the wrapper does."""
    rows, d = x.shape
    dx, ds = torch.empty_like(x), torch.empty_like(scale)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)

    def call():
        err = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
                 ds.data_ptr(), rows, d, int(x.dtype == torch.bfloat16),
                 int(scale.dtype == torch.bfloat16), 1, per_lane, split, warps, blocks, 1e-6,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rms_norm_bwd {(per_lane, split, warps, blocks)} launch "
                               f"failed ({err})")
        return dx, ds
    return call


def held(call, want, dtype) -> float:
    """max |diff| / max(1, max |want|) of ``call``'s gradients; raises if
    they disagree beyond ``TOL`` or a second call differs in any bit."""
    got = [t.clone() for t in call()]
    again = call()
    torch.cuda.synchronize()
    err = max((g.float() - w.float()).abs().max().item() / max(1.0, w.float().abs().max().item())
              for g, w in zip(got, want))
    if not math.isfinite(err) or err > TOL[dtype]:
        raise AssertionError(f"disagrees with the plain version: {err:.3e}")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("two calls differ")
    return err


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=OUT_DIR / "table.json")
    parser.add_argument("--kernels", nargs="+", choices=("scan", "attention", "norm"),
                        default=("scan", "attention", "norm"))
    opts = parser.parse_args()
    run = set(opts.kernels)
    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[variants] {card}; {sms} SMs; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    sources = {}
    if "scan" in run:
        sources["scan_bwd"] = (_edit((_build.CSRC / "selective_scan_bwd.cu").read_text(),
                                     [("  return picked(N, L, K) && plan_fits(N, L, K) &&",
                                       "  return L >= 4 && plan_fits(N, L, K) &&")]), [])
    if "norm" in run:
        sources["norm_bwd"] = (_edit((_build.CSRC / "rms_norm_bwd.cu").read_text(),
                                     [("{ return kSplit == 1 ? kV <= 4 : kV == 4; }",
                                       "{ return kV <= 8 && kSplit <= 4; }")]), [])
    libs = finish_builds(start_builds(sources, OUT_DIR))
    scan_fn = scan_entry(libs["scan_bwd"]) if "scan" in run else None

    def scan_cases(shape, dtype):
        args = scan_inputs(shape, dtype)
        dy = torch.randn(args[0].shape, generator=torch.Generator(device="cuda").manual_seed(3),
                         device="cuda")
        hck = ss.selective_scan_fwd(*args, checkpoints=True)[2]
        return args, dy, {plan: scan_runner(scan_fn, args, hck, dy, plan)
                          for plan in scan_plans(shape[3], dtype)}

    worst, failed = {}, {}

    def check(key, call, want, dtype) -> bool:
        try:
            worst[key] = max(worst.get(key, 0.0), held(call, want, dtype))
        except (AssertionError, RuntimeError) as e:
            failed[key] = str(e)
            print(f"[variants] FAIL {key}: {e}", flush=True)
        return key not in failed

    bad = set()  # (N, plan) that failed at a check shape: not timed
    for shape in SCAN_CHECK if "scan" in run else ():
        for dtype in TOL:
            args, dy, calls = scan_cases(shape, dtype)
            want = ref.selective_scan_ref_bwd(*args, dy)
            for plan, call in calls.items():
                if not check(f"scan {shape} L{plan[0]}_K{plan[1]} {str(dtype)[6:]}", call,
                             want, dtype):
                    bad.add((shape[3], plan))
    if "attention" in run:
        inputs = attn_inputs(ATTN_CHECK, torch.bfloat16)  # the tensor-core kernels: bf16 alone
        want = ref.attention_ref_bwd(*inputs[:3], inputs[5], causal=ATTN_CHECK[6],
                                     window=ATTN_CHECK[7])
        for splits in range(1, ATTN_CHECK[1] // ATTN_CHECK[2] + 1):
            check(f"attention {ATTN_CHECK} splits {splits}",
                  attn_runner(inputs, ATTN_CHECK[6], ATTN_CHECK[7], splits), want,
                  torch.bfloat16)
    print(f"[variants] max |diff| / max |plain| at the check shapes: {worst}", flush=True)

    cases = {}
    for label, shape in SCAN_SHAPES.items() if "scan" in run else ():
        args, dy, calls = scan_cases(shape, torch.bfloat16)
        want = ref.selective_scan_ref_bwd(*args, dy)
        for plan, call in calls.items():
            name = f"scan {label} L{plan[0]}_K{plan[1]}"
            if (shape[3], plan) not in bad and check(name, call, want, torch.bfloat16):
                cases[name] = (call, f"scan {label}", shape, plan,
                               plan == ss.BWD_PLANS[shape[3]])
        del want
    for label, shape in ATTN_SHAPES.items() if "attention" in run else ():
        inputs = attn_inputs(shape, torch.bfloat16)
        want = ref.attention_ref_bwd(*inputs[:3], inputs[5], causal=shape[6], window=shape[7])
        pick = fa.bwd_gqa_splits(*shape[:5], shape[6], shape[7], sms=sms)
        for splits in range(1, shape[1] // shape[2] + 1):
            call = attn_runner(inputs, shape[6], shape[7], splits)
            name = f"attention {label} splits {splits}"
            if check(name, call, want, torch.bfloat16):
                cases[name] = (call, f"attention {label}", shape, splits, splits == pick)
        del want
    norm_fn = norm_entry(libs["norm_bwd"]) if "norm" in run else None
    for label, shape in NORM_SHAPES.items() if "norm" in run else ():
        rows, d = shape
        g = torch.Generator(device="cuda").manual_seed(7)
        x, scale, dy = (torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16)
                        for sh in (shape, (d,), shape))
        want = ref.rms_norm_ref_bwd(x, scale, dy, 1e-6)
        pick = tuple(rn.bwd_launch_shape(rows, d, x.dtype, sms=sms))[1:]
        grids = {(k, s, w, min(per_sm * sms, -(-rows // (w // s))))
                 for k, s in norm_plans(d, x.dtype) for w in (4, 8) if w % s == 0
                 for per_sm in (1, 2, 3, 4)}
        for plan in sorted(grids):
            name = f"norm {label} kV{plan[0]}_split{plan[1]}_warps{plan[2]}_blocks{plan[3]}"
            call = norm_runner(norm_fn, x, scale, dy, *plan)
            if check(name, call, want, torch.bfloat16):
                cases[name] = (call, f"norm {label}", shape, plan, plan == pick)
        del want
    torch.cuda.empty_cache()

    table = {name: {"shape": shape, "variant": variant, "picked": picked, "ms": [],
                    "max_rel_err": worst[name]}
             for name, (_, _, shape, variant, picked) in cases.items()}
    for round_ in range(ROUNDS):
        for name, (call, *_) in cases.items():
            ms = graph_ms(call)
            table[name]["ms"].append(ms)
            print(f"[variants] round {round_} {name}{' (picked)' * table[name]['picked']}: "
                  f"{ms:.4f} ms", flush=True)
    for row in table.values():
        row["median_ms"] = statistics.median(row["ms"])
    by_group = {}
    for name, (_, group, *_) in cases.items():
        row = table[name]
        by_group.setdefault(group, []).append((row["median_ms"], row["variant"], row["picked"]))
    for group, rows in by_group.items():
        print(f"[variants] {group}, median ms, fastest first (* picked): "
              + ", ".join(f"{v} {ms:.4f}{'*' * p}" for ms, v, p in sorted(rows)), flush=True)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"card": card, "sms": sms, "variants": table,
                                    "check_max_rel_err": worst, "failed": failed}, indent=1))
    print(f"[variants] failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
