"""Time variants of the selective-scan kernel on the card, in turns, at the
serving shapes of hymba-1.5b and falcon-mamba-7b.

    PYTHONPATH=src python -m repro_torch.kernels.scan_variants \\
        [--out build/scan_variants/table.json]

Variants, each an edited copy of a source compiled under
``build/scan_variants/`` with ``_build.NVCC_FLAGS`` and called through its C
entry point with ``ctypes``:
  - the current kernel (``csrc/selective_scan.cu``) with every plan its code
    takes instantiated (``selective_scan.plan_fits``: L lanes sharing K
    channels), each plan forced, at the serving shapes and at hymba-1.5b's
    and falcon-mamba-7b's with smaller batches, where the grid of
    ``launch_plan``'s first plan does not fill the card;
  - the current source with other chunks of steps (``kChunk``) and other
    numbers of elements a lane unrolled in the step loop
    (``kUnrollElems``), each at the plans it instantiates
    (``selective_scan.PLANS``); and, at
    ``launch_plan``'s plan and timed only (their output is wrong), without
    its exps (a multiply instead), without writing y (so without y's sums
    and reduce-scatter), and without staging any chunk after the first;
  - the earlier one-thread-per-channel kernel
    (``baselines/selective_scan_per_channel.cu``) as it is; with y's serial
    chain of N FMAs split into 4 independent partial sums; with 32-thread
    blocks instead of 128; and with its exps replaced by a multiply (timed
    only).

Each variant is first held against ``ref.selective_scan_ref`` (bf16 within
5e-2, f32 within 1e-4) except the timing-only ones, then timed as CUDA-event
medians of CUDA-graph replays, bf16, in two rounds.  Prints one line per
variant and shape, and writes the table as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import selective_scan as ss

SHAPES = {"hymba": (4, 1536, 3200, 16), "falcon": (4, 512, 8192, 16)}
# Batches whose grid at launch_plan's first plan has fewer blocks than SMs:
# only the plans of the current kernel are timed there.
SMALL_BATCHES = {"hymba_b1": (1, 1536, 3200, 16), "hymba_b2": (2, 1536, 3200, 16),
                 "falcon_b1": (1, 512, 8192, 16)}
CHECK_SHAPES = [(1, 100, 200, 16), (2, 50, 32, 4), (2, 64, 32, 8)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
OUT_DIR = _build.BUILD_DIR.parent / "scan_variants"
PER_CHANNEL = "selective_scan_per_channel"
SFU_PER_SM_CLK = 16


def start_builds(sources: dict, out_dir: Path = OUT_DIR) -> dict:
    """{name: (source text, extra nvcc flags)}: one nvcc per variant, all
    started at once, into ``out_dir``; ``finish_builds`` waits for them."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, defines) in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(source)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_builds(procs: dict) -> dict:
    t0 = time.perf_counter()
    libs = {}
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{report}")
        print(f"[variants] built {name} (+{time.perf_counter() - t0:.0f}s): "
              + " | ".join(f"{k}: {v}" for k, v in _build.ptxas_report(report)), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def current_entry(lib):
    fn = lib.selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def baseline_entry(lib):
    fn = lib.selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def runner(fn, args, plan=None):
    """A call of ``fn`` on ``args`` (outputs allocated once); ``plan``
    (lanes, per_lane) for the current entry point, None for the baseline."""
    u, dt, a, b, c, d = args
    bsz, s, di = u.shape
    n = a.shape[1]
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=u.device)
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=u.device)
    bf16 = int(u.dtype == torch.bfloat16)
    ptrs = [t.data_ptr() for t in (u, dt, a, b, c, d, y, h)]
    if plan is not None:
        ptrs.append(None)  # no h checkpoints: serving's call
        vec = ss.launch_plan(bsz, s, di, n, u.dtype).vec
        extra = [bsz, s, di, n, plan[0], plan[1], int(vec), bf16]
    else:
        extra = [bsz, s, di, n, bf16]

    def call():
        err = fn(*ptrs, *extra, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return y, h
    return call


def per_channel(args):
    """A call of the earlier one-thread-per-channel kernel on ``args`` (the
    arguments of ``selective_scan``), built with ``_build``."""
    lib = ctypes.CDLL(str(_build.build(PER_CHANNEL)))
    return runner(baseline_entry(lib), args)


def scan_inputs(shape, dtype, seed=7):
    b, s, di, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=g, device="cuda")

    u, bm, cm = randn(b, s, di), randn(b, s, n), randn(b, s, n)
    dt = torch.nn.functional.softplus(randn(b, s, di))
    a = -torch.exp(0.3 * randn(di, n))
    d = 1.0 + 0.1 * randn(di)
    return [u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype), d]


def graph_ms(fn, iters=20, repeats=5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def plans(n: int):
    return [(lanes, k) for lanes in (1, 2, 4, 8, 16) for k in (1, 2, 4)
            if ss.plan_fits(n, lanes, k)]


def split_chain(source: str) -> str:
    """The baseline with y's chain of N dependent FMAs as 4 partial sums."""
    edits = [
        ("      float acc = 0.f;\n", "      float acc[4] = {0.f, 0.f, 0.f, 0.f};\n"),
        ("        acc = fmaf(h[n], cs[j][n], acc);\n",
         "        acc[n % 4] = fmaf(h[n], cs[j][n], acc[n % 4]);\n"),
        ("fmaf(dsk, uc[j], acc)", "fmaf(dsk, uc[j], (acc[0] + acc[1]) + (acc[2] + acc[3]))"),
    ]
    return _edit(source, edits)


def every_plan(source: str) -> str:
    """The current source with every plan that fits instantiated, not only
    those ``launch_plan`` picks."""
    return _edit(source, [("  return picked(N, L, K) && plan_fits(N, L, K) &&",
                           "  return plan_fits(N, L, K) &&")])


def _edit(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"source does not hold {old!r} once")
        source = source.replace(old, new)
    return source


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=OUT_DIR / "table.json")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    clock_hz = float(card.split(",")[-1].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[variants] {card}; {sms} SMs; torch {torch.__version__}", flush=True)

    current = (_build.CSRC / "selective_scan.cu").read_text()
    old = _build.source(PER_CHANNEL).read_text()

    def all_plans(shape):
        return plans(shape[3])

    def picked(shape):
        return list(ss.PLANS[shape[3]])

    def the_plan(shape):
        p = ss.launch_plan(*shape, sms=sms)
        return [(p.lanes, p.per_lane)]

    def chunk(c, k):
        return _edit(current, [("kChunk = 64;", f"kChunk = {c};"),
                               ("kUnrollElems = 128;", f"kUnrollElems = {k};")])

    # name -> (source, plans to run at a shape (None: the baseline's entry
    # point), checked against the plain version, timed at the small batches)
    sources = {"": (every_plan(current), all_plans, True, True)}
    sources.update({f"unroll{k}": (chunk(64, k), picked, True, False) for k in (32, 64, 256)})
    sources.update({f"chunk{c}_unroll{k}": (chunk(c, k), picked, True, False)
                    for c, k in ((16, 128), (32, 128))})
    sources.update({
        "no_exp": (_edit(current, [("ex2(dtv[k] * a2[k][p])", "(dtv[k] * a2[k][p])")]),
                   the_plan, False, False),
        "no_y": (_edit(current, [("        store_row<K>(", "        if (seq < 0) store_row<K>(")]),
                 the_plan, False, False),
        "no_copy": (_edit(current, [("    issue(t0 + kChunk, s ^ 1);\n", "")]), the_plan,
                    False, False),
        "per_channel": (old, None, True, False),
        "per_channel_split_y_chain": (split_chain(old), None, True, False),
        "per_channel_32_thread_blocks": (_edit(old, [("kThreads = 128;", "kThreads = 32;")]),
                                         None, True, False),
        "per_channel_no_exp": (_edit(old, [("__expf(dtv * av[n])", "(dtv * av[n])")]), None,
                               False, False),
    })
    procs = start_builds({name: (v[0], []) for name, v in sources.items()})
    variants = {}
    for name, vlib in finish_builds(procs).items():
        _, which, checked, small = sources[name]
        entry = baseline_entry if which is None else current_entry
        variants[name] = (entry(vlib), which, checked, small)

    def cases(shape, small=False):
        """(name, entry, plan, checked) of every variant at ``shape``; only
        those timed at the small batches where ``small``."""
        for name, (fn, which, checked, at_small) in variants.items():
            if small and not at_small:
                continue
            if which is None:
                yield name, fn, None, checked
                continue
            for lanes, k in which(shape):
                yield f"{name} L{lanes}_K{k}".strip(), fn, (lanes, k), checked

    worst, failed = {}, set()
    for shape in CHECK_SHAPES + list(SHAPES.values()):
        for dtype in TOL:
            args = scan_inputs(shape, dtype)
            want = ref.selective_scan_ref(*args)
            for name, fn, plan, checked in cases(shape):
                if not checked or name in failed:
                    continue
                try:
                    got = runner(fn, args, plan)()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    print(f"[variants] FAIL {name} {shape} {dtype}: {e}", flush=True)
                    failed.add(name)
                    continue
                err = max((g - w).abs().max().item() for g, w in zip(got, want))
                worst[name] = max(worst.get(name, 0.0), err)
                if not all(torch.allclose(g, w, atol=TOL[dtype], rtol=TOL[dtype])
                           for g, w in zip(got, want)):
                    print(f"[variants] FAIL {name} {shape} {dtype}: max_abs_err {err:.3e}",
                          flush=True)
                    failed.add(name)
    print(f"[variants] max_abs_err against the plain version: {worst}; failed: "
          f"{sorted(failed)}", flush=True)

    table = {}
    timed = [(label, shape, False) for label, shape in SHAPES.items()] + \
        [(label, shape, True) for label, shape in SMALL_BATCHES.items()]
    for round_ in range(2):
        for label, shape, small in timed:
            args = scan_inputs(shape, torch.bfloat16)
            bound = shape[0] * shape[1] * shape[2] * shape[3] / (
                SFU_PER_SM_CLK * sms * clock_hz) * 1e3
            for name, fn, plan, _ in cases(shape, small):
                if name in failed:
                    continue
                ms = graph_ms(runner(fn, args, plan))
                row = table.setdefault(f"{label} {name}", {"ms": [], "plan": plan})
                row["ms"].append(ms)
                row["exp_bound_ms"] = bound
                row["clocks_per_step"] = ms * 1e-3 * clock_hz / shape[1]
                print(f"[variants] round {round_} {label} {shape} {name} plan {plan}: "
                      f"{ms:.4f} ms ({ms / bound:.2f}x the exp bound {bound:.4f}; "
                      f"{row['clocks_per_step']:.0f} clocks a step)", flush=True)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"card": card, "variants": table,
                                    "max_abs_err": worst, "failed": sorted(failed)},
                                   indent=1))
    print(f"[variants] plans launch_plan picks: "
          f"{ {k: ss.launch_plan(*v, sms=sms) for k, v in (SHAPES | SMALL_BATCHES).items()} }",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
