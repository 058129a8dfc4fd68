"""Time the kernels of two checkouts of the port in turns, on one card.

    python -m repro_torch.kernels.fwd_turns --other PATH [--backward] [--out FILE]

``PATH`` is the ``src`` directory of another checkout (for example the
parent commit, unpacked with ``git archive`` into a git-ignored
directory).  Each turn runs in its own process, which builds and loads that
checkout's kernels, and times K2 (bf16, hymba-1.5b's and qwen2-0.5b's
prefill shapes), K3 (hymba-1.5b's and falcon-mamba-7b's) and K1
(hymba-1.5b's rows) as CUDA-event medians of CUDA-graph replays, on inputs
that do not require grad: serving's calls.  With ``--backward`` it times
the backward kernels instead, at the shapes a training microbatch gives
them (``chip_smoke.py``'s ``ATTN_TRAIN``: hymba-1.5b's and qwen2-0.5b's;
``SCAN_TRAIN``: hymba-1.5b's and falcon-mamba-7b's; ``NORM_TRAIN``: all
three), K2's and K3's from each checkout's own forward outputs (o and lse,
the checkpoints).  The turns go other, this,
this, other, other, this, so a drift of the card over the call falls on
both sides.  Prints one JSON line per turn and writes them all to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

__all__ = ["TURNS", "main"]

TURNS = ("other", "this", "this", "other", "other", "this")

_CHILD = r'''
import json, statistics, sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import flash_attention as fa, rmsnorm as rn, selective_scan as ss

def graph_ms(fn, iters=20, repeats=7):
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

gen = torch.Generator(device="cuda").manual_seed(7)
def randn(*shape):
    return torch.randn(shape, generator=gen, device="cuda")

out = {}
for name, (b, h, kh, s, w) in {"attn_hymba": (4, 25, 5, 1536, 1024),
                               "attn_qwen": (4, 14, 2, 512, 0)}.items():
    q, k, v = (randn(b, n, s, 64).bfloat16() for n in (h, kh, kh))
    out[name] = graph_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=w))
for name, (b, s, di, n) in {"scan_hymba": (4, 1536, 3200, 16),
                            "scan_falcon": (4, 512, 8192, 16)}.items():
    u, bm, cm = randn(b, s, di).bfloat16(), randn(b, s, n).bfloat16(), randn(b, s, n).bfloat16()
    dt = torch.nn.functional.softplus(randn(b, s, di)).bfloat16()
    a, d = -torch.exp(0.3 * randn(di, n)), 1 + 0.1 * randn(di)
    out[name] = graph_ms(lambda: ss.selective_scan(u, dt, a, bm, cm, d))
x, scale = randn(6144, 1600).bfloat16(), (0.1 * randn(1600)).bfloat16()
out["norm_hymba"] = graph_ms(lambda: rn.rms_norm(x, scale))
print(json.dumps(out))
'''

# The backward kernels at the training microbatch's shapes (chip_smoke.py's
# ATTN_TRAIN, SCAN_TRAIN and NORM_TRAIN), bf16, from this checkout's forward
# outputs.
_CHILD_BWD = _CHILD.split("out = {}")[0] + r'''
out = {}
for name, (b, h, kh, s, w) in {"attn_bwd_hymba": (2, 25, 5, 2048, 1024),
                               "attn_bwd_qwen": (4, 14, 2, 2048, 0)}.items():
    q, k, v, do = (randn(b, n, s, 64).bfloat16() for n in (h, kh, kh, h))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=w, with_lse=True)
    out[name] = graph_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                                        window=w))
for name, (b, s, di, n) in {"scan_bwd_hymba": (2, 2048, 3200, 16),
                            "scan_bwd_falcon": (2, 2048, 8192, 16)}.items():
    u, bm, cm = randn(b, s, di).bfloat16(), randn(b, s, n).bfloat16(), randn(b, s, n).bfloat16()
    dt = torch.nn.functional.softplus(randn(b, s, di)).bfloat16()
    a, d, dy = -torch.exp(0.3 * randn(di, n)), 1 + 0.1 * randn(di), randn(b, s, di)
    hck = ss.selective_scan_fwd(u, dt, a, bm, cm, d, checkpoints=True)[2]
    out[name] = graph_ms(lambda: ss.selective_scan_bwd(u, dt, a, bm, cm, d, hck, dy))
for name, (rows, d) in {"norm_bwd_hymba": (4096, 1600), "norm_bwd_qwen": (8192, 896),
                        "norm_bwd_falcon": (4096, 4096)}.items():
    x, dy, scale = randn(rows, d).bfloat16(), randn(rows, d).bfloat16(), (0.1 * randn(d)).bfloat16()
    out[name] = graph_ms(lambda: rn.rms_norm_bwd(x, scale, dy))
print(json.dumps(out))
'''


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="the other checkout's src directory")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernels at the training shapes")
    ap.add_argument("--out", default=None, help="write the turns here as JSON")
    args = ap.parse_args(argv)
    trees = {"this": str(Path(__file__).resolve().parents[2]),
             "other": str(Path(args.other).resolve())}
    turns = []
    for label in TURNS:
        child = _CHILD_BWD if args.backward else _CHILD
        res = subprocess.run([sys.executable, "-c", child, trees[label]], capture_output=True,
                             text=True, timeout=900, check=False)
        if res.returncode:
            raise RuntimeError(f"{label} turn failed:\n{res.stderr[-4000:]}")
        turns.append({"tree": label, "ms": json.loads(res.stdout.strip().splitlines()[-1])})
        print(json.dumps(turns[-1]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(turns, indent=1))
    return turns


if __name__ == "__main__":
    main()
