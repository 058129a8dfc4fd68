"""Serving launcher: batched prefill + decode over the KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --attn-impl pallas [--reduced] [--batch 4 --prompt-len 16 --gen 32] \
        [--kv-int8] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --attn-impl pallas --ssm-impl pallas --norm-impl pallas
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --ssm-impl pallas --norm-impl pallas
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --data-tier 127.0.0.1:PORT --tenant 1 --token T --first-id 0

Weights are random, from seed 0; from one numpy generator seeded 0, the
encoder-decoder's source frames (standard normal) and then the prompts
(random tokens), as the JAX launcher draws them.  The engine refuses the
vlm family, as the JAX engine cannot serve it.  Runs on the card unless
``--device cpu`` is given.

With ``--data-tier host:port`` the replica pulls its inputs through the
multi-tenant buffer tier (DESIGN.md §12) instead of drawing prompts: it
attaches as ``--tenant``/``--token``, reads ``--batch`` samples by id
starting at ``--first-id``, and maps the raw rows to prompts
deterministically (``datatier.rows_to_prompts``).  Any server of the tier
works as the entry point: misses are routed to the peer holding the
sample, then to the PFS.  Without the flag the drawn-prompt path is
unchanged.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, rmsnorm, selective_scan
from repro_torch.models import encdec, lm
from repro_torch.serve.engine import ServeEngine


def _parse_endpoint(text: str) -> tuple[str, int]:
    host, sep, port = text.rpartition(":")
    if not sep or not host:
        raise argparse.ArgumentTypeError(
            f"--data-tier wants host:port, got {text!r}")
    return host, int(port)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--attn-impl", default="auto",
                    choices=("auto", "ref", "blockwise", "pallas"),
                    help="prefill attention; 'pallas' is the CUDA flash kernel")
    ap.add_argument("--ssm-impl", default="auto", choices=("auto", "ref", "pallas"),
                    help="prefill selective scan; 'pallas' is the CUDA scan kernel")
    ap.add_argument("--norm-impl", default="auto", choices=("auto", "ref", "pallas"),
                    help="every RMSNorm; 'pallas' is the CUDA RMSNorm kernel")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--data-tier", type=_parse_endpoint, default=None,
                    metavar="HOST:PORT",
                    help="pull prompts from a buffer-tier server instead of drawing them")
    ap.add_argument("--tenant", type=int, default=1,
                    help="tenant id for --data-tier attach")
    ap.add_argument("--token", default="",
                    help="tenant auth token for --data-tier attach")
    ap.add_argument("--first-id", type=int, default=0,
                    help="first sample id to read from the tier")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_int8:
        cfg = cfg.replace(kv_cache_dtype="int8")
    if args.data_tier is not None and cfg.family == "encdec":
        ap.error("--data-tier drives decoder-only prompts; "
                 "encdec archs need the synthetic source path")
    device = resolve_device(args.device)

    init = encdec.init_encdec if cfg.family == "encdec" else lm.init_lm
    params = init(cfg, seed=0, device=device)
    engine = ServeEngine(cfg, params, max_len=args.prompt_len + args.gen + 1,
                         attn_impl=args.attn_impl, ssm_impl=args.ssm_impl,
                         norm_impl=args.norm_impl, device=device)
    rng = np.random.default_rng(0)
    source = None
    if cfg.family == "encdec":
        source = rng.standard_normal(
            (args.batch, cfg.source_len, cfg.d_model)).astype(np.float32)
    if args.data_tier is not None:
        from repro_torch.serve.datatier import DataTierClient

        client = DataTierClient({0: args.data_tier}, tenant=args.tenant,
                                token=args.token)
        try:
            ids = np.arange(args.first_id, args.first_id + args.batch, dtype=np.int64)
            t0 = time.perf_counter()
            out, served = engine.generate_from_tier(client, ids, args.gen,
                                                    prompt_len=args.prompt_len)
            dt = time.perf_counter() - t0
            print(f"tier served {int(served.sum())}/{ids.size} samples; "
                  f"client stats: {client.stats()}")
        finally:
            client.close()
    else:
        prompts = rng.integers(
            0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.gen, source=source)  # host numpy: synchronised
        dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({out.size / dt:.1f} tok/s on {where}, attn_impl={args.attn_impl}, "
          f"ssm_impl={args.ssm_impl}, norm_impl={args.norm_impl})")
    print("first sequence:", out[0][:16].tolist())
    print("kernel launches:", json.dumps({"flash_attention": flash_attention.launches,
                                          "selective_scan": selective_scan.launches,
                                          "rms_norm": rmsnorm.launches}))


if __name__ == "__main__":
    main()
