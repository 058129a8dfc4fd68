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

Weights are random, from seed 0; from one numpy generator seeded 0, the
encoder-decoder's source frames (standard normal) and then the prompts
(random tokens), as the JAX launcher draws them.  The engine refuses the
vlm family, as the JAX engine cannot serve it.  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import encdec, lm
from repro_torch.serve.engine import ServeEngine


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_int8:
        cfg = cfg.replace(kv_cache_dtype="int8")
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


if __name__ == "__main__":
    main()
