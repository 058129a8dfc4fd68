"""Train a CNN surrogate through the SOLAR plan-and-load pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train_surrogate \
        --arch ptychonn|autophasenn|cosmoflow [--reduced] [--steps 300] \
        [--nodes 4 --local-batch 16 --buffer 2048 --epochs 6] \
        [--num-samples 8192] [--backend binary|hdf5|memory|sharded] \
        [--loaders naive,solar] [--device cuda|cpu] \
        [--checkpoint-dir DIR [--checkpoint-every N] [--resume]]

The counterpart of ``examples/train_surrogate.py``.  A synthetic dataset
(random samples of the surrogate's input shape, from seed 0) is written
to a temporary store; each loader in ``--loaders`` trains the same
initial parameters (a ``torch.Generator`` seeded with 0) on its
planned batches, with the target the mean of each input broadcast to the
output shape.  For each loader it prints the first and last loss, the real
load and compute split, the modeled PFS time, numPFS and hit rate, and at
the end SOLAR's modeled speedup over naive.  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.surrogates import SURROGATES, SurrogateConfig
from repro_torch.data import DatasetSpec, LoaderSpec, backend_names, build_pipeline, create_store
from repro_torch.models import cnn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer

__all__ = ["StepConfig", "build_parser", "make_store", "make_batch_fn",
           "loader_spec", "make_step", "train_loader", "main"]


#: the dataset's, the plan's and the initial parameters' seed
SEED = 0
#: AdamW's peak learning rate (cosine schedule, 100 warmup steps)
LR = 1e-3
#: planned steps read ahead of the trainer
PREFETCH_DEPTH = 2


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The two fields ``make_train_step`` reads off a model config."""

    grad_accum: int = 1
    grad_accum_dtype: str = "float32"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="ptychonn", choices=sorted(SURROGATES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--local-batch", type=int, default=16)
    ap.add_argument("--buffer", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--num-samples", type=int, default=8192)
    ap.add_argument("--backend", default="binary", choices=backend_names(),
                    help="storage layout serving the synthetic dataset")
    ap.add_argument("--loaders", default="naive,solar",
                    help="comma-separated strategies, each trained in turn")
    ap.add_argument("--num-workers", type=int, default=4,
                    help="I/O threads reading ahead of the trainer")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="one subdirectory per loader")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore each loader's latest checkpoint and go on "
                         "from its plan cursor")
    return ap


def make_store(cfg: SurrogateConfig, path: str, backend: str, num_samples: int,
               seed: int = 0):
    """A store of ``num_samples`` random f32 samples of the input shape."""
    return create_store(path, backend, spec=DatasetSpec(num_samples, cfg.input_shape, "<f4"),
                        fill="random", seed=seed)


def make_batch_fn(cfg: SurrogateConfig, capacity: int):
    """StepBatch -> ``{"x", "y", "weights"}`` numpy arrays: the padded global
    batch of ``to_global`` and, as target, each input's mean broadcast to
    the output shape (cheap and learnable)."""
    def make_batch(sb):
        data, weights = sb.to_global(capacity)
        pooled = data.reshape(data.shape[0], -1).mean(axis=1)
        y = np.broadcast_to(
            pooled.reshape((-1,) + (1,) * len(cfg.output_shape)),
            (data.shape[0],) + cfg.output_shape,
        ).astype(np.float32)
        return {"x": data, "y": y, "weights": weights}

    return make_batch


def loader_spec(store, loader: str, args, **changes) -> LoaderSpec:
    """The pipeline spec the launcher trains ``loader`` through."""
    spec = LoaderSpec(
        loader=loader, store=store, num_nodes=args.nodes,
        local_batch=args.local_batch, num_epochs=args.epochs,
        buffer_size=args.buffer, seed=SEED, collect_data=True,
        prefetch_depth=PREFETCH_DEPTH, num_workers=args.num_workers,
    )
    return spec.replace(**changes)


def make_step(cfg: SurrogateConfig, args):
    """The launcher's optimizer config and training step."""
    opt = AdamWConfig(lr=LR, total_steps=args.steps)
    return opt, make_train_step(StepConfig(), opt, lambda p, b: cnn.surrogate_loss(p, b, cfg))


def train_loader(cfg: SurrogateConfig, store, loader: str, args, device, *,
                 params=None, max_steps: int | None = None,
                 checkpoint_dir: str | None = None, checkpoint_every: int = 0,
                 resume: bool = False) -> Trainer:
    """Train ``cfg`` on ``store`` through ``loader``'s plan; returns the
    finished :class:`Trainer`.  ``params`` defaults to a fresh init from
    ``SEED``."""
    pipeline = build_pipeline(loader_spec(store, loader, args))
    if params is None:
        params = cnn.init_surrogate(
            cfg, generator=torch.Generator().manual_seed(SEED), device=device)
    opt, step = make_step(cfg, args)
    state = init_train_state(params, opt)
    skip = 0
    if resume:
        state, skip = Trainer.try_restore(checkpoint_dir, state,
                                          plan_hash=pipeline.config_hash)
    trainer = Trainer(loader=pipeline, step_fn=step, state=state,
                      make_batch=make_batch_fn(cfg, pipeline.capacity),
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every, skip_steps=skip,
                      device=device)
    trainer.run(max_steps=args.steps if max_steps is None else max_steps)
    return trainer


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = SURROGATES[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    loaders = [s for s in args.loaders.split(",") if s]
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{cfg.name}: input {cfg.input_shape}, output {cfg.output_shape}, "
          f"{args.num_samples} samples, {args.nodes} nodes x {args.local_batch}, "
          f"buffer {args.buffer}, on {where}")

    tmp = tempfile.mkdtemp(prefix="solar_surrogate_")
    store = make_store(cfg, os.path.join(tmp, f"{cfg.name}.{args.backend}"),
                       args.backend, args.num_samples, SEED)
    results = {}
    try:
        for name in loaders:
            store.reset_counters()
            ckpt = (os.path.join(args.checkpoint_dir, name)
                    if args.checkpoint_dir else None)
            t = train_loader(cfg, store, name, args, device, checkpoint_dir=ckpt,
                             checkpoint_every=args.checkpoint_every,
                             resume=args.resume and ckpt is not None)
            bd = t.breakdown()
            report = t.loader.report
            results[name] = {
                "first_loss": t.metrics_history[0]["loss"] if t.metrics_history else None,
                "last_loss": t.metrics_history[-1]["loss"] if t.metrics_history else None,
                "steps": len(t.metrics_history),
                "load_s": bd["load_s"], "compute_s": bd["compute_s"],
                "load_frac": bd["load_frac"],
                "modeled_pfs_s": report.modeled_time_s,
                "numPFS": report.total_pfs, "hit_rate": report.hit_rate,
            }
            r = results[name]
            print(f"\n== {name} ==")
            if r["steps"]:
                print(f"  loss {r['first_loss']:.4f} -> {r['last_loss']:.4f} "
                      f"over {r['steps']} steps")
            print(f"  real   load {bd['load_s']:.2f}s / compute {bd['compute_s']:.2f}s"
                  f" (load fraction {bd['load_frac'] * 100:.0f}%)")
            print(f"  modeled PFS load {report.modeled_time_s:.2f}s, "
                  f"numPFS {report.total_pfs}, hit rate {report.hit_rate:.3f}")
    finally:
        store.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if "naive" in results and "solar" in results:
        e2e = {k: v["modeled_pfs_s"] + v["compute_s"] for k, v in results.items()}
        print(f"\nmodeled end-to-end speedup (SOLAR vs naive): "
              f"{e2e['naive'] / e2e['solar']:.2f}x")
    return results


if __name__ == "__main__":
    main()
