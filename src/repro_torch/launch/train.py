"""Training launcher: the SOLAR plan-and-load pipeline feeding a language
model's training step, with checkpoints; and plan artifacts without training.

    # train (the default subcommand; bare flags work too)
    PYTHONPATH=src python -m repro_torch.launch.train train --arch qwen2-0.5b \
        --reduced --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --seq-len 2048 --nodes 2 --local-batch 5 --steps 10      # on the card

    # precompute / inspect plan artifacts without training
    PYTHONPATH=src python -m repro_torch.launch.train plan --loader solar \
        --num-samples 32768 --nodes 8 --local-batch 32 --buffer 3072 \
        --epochs 6 --out /tmp/solar.plan.npz
    PYTHONPATH=src python -m repro_torch.launch.train plan --inspect /tmp/solar.plan.npz

    # multi-process data pipeline: N rank processes, socket peer transport
    PYTHONPATH=src python -m repro_torch.launch.train distributed --nodes 2 \
        --peer-fetch --num-samples 2048 --epochs 2 --verify

    # streaming ingestion: producers ingest while sealed windows replay
    PYTHONPATH=src python -m repro_torch.launch.train stream --nodes 2 \
        --num-samples 2048 --window-steps 8 --watermark 32 --verify

The counterpart of the JAX package's ``launch/train.py`` (``run_train``,
``run_plan``) for every family, built on the port's own ``core`` and
``data`` copies.  A synthetic token store (int32 rows of ``seq_len + 1``,
random from the seed) is created at ``--data`` on first use; each planned
step's global batch, padded to the plan's capacity with zero-weight rows, is
split into ``grad_accum`` microbatches.  As in the JAX launcher, the vlm
family gets zero patch embeddings ``[B, num_patches, D]`` and the
encoder-decoder zero source frames ``[B, source_len, D]``, and each family
trains through its module's init (seed 0) and ``train_loss``
(``models/encdec.py`` for the encoder-decoder, ``models/lm.py`` for the
rest).  Runs on the card unless ``--device cpu`` is given; there,
attention, the selective scan and RMSNorm go through the hand-written
kernels, forward and backward.  ``distributed`` (``run_distributed_cmd``,
the JAX launcher's subcommand of the same name) runs the data pipeline
only, as N numpy-only rank processes; ``stream`` (``run_stream_cmd``)
streams synthetic rows through seeded admission into sealed plan windows,
in this process or (``--distributed``) across numpy-only rank processes,
with no model; the models and torch are imported by ``train`` alone.
Every subcommand takes ``-v``/``-q``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.data import (
    STRATEGIES,
    DatasetSpec,
    LoaderSpec,
    backend_names,
    build_pipeline,
    build_store,
)
from repro_torch.obs import log as obs_log

__all__ = ["build_parser", "loader_spec", "make_batch_fn", "make_step", "train",
           "run_plan", "run_distributed_cmd", "run_stream_cmd", "main"]

#: The initial parameters' seed (the JAX launcher's PRNGKey(0)).
SEED = 0


def _add_pipeline_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--loader", default="solar", choices=STRATEGIES)
    ap.add_argument("--num-samples", type=int, default=2048)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--buffer", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan-cache", default=None,
                    help="directory memoizing compiled plans by config hash")
    obs_log.add_verbosity_args(ap)


def _add_train_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch", required=True)
    ap.add_argument("--plan-path", default=None,
                    help="explicit plan artifact: loaded when present, "
                         "built + saved there when not")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale model (CPU-trainable)")
    _add_pipeline_args(ap)
    ap.add_argument("--backend", default="binary", choices=backend_names(),
                    help="storage backend serving --data (created on first "
                         "run in that layout)")
    ap.add_argument("--data", default=None,
                    help="dataset path (default: solar_tokens_torch.<backend> "
                         "in the temporary directory)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="pipeline read-ahead in steps (0 = synchronous)")
    ap.add_argument("--num-workers", type=int, default=4,
                    help="I/O threads for schedule-driven chunk reads")
    ap.add_argument("--peer-fetch", action="store_true",
                    help="plan + execute the peer-fetch buffer tier "
                         "(solar loader only)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")


def _add_plan_args(ap: argparse.ArgumentParser) -> None:
    _add_pipeline_args(ap)
    ap.add_argument("--out", default=None,
                    help="save the compiled plan artifact here (loaded "
                         "instead when it already exists; mutually "
                         "exclusive with --plan-cache)")
    ap.add_argument("--inspect", default=None, metavar="PATH",
                    help="load an existing artifact and report on it "
                         "instead of compiling")
    ap.add_argument("--peer-fetch", action="store_true",
                    help="plan the peer-fetch tier (priced from "
                         "--sample-bytes, as no dataset is opened)")
    ap.add_argument("--sample-bytes", type=int, default=4096,
                    help="sample size used to price the peer tier when "
                         "planning without a dataset; must match the "
                         "dataset's real sample size for the artifact's "
                         "config hash to line up with training")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="padded-batch capacity factor (solar loader); 1.0 "
                         "is the zero-padding regime where the peer tier "
                         "carries traffic")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_train_args(sub.add_parser(
        "train", help="train a model through the plan-first pipeline"))
    _add_plan_args(sub.add_parser(
        "plan", help="precompute or inspect a plan artifact (no training)"))
    _add_distributed_args(sub.add_parser(
        "distributed",
        help="execute one plan as N rank processes over the socket peer "
             "transport (data pipeline only, no model training)"))
    _add_stream_args(sub.add_parser(
        "stream",
        help="streaming ingestion: synthetic producers write rows under "
             "seeded admission while sealed windows are planned and "
             "replayed (data pipeline only, no model training)"))
    return ap


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


def _plan_report(schedule) -> dict:
    """Stats, hash and per-node load of a plan."""
    st = schedule.stats()
    acc = {
        r: {"node": r, "pfs_samples": 0, "misses": 0, "hits": 0,
            "peer_fetches": 0, "peer_serves": 0}
        for r in range(schedule.num_nodes)
    }
    for sp in schedule:
        for npn in sp.nodes:
            a = acc[npn.node]
            a["pfs_samples"] += npn.pfs_samples
            a["misses"] += npn.num_misses
            a["hits"] += npn.num_hits
            a["peer_fetches"] += npn.num_peer
            for f in npn.peer_fetches:
                acc[f.source]["peer_serves"] += 1
    return {
        "strategy": schedule.strategy,
        "config_hash": schedule.config_hash,
        "artifact_digest": schedule.artifact_digest(),
        "num_nodes": schedule.num_nodes,
        "local_batch": schedule.local_batch,
        "capacity": schedule.capacity,
        "buffer_size": schedule.buffer_size,
        "num_epochs": len(schedule.epochs),
        "num_steps": schedule.num_steps,
        "stats": st.summary(),
        "per_node": [acc[r] for r in sorted(acc)],
    }


def run_plan(args) -> dict:
    """Compile (or load) a plan artifact and print its report."""
    from repro_torch.core.costmodel import PeerCostModel, PFSCostModel
    from repro_torch.core.plan import Schedule
    from repro_torch.core.scheduler import SolarConfig
    from repro_torch.data import plan

    if args.inspect:
        report = _plan_report(Schedule.load(args.inspect))
        print(json.dumps(report, indent=1))
        return report
    # The cost-model shape make_planner derives from an open store, so a
    # precomputed artifact's config hash matches a later train run whose
    # dataset has --sample-bytes-sized samples.
    peer_cost = None
    if args.peer_fetch:
        peer_cost = PeerCostModel(sample_bytes=args.sample_bytes,
                                  pfs=PFSCostModel(sample_bytes=args.sample_bytes))
    solar = None
    if args.capacity_factor is not None and args.loader == "solar":
        solar = SolarConfig(
            num_nodes=args.nodes, local_batch=args.local_batch,
            buffer_size=args.buffer, seed=args.seed,
            capacity_factor=args.capacity_factor,
            enable_peer=args.peer_fetch, peer_cost=peer_cost,
        )
        peer_cost = None  # carried by the solar config now
    spec = LoaderSpec(
        loader=args.loader, num_nodes=args.nodes, local_batch=args.local_batch,
        num_epochs=args.epochs, buffer_size=args.buffer, seed=args.seed,
        peer_fetch=args.peer_fetch, peer_cost=peer_cost, solar=solar,
        plan_cache=args.plan_cache, plan_path=args.out,
    )
    report = _plan_report(plan(spec, num_samples=args.num_samples))
    print(json.dumps(report, indent=1))
    return report


# ---------------------------------------------------------------------------
# distributed
# ---------------------------------------------------------------------------


def _add_distributed_args(ap: argparse.ArgumentParser) -> None:
    _add_pipeline_args(ap)
    ap.add_argument("--backend", default="binary", choices=backend_names(),
                    help="storage backend serving --data (created on first "
                         "run; must be path-based — every rank reopens it)")
    ap.add_argument("--data", default=None,
                    help="dataset path (default: solar_tokens_torch.<backend> "
                         "in the temporary directory)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--peer-fetch", action="store_true",
                    help="plan + serve the peer tier over real sockets "
                         "(capacity_factor=1.0 so the tier carries traffic)")
    ap.add_argument("--verify", action="store_true",
                    help="also execute the plan in-process and assert every "
                         "rank's stream digest matches bit for bit (and, "
                         "under faults, that the XOR-aggregate digest of "
                         "the whole run matches despite deaths)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="whole-run timeout in seconds")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="seeded fault-injection plan, e.g. "
                         "'seed=7,crash=1,corrupt=2,slow=1' "
                         "(see repro_torch.runtime.faults.FaultPlan.parse; "
                         "ranks= defaults to --nodes)")
    ap.add_argument("--recovery", default="reslice",
                    choices=("reslice", "degrade"),
                    help="on rank death: re-slice its remaining plan onto "
                         "survivors (default) or degrade to PFS fallbacks")
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="epoch-window skew: ranks barrier only every "
                         "depth+1 steps and pipeline that many steps of "
                         "chunk reads inside the window (0 = lockstep; "
                         "digests are depth-invariant)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="flight recorder (DESIGN.md §13): every rank dumps "
                         "trace-rank{N}.jsonl + a Chrome trace-event file "
                         "here; analyze with `python -m repro_torch.obs.report`")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the coordinator's live telemetry "
                         "time-series + the final summary as one JSON file")


def run_distributed_cmd(args) -> dict:
    """Run one plan as ``--nodes`` rank processes; print and return the
    run's ``summary()`` (with a ``verify`` block under ``--verify``).
    Exits non-zero on a digest mismatch or on a death nobody injected."""
    from repro_torch.core.scheduler import SolarConfig
    from repro_torch.data import plan
    from repro_torch.runtime import (
        FaultPlan,
        in_process_aggregate,
        in_process_digests,
        run_distributed,
    )

    faults = None
    if args.faults:
        text = args.faults
        if "ranks=" not in text:
            text = f"ranks={args.nodes},{text}"
        faults = FaultPlan.parse(text)
    if args.data is None:
        args.data = os.path.join(tempfile.gettempdir(), f"solar_tokens_torch.{args.backend}")
    solar = None
    if args.loader == "solar" and args.peer_fetch:
        # capacity_factor=1.0 is the regime where the tier carries traffic
        # (capacity-spilled hits become interconnect fetches, DESIGN.md §6).
        solar = SolarConfig(
            num_nodes=args.nodes, local_batch=args.local_batch,
            buffer_size=args.buffer, seed=args.seed,
            capacity_factor=1.0, enable_peer=True,
        )
    spec = LoaderSpec(
        loader=args.loader, backend=args.backend, path=args.data,
        num_nodes=args.nodes, local_batch=args.local_batch,
        num_epochs=args.epochs, buffer_size=args.buffer, seed=args.seed,
        collect_data=True, peer_fetch=args.peer_fetch, solar=solar,
        plan_cache=args.plan_cache, transport="socket",
        prefetch_depth=max(args.prefetch_depth, 0),
    )
    store = build_store(spec, create=True,
                        dataset=DatasetSpec(args.num_samples, (args.seq_len + 1,), "<i4"),
                        fill="random")
    store.close()  # ranks reopen it themselves; the parent only creates it
    schedule = plan(spec)  # once: the run and the reference share one plan
    report = run_distributed(
        spec, schedule=schedule, timeout_s=args.timeout,
        faults=faults, recovery=args.recovery,
        trace_dir=args.trace_dir, metrics_out=args.metrics_out,
        verbosity=obs_log.verbosity_from(args),
    )
    out = report.summary()
    # a death nobody injected must not exit green, re-sliced or not; an
    # injected crash under reslice is the scenario being tested (pair it
    # with --verify to assert aggregate parity).
    unexpected_death = report.dead and (args.recovery != "reslice" or faults is None)
    if args.verify:
        ref = in_process_digests(spec, schedule=schedule)
        mismatched = [
            r.rank for r in report.ranks
            if r.status == "ok" and not r.rejoined and r.digest != ref[r.rank]
        ]
        agg_parity = report.aggregate_digest() == in_process_aggregate(spec, schedule=schedule)
        out["verify"] = {
            "digest_parity": not mismatched and report.ok,
            "aggregate_parity": agg_parity,
            "mismatched_ranks": mismatched,
            "dead_ranks": report.dead,
        }
        print(json.dumps(out, indent=1))
        if mismatched:
            raise SystemExit(
                f"digest mismatch on ranks {mismatched}: the multi-process "
                "run trained different bytes than the in-process reference")
        if not agg_parity:
            raise SystemExit(
                "aggregate digest mismatch: the run did not execute the "
                "planned global sample stream exactly once")
        if unexpected_death:
            raise SystemExit(
                f"ranks {report.dead} died during the run: digest parity "
                "could not be verified for them")
        return out
    print(json.dumps(out, indent=1))
    if unexpected_death:
        raise SystemExit(f"ranks {report.dead} died during the run")
    return out


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------


def _add_stream_args(ap: argparse.ArgumentParser) -> None:
    from repro_torch.stream import ADMISSION_POLICIES

    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--buffer", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-samples", type=int, default=2048,
                    help="id space of the stream (store rows; producers "
                         "emit each id once)")
    ap.add_argument("--backend", default="sharded",
                    choices=("memory", "sharded"),
                    help="writable backend holding the stream (distributed "
                         "runs require 'sharded': ranks read the rows the "
                         "parent's ingest writes)")
    ap.add_argument("--data", default=None,
                    help="store path (default: solar_stream_torch.<backend> "
                         "in the temporary directory)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--window-steps", type=int, default=8,
                    help="training steps per plan window")
    ap.add_argument("--watermark", type=int, default=16,
                    help="fresh admissions a seal waits for before the next "
                         "window is planned")
    ap.add_argument("--admission", default="reservoir",
                    choices=ADMISSION_POLICIES,
                    help="seeded admission policy for arriving samples")
    ap.add_argument("--reservoir", type=int, default=None,
                    help="admitted-set bound for reservoir/latest policies "
                         "(default: unbounded)")
    ap.add_argument("--max-windows", type=int, default=None,
                    help="stop after this many windows (default: run until "
                         "producers finish with nothing fresh)")
    ap.add_argument("--rate", type=float, default=None,
                    help="aggregate producer arrival rate in samples/s "
                         "(default: unthrottled)")
    ap.add_argument("--producer-threads", type=int, default=2)
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="pipeline read-ahead in steps; distributed ranks "
                         "run it as async prefetch inside their stream "
                         "windows (digests stay depth-invariant)")
    ap.add_argument("--distributed", action="store_true",
                    help="execute as --nodes rank processes: each sealed "
                         "window's plan is broadcast by content hash and "
                         "ranks cut over at the same step boundary")
    ap.add_argument("--stop-the-world", action="store_true",
                    help="plan each window synchronously at the boundary "
                         "instead of overlapping planning with training "
                         "(the baseline of blocked_on_planning_s)")
    ap.add_argument("--verify", action="store_true",
                    help="assert the streaming determinism contract: the "
                         "concatenated window plans and the executed batch "
                         "stream match a one-shot offline replan (and, "
                         "distributed, every rank's slice digest matches "
                         "the in-process reference)")
    ap.add_argument("--timeout", type=float, default=300.0)
    obs_log.add_verbosity_args(ap)


def run_stream_cmd(args) -> dict:
    """Stream ``--num-samples`` synthetic rows from producer threads into a
    writable store and replay the sealed windows, in this process or as
    ``--nodes`` rank processes; print and return the run's ``summary()``.
    Exits non-zero on a dead rank or, under ``--verify``, when the live
    windows diverge from the one-shot offline replan."""
    import threading

    from repro_torch.stream import (
        IngestSession,
        StreamSpec,
        run_producers,
        run_stream,
    )
    from repro_torch.stream.distributed import run_stream_distributed

    if args.data is None:
        args.data = os.path.join(tempfile.gettempdir(),
                                 f"solar_stream_torch.{args.backend}")
    if args.distributed and args.backend != "sharded":
        raise SystemExit(
            "stream --distributed requires --backend sharded (ranks must "
            "see the parent's row writes; 'memory' stages at open)")
    spec = LoaderSpec(
        loader="stream", backend=args.backend, path=args.data,
        num_nodes=args.nodes, local_batch=args.local_batch,
        buffer_size=args.buffer, seed=args.seed, collect_data=True,
        prefetch_depth=max(args.prefetch_depth, 0),
        stream=StreamSpec(
            window_steps=args.window_steps, admission=args.admission,
            watermark=args.watermark, reservoir_size=args.reservoir,
            max_windows=args.max_windows,
        ),
    )
    store = build_store(
        spec, create=True,
        dataset=DatasetSpec(args.num_samples, (args.seq_len + 1,), "<i4", num_shards=4),
        fill="zeros",
    )
    try:
        session = IngestSession(store, seed=args.seed, admission=args.admission,
                                reservoir_size=args.reservoir)
        producer = threading.Thread(
            target=run_producers, args=(session, range(args.num_samples)),
            kwargs=dict(threads=args.producer_threads, data_seed=args.seed,
                        rate_hz=args.rate),
            name="stream-producers", daemon=True,
        )
        producer.start()
        if args.distributed:
            report = run_stream_distributed(spec, session, verify=args.verify,
                                            timeout_s=args.timeout)
        else:
            report = run_stream(spec.replace(store=store, path=None), session,
                                overlap=not args.stop_the_world, verify=args.verify)
        producer.join(timeout=30.0)
        out = report.summary()
        print(json.dumps(out, indent=1))
        if args.distributed and report.dead:
            raise SystemExit(f"ranks {report.dead} died during the stream")
        if args.verify and not report.ok:
            raise SystemExit(
                "streaming determinism violated: the live window plans or "
                "batches diverged from the one-shot offline replan")
    finally:
        store.close()
    return out


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def loader_spec(args) -> LoaderSpec:
    """The pipeline spec ``train`` runs."""
    return LoaderSpec(
        loader=args.loader, backend=args.backend, path=args.data,
        num_nodes=args.nodes, local_batch=args.local_batch,
        num_epochs=args.epochs, buffer_size=args.buffer, seed=args.seed,
        collect_data=True, prefetch_depth=args.prefetch_depth,
        num_workers=args.num_workers, peer_fetch=args.peer_fetch,
        plan_cache=args.plan_cache, plan_path=args.plan_path,
    )


def make_batch_fn(cfg, capacity: int):
    """StepBatch -> ``{"tokens", "labels", "weights"}`` numpy arrays: the
    padded global batch of ``to_global``, each row ``seq_len + 1`` tokens
    (mod the vocabulary) split into inputs and next-token labels; plus zero
    f32 ``patches`` (vlm) or ``source`` frames (encdec)."""
    def make_batch(sb):
        data, weights = sb.to_global(capacity)
        batch = {"tokens": (data[:, :-1] % cfg.vocab_size).astype(np.int32),
                 "labels": (data[:, 1:] % cfg.vocab_size).astype(np.int32),
                 "weights": np.asarray(weights, np.float32)}
        b = data.shape[0]
        if cfg.family == "vlm":
            batch["patches"] = np.zeros((b, cfg.num_patches, cfg.d_model), np.float32)
        if cfg.family == "encdec":
            batch["source"] = np.zeros((b, cfg.source_len, cfg.d_model), np.float32)
        return batch

    return make_batch


def make_step(cfg, args, mesh=None):
    """The launcher's optimizer config and training step on flat params
    (``train_loss``'s 'auto' paths: the kernels on the card); with ``mesh``
    the sharded step (``train.step``), which takes the state of
    ``init_train_state(..., mesh=mesh)``."""
    from repro_torch.models import encdec, lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step

    opt = AdamWConfig(lr=args.lr, total_steps=args.steps)
    train_loss = encdec.train_loss if cfg.family == "encdec" else lm.train_loss

    def loss_fn(p, b):
        return train_loss(lm.nested_params(p), b, cfg)

    return opt, make_train_step(cfg, opt, loss_fn, mesh=mesh)


def train(args, device=None, *, cfg=None):
    """Build the store, the pipeline and the model (its family's init from
    ``SEED``), train ``args.steps`` planned steps, and return the finished
    Trainer.  ``cfg`` defaults to ``--arch`` (``reduced()`` with
    ``--reduced``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, lm
    from repro_torch.train.step import init_train_state
    from repro_torch.train.trainer import Trainer

    device = resolve_device(device if device is not None else args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        cfg = cfg.reduced() if args.reduced else cfg
    if cfg.family != "encdec":
        lm.check_supported(cfg)
    if args.data is None:
        args.data = os.path.join(tempfile.gettempdir(), f"solar_tokens_torch.{args.backend}")
    spec = loader_spec(args)
    store = build_store(spec, create=True,
                        dataset=DatasetSpec(args.num_samples, (args.seq_len + 1,), "<i4"),
                        fill="random")
    try:
        loader = build_pipeline(spec, store=store)
        init = encdec.init_encdec if cfg.family == "encdec" else lm.init_lm
        opt, step = make_step(cfg, args)
        state = init_train_state(lm.flat_params(init(cfg, seed=SEED, device=device)), opt)
        skip = 0
        if args.resume and args.checkpoint_dir:
            state, skip = Trainer.try_restore(args.checkpoint_dir, state,
                                              plan_hash=getattr(loader, "config_hash", None))
            print(f"resuming from step {skip}")
        trainer = Trainer(
            loader=loader, step_fn=step, state=state,
            make_batch=make_batch_fn(cfg, getattr(loader, "capacity", args.local_batch + 4)),
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
            skip_steps=skip, prefetch_depth=args.prefetch_depth,
            num_workers=args.num_workers, device=device,
        )
        # The trainer holds the only reference, so each step's new state frees
        # the one before it (a step keeps the old state until it returns).
        del state
        trainer.run(max_steps=args.steps)
    finally:
        store.close()
    return trainer


def run_train(args):
    trainer = train(args)
    hist = trainer.metrics_history
    for rec in hist[:: max(len(hist) // 10, 1)]:
        print(f"step {rec['step']:5d} loss {rec['loss']:.4f}")
    print(json.dumps(trainer.breakdown(), indent=1))
    return trainer


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # a bare flag list is the train subcommand; top-level help stays reachable
    if argv and argv[0] not in ("train", "plan", "distributed", "stream", "-h", "--help"):
        argv = ["train"] + argv
    args = build_parser().parse_args(argv)
    obs_log.configure(obs_log.verbosity_from(args))
    if args.cmd == "stream":
        return run_stream_cmd(args)
    if args.cmd == "plan":
        return run_plan(args)
    if args.cmd == "distributed":
        return run_distributed_cmd(args)
    return run_train(args)


if __name__ == "__main__":
    main()
