"""One run of one cell: the port's training built from the cell's files,
its first steps checked, a measured window, and the reference after it.

The object the window drives is the port's ``Trainer`` (``train/trainer.py``)
over the port's SOLAR pipeline (``data.build_pipeline``) and its
``PrefetchExecutor``, with the step and batches of the port's launchers
(``launch/train_surrogate.py``, ``launch/train.py``).  Set-up builds it
once, trains the checked steps and the rest of the warm-up through
``Trainer.run``, and hands the same object to the window, which is one more
``Trainer.run``.  The executor is kept across the calls, so each call goes
on where the last stopped (the trainer itself restarts a pipeline it builds
on every call)."""
from __future__ import annotations

import gc
import math
import resource
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench import compare, kinds, manifest
from bench.follow import follow
from bench.reference.solar import Membership
from bench.traffic import generator, weights

__all__ = ["run", "Readings"]


class _Continuing:
    """An iterable whose every ``iter`` goes on with one live iteration of
    ``executor``."""

    def __init__(self, executor):
        self.executor = executor
        self._it = iter(executor)

    def __iter__(self):
        return self._it

    def __getattr__(self, name):
        return getattr(self.executor, name)


class _StepLog:
    """Wraps the launcher's ``make_batch`` and step: records each trained
    step's per-node sample ids and weights, and keeps a host copy of the
    first ``keep`` steps' batches as the step received them."""

    def __init__(self, make_batch, step, keep: int):
        self._make_batch, self._step, self.keep = make_batch, step, keep
        self.node_ids: list = []
        self.real_rows: list = []
        self.rows: list = []
        self.kept: list = []

    def make_batch(self, sb):
        self.node_ids.append([np.array(a, np.int64) for a in sb.node_ids])
        batch = self._make_batch(sb)
        self.real_rows.append(float(np.sum(batch["weights"])))
        self.rows.append(int(len(batch["weights"])))
        return batch

    def step(self, state, batch):
        if len(self.kept) < self.keep:
            self.kept.append({k: v.detach().to("cpu", copy=True) for k, v in batch.items()})
        return self._step(state, batch)


class Readings:
    """What the per-layer readers (``metrics/<name>.py``) read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _norms(tree: dict, scale: float = 1.0) -> dict:
    """Each leaf's norm (float64 on the leaf's device) times ``scale``."""
    names = list(tree)
    vals = torch.stack([torch.linalg.vector_norm(tree[k].double()) for k in names]).cpu()
    return {k: float(v) * scale for k, v in zip(names, vals.tolist())}


def _batch_faults(kept, node_ids, data, kind, config, capacity) -> int:
    """Checked steps whose rows or weights are not the store's rows of
    their samples, each node's padded to ``capacity`` with zero rows of
    weight 0."""
    faults = 0
    for batch, ids in zip(kept, node_ids):
        n = len(ids)
        rows = torch.zeros((n * capacity,) + tuple(data.shape[1:]), dtype=data.dtype,
                           device=data.device)
        w = torch.zeros(n * capacity, dtype=torch.float32)
        for i, a in enumerate(ids):
            if len(a) > capacity:
                faults += 1
                break
            rows[i * capacity:i * capacity + len(a)] = data[torch.as_tensor(a, device=data.device)]
            w[i * capacity:i * capacity + len(a)] = 1.0
        got, want = kind.batch_rows(batch), kind.expected_rows(rows, config)
        same = torch.equal(batch["weights"].float(), w) and all(
            got[k].shape == want[k].shape
            and torch.equal(got[k], want[k].to(got[k].dtype).cpu()) for k in want)
        faults += 0 if same else 1
    return faults


def run(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float, *,
        config: dict | None = None, mix: dict | None = None,
        full: tuple | None = None, trace_window: bool = False, log=print) -> dict:
    """One run; returns the result line's fields and the numbers compared.
    ``full`` names the tensors (``grad``, ``update``) whose
    difference from the reference's is computed; by default those whose
    ``<name>_err`` the limits compare (a copy of a whole model's tensor to
    the host costs set-up time).  ``trace_window`` runs the window itself
    under the profiler, for an end-to-end metric read from the device's
    trace (the per-layer trace is a stretch after the window)."""
    from repro_torch.data import LoaderSpec, PrefetchExecutor, build_pipeline, create_store
    from repro_torch.train.step import init_train_state
    from repro_torch.train.trainer import Trainer

    wl = manifest.workload(cell)
    config = config or manifest.config(wl["config"])
    mix = mix or generator.load(wl["traffic"])
    limits = wl["limits"]
    kind = kinds.get(config["kind"])
    cuda = device.type == "cuda"
    checked = mix["checked_steps"]
    if full is None:
        full = tuple(k for k in ("grad", "update") if f"{k}_err" in limits)
    with tempfile.TemporaryDirectory(prefix="bench_store_") as tmp:
        rows = generator.data(config, mix, seed, device).cpu().numpy()
        store = create_store(str(Path(tmp) / "store.bin"), mix["backend"], data=rows)
        del rows
        store.simulated_latency_s = float(mix["pfs_latency_s"])
        spec = LoaderSpec(loader=mix["loader"], store=store, num_nodes=mix["num_nodes"],
                          local_batch=mix["local_batch"], num_epochs=mix["num_epochs"],
                          buffer_size=mix["buffer_size"], seed=seed, collect_data=True,
                          prefetch_depth=mix["prefetch_depth"],
                          num_workers=mix["num_workers"])
        pipeline = build_pipeline(spec)
        executor = PrefetchExecutor(pipeline, depth=mix["prefetch_depth"],
                                    num_workers=mix["num_workers"])
        try:
            cfg, opt, step = kind.program(config, device)
            state = init_train_state(weights.make(config, seed, device), opt)
            steplog = _StepLog(kind.make_batch(cfg, pipeline.capacity), step, checked)
            trainer = Trainer(loader=_Continuing(executor), step_fn=steplog.step,
                              state=state, make_batch=steplog.make_batch,
                              prefetch_depth=0, device=device)
            del state  # the trainer holds the only reference

            log(f"[setup] store, plan and weights {time.perf_counter() - t_start:.2f} s")
            # the checked steps.  The first gradient as the optimizer took it,
            # from its first moment (1 - b1) * clip * g, with the clip factor
            # of the global norm the step reports
            trainer.run(max_steps=1)
            gnorm = trainer.metrics_history[0]["grad_norm"]
            clip = min(1.0, opt.clip_norm / max(gnorm, 1e-9)) if opt.clip_norm > 0 else 1.0
            scale = 1.0 / ((1.0 - opt.b1) * clip)
            mu = trainer.state["opt"].mu
            prog = {"grad": _norms(mu, scale), "grad_norm": gnorm}
            if "grad" in full:
                prog["grad_full"] = {k: (v.float() * scale).to("cpu") for k, v in mu.items()}
            del mu
            trainer.run(max_steps=checked - 1)
            prog["loss"] = [h["loss"] for h in trainer.metrics_history[:checked]]
            p0 = weights.make(config, seed, device)
            change = {k: trainer.state["params"][k].float() - p0[k].float() for k in p0}
            prog["update"] = _norms(change)
            if "update" in full:
                prog["update_full"] = {k: v.to("cpu") for k, v in change.items()}
            del p0, change
            log(f"[setup] checked steps {time.perf_counter() - t_start:.2f} s")
            trainer.run(max_steps=mix["warmup_steps"] - checked)
            log(f"[setup] warm-up steps {time.perf_counter() - t_start:.2f} s")
            periods = [sum(t.values()) for t in trainer.step_times]
            est = statistics.median(periods[max(checked, len(periods) - 4):])
            done = len(trainer.step_times)
            left = pipeline.schedule.num_steps - done - mix["prefetch_depth"] - 1
            left -= mix["trace_steps"] if trace else 0
            n = max(1, min(round(seconds / est), left))

            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            reads0 = store.read_calls
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            t0 = time.perf_counter()
            window_trace = None
            if trace_window:
                from bench.devtrace import traced

                window_trace = traced(lambda: trainer.run(max_steps=n), device)
            else:
                trainer.run(max_steps=n)
            t1 = time.perf_counter()
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            setup_s = t0 - t_start
            window = trainer.step_times[done:done + n]
            readings = Readings(
                config=config, mix=mix, kind=kind, capacity=pipeline.capacity,
                window_s=t1 - t0, steps=window,
                real_rows=steplog.real_rows[done:done + n], rows=steplog.rows[done:done + n],
                pfs_reads=store.read_calls - reads0, trace=None, window_trace=window_trace)
            peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
            if trace:
                from bench.devtrace import traced

                readings.trace = traced(lambda: trainer.run(max_steps=mix["trace_steps"]),
                                        device)
        finally:
            executor.close()
            store.close()
        node_ids, kept = steplog.node_ids, steplog.kept
        trainer.state = None
        del trainer, steplog, executor, pipeline, step
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    # correctness, once the window has closed and the program's state is gone
    members = Membership(mix["num_samples"], mix["num_epochs"],
                         mix["num_nodes"] * mix["local_batch"], seed)
    where, faults = members.check(node_ids)
    data = generator.data(config, mix, seed, device)
    # SOLAR pads each node to ceil(1.5 * local batch) rows (the paper's
    # capacity factor, the port's default)
    capacity = math.ceil(1.5 * mix["local_batch"])
    faults += _batch_faults(kept, node_ids[:checked], data, kind, config, capacity)
    del data
    ids = [members.batch(*w) if w is not None else np.concatenate(node_ids[j])
           for j, w in enumerate(where[:checked])]
    t_ref = time.perf_counter()
    ref = follow(config, mix, seed, device, ids, full=full)
    t_ref = time.perf_counter() - t_ref
    values, why = compare.numbers(prog, ref, faults)
    why["numbers"] = values
    why["reference_s"] = t_ref
    why["window_s"] = readings.window_s
    # the host's CPU seconds over the window, all threads: the host-paced
    # cells' rates follow the host
    why["window_cpu_s"] = (ru1.ru_utime + ru1.ru_stime) - (ru0.ru_utime + ru0.ru_stime)
    correct, checks = compare.judge(values, limits)
    return {"correct": correct, "checks": checks, "why": why, "setup_s": setup_s,
            "readings": readings, "memory_peak_bytes": peak, "steps_window": n,
            "attempted": len(node_ids), "failed": faults}

