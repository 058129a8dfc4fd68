"""Trainer: SOLAR input pipeline + training step + checkpoints.

Port of ``repro.train.trainer``, with the same surface (``run``,
``try_restore``, ``breakdown``, ``metrics_history``, ``skip_steps``) and
contract:

  * the loader yields uneven per-node batches; ``StepBatch.to_global`` pads
    them to the fixed capacity with zero-weight rows (gradients unchanged),
  * a :class:`~repro_torch.data.prefetch.PrefetchExecutor` keeps
    ``prefetch_depth`` step batches ready, so PFS reads overlap the previous
    step's compute (the paper's Fig. 6 overlap),
  * the plan cursor is part of every checkpoint; a resume replays the
    skipped steps' buffer deltas through ``fast_forward`` (zero I/O) and is
    refused against a different plan,
  * wall time is split into load (``train.make_batch``) and compute
    (``train.compute``) spans, the paper's Fig. 3 breakdown; the port also
    counts the time spent waiting for the loader's next batch (``wait_s``),
    which the JAX package's breakdown leaves out.  Inside them the tracer
    sees ``batch.to_global`` and ``batch.stage`` (load) and the step's
    ``step.*`` phases (compute).

On the card, ``make_batch``'s host arrays are copied into one of two sets
of pinned buffers and sent with ``non_blocking`` copies on a side stream;
the compute stream waits on that copy's event, and a set is refilled only
after its previous copy has finished (:class:`PinnedBatchStager`).  The
step's compute ends in one device-to-host copy of its metrics, which waits
for the step, where the JAX package calls ``jax.block_until_ready`` on the
loss.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_checkpoint,
    plan_cursor_extra,
    restore_checkpoint,
    resume_cursor,
)
from repro_torch.data.pipeline import LoaderSpec, build_pipeline
from repro_torch.data.prefetch import PrefetchExecutor
from repro_torch.obs import trace as obs_trace

__all__ = ["Trainer", "PinnedBatchStager"]


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


class PinnedBatchStager:
    """Host batches to the card through two sets of pinned buffers.

    Each call takes the next set, waits until that set's previous copy has
    finished (its event), fills the pinned buffers with the batch's bytes,
    and enqueues ``non_blocking`` copies on a side stream.  The caller's
    current stream waits on the copy's event, and the device tensors are
    marked as used there, so the allocator does not hand their memory out
    while the step still reads it.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._bufs: list[dict] = [{}, {}]
        self._events: list = [None, None]
        self._next = 0

    def __call__(self, batch: dict) -> dict:
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()  # the set's last copy has landed
        bufs = self._bufs[i]
        out = {}
        with torch.cuda.stream(self.stream):
            for k, a in batch.items():
                a = np.asarray(a)
                buf = bufs.get(k)
                if buf is None or tuple(buf.shape) != a.shape or buf.dtype != _torch_dtype(a):
                    buf = torch.empty(a.shape, dtype=_torch_dtype(a), pin_memory=True)
                    bufs[k] = buf
                np.copyto(buf.numpy(), a)
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[i] = event
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for t in out.values():
            t.record_stream(compute)
        return out


class Trainer:
    def __init__(
        self,
        *,
        loader,                     # a loader, PrefetchExecutor, or LoaderSpec
        step_fn,                    # (state, batch) -> (state, metrics)
        state,
        make_batch,                 # StepBatch -> model batch dict (numpy)
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        prefetch_depth: int = 2,
        num_workers: int = 4,       # I/O threads for schedule-driven prefetch
        skip_steps: int = 0,        # resume: skip already-trained steps
        device=None,                # None: the card (raises without one)
    ):
        self.device = resolve_device(device)
        if isinstance(loader, LoaderSpec):
            # the spec's prefetch shape wins over the Trainer kwargs — in
            # particular prefetch_depth=0 stays fully synchronous.
            prefetch_depth = loader.prefetch_depth
            num_workers = loader.num_workers
            loader = build_pipeline(loader)
        self.loader = loader
        self.step_fn = step_fn
        self.state = state
        self.make_batch = make_batch
        self.ckpt = AsyncCheckpointer(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = checkpoint_every
        self.prefetch_depth = prefetch_depth
        self.num_workers = num_workers
        self.skip_steps = skip_steps
        self.metrics_history: list[dict] = []
        #: per trained step: {"wait_s", "load_s", "compute_s"}
        self.step_times: list[dict] = []
        self.load_time_s = 0.0
        self.compute_time_s = 0.0
        self.wait_time_s = 0.0
        self._stager = (PinnedBatchStager(self.device)
                        if self.device.type == "cuda" else None)

    # -- fault tolerance -------------------------------------------------------

    @classmethod
    def try_restore(cls, checkpoint_dir, state_template, plan_hash: str | None = None, *,
                    shardings=None):
        """Returns (state, resume_step) — (template, 0) when no checkpoint.

        ``resume_step`` comes from the checkpoint's plan cursor.  When both
        ``plan_hash`` and the checkpoint record one, a mismatch raises —
        resuming a mid-plan cursor against a *different* plan would train
        the wrong sample sequence.  ``shardings`` restores onto the current
        mesh (``restore_checkpoint``'s elastic restore).
        """
        path = latest_checkpoint(checkpoint_dir) if checkpoint_dir else None
        if path is None:
            return state_template, 0
        state, meta = restore_checkpoint(path, state_template, shardings=shardings)
        saved_hash = meta.get("extra", {}).get("plan_hash")
        if plan_hash and saved_hash and plan_hash != saved_hash:
            raise ValueError(
                f"checkpoint {path} was written against plan {saved_hash}, "
                f"but the current pipeline executes plan {plan_hash} — "
                "refusing to resume a cursor into a different plan"
            )
        step, _cursor = resume_cursor(meta)
        return state, step

    # -- main loop -------------------------------------------------------------

    def _to_device(self, batch: dict) -> dict:
        """The host batch on the device, traced as ``batch.stage`` (a =
        bytes staged; on the card the stager's wait for its set's previous
        copy included)."""
        tr = obs_trace.get()
        t0 = tr.t()
        if self._stager is not None:
            out = self._stager(batch)
        else:
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                   for k, v in batch.items()}
        if tr.enabled:
            tr.rec(obs_trace.BATCH_STAGE, t0,
                   a=sum(int(np.asarray(v).nbytes) for v in batch.values()))
        return out

    def run(self, max_steps: int | None = None):
        if isinstance(self.loader, PrefetchExecutor):
            executor = self.loader
        elif self.prefetch_depth > 0:
            executor = PrefetchExecutor(
                self.loader,
                depth=self.prefetch_depth,
                num_workers=self.num_workers,
            )
        else:  # prefetch_depth=0: fully synchronous loading
            executor = None
        source = executor if executor is not None else self.loader
        global_step = 0
        # Plan-first resume: replay the skipped steps' buffer deltas instead
        # of re-reading their data.
        fast_forward = getattr(source, "fast_forward", None)
        if self.skip_steps and fast_forward is not None:
            fast_forward(self.skip_steps)
            global_step = self.skip_steps
        tr = obs_trace.get()
        if executor is not None:
            executor.first_step = global_step  # its batches' trace stamps
        batches = iter(source)
        try:
            while True:
                tw = time.perf_counter()
                sb = next(batches, None)
                if sb is None:
                    break
                if global_step < self.skip_steps:
                    global_step += 1
                    continue
                tr.set_step(global_step)
                t0 = time.perf_counter()
                self.wait_time_s += t0 - tw
                batch = self._to_device(self.make_batch(sb))
                t1 = time.perf_counter()
                tr.rec(obs_trace.TRAIN_MAKE_BATCH, t0, t1)
                self.state, metrics = self.step_fn(self.state, batch)
                names = list(metrics)
                # one copy to the host, which waits for the step's loss
                values = torch.stack(
                    [metrics[k].detach().to(torch.float64) for k in names]).cpu()
                t2 = time.perf_counter()
                tr.rec(obs_trace.TRAIN_COMPUTE, t1, t2)
                self.load_time_s += t1 - t0
                self.compute_time_s += t2 - t1
                self.step_times.append({"wait_s": t0 - tw, "load_s": t1 - t0,
                                        "compute_s": t2 - t1})
                rec = dict(zip(names, values.tolist()))
                rec["step"] = global_step
                self.metrics_history.append(rec)
                global_step += 1
                if (
                    self.ckpt
                    and self.checkpoint_every
                    and global_step % self.checkpoint_every == 0
                ):
                    self.ckpt.save(
                        global_step,
                        self.state,
                        extra=plan_cursor_extra(
                            global_step, sb.epoch, sb.step,
                            plan_hash=getattr(self.loader, "config_hash", None),
                        ),
                    )
                if max_steps is not None and global_step >= max_steps:
                    break
        finally:
            if executor is not None:
                executor.close()
        if self.ckpt:
            self.ckpt.wait()
        return self.state

    def breakdown(self) -> dict:
        """Paper Fig. 3-style time split (loader wall time includes PFS reads
        performed on the prefetch thread, which overlap compute)."""
        total = self.load_time_s + self.compute_time_s
        return {
            "load_s": round(self.load_time_s, 4),
            "compute_s": round(self.compute_time_s, 4),
            "wait_s": round(self.wait_time_s, 4),
            "load_frac": round(self.load_time_s / total, 4) if total else 0.0,
            "loader_internal": self.loader.report.summary(),
        }
