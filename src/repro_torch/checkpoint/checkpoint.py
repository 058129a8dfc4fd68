"""Checkpoints in the JAX package's on-disk format.

Port of ``repro.checkpoint.checkpoint``.  A directory per step holds one
``.npy`` per leaf of the train state, named by its pytree path as the JAX
package names it (``params__enc__0__w``, ``opt__mu__enc__0__w``,
``opt__step``), ``meta.json`` (step, leaf names, the ``extra`` record) and a
terminal ``COMMITTED`` marker; ``latest_checkpoint`` skips directories
without it, so a crash mid-save never poisons a restart.

Leaves are written in the JAX layout (:mod:`repro_torch.convert`), so a
checkpoint written by either package restores in the other.  The port's
train state is ``{"params": {name: tensor}, "opt": OptState(mu, nu, step),
["ef": {name: tensor}]}``; flat names map to pytree paths by ``.`` → ``__``.
bf16 leaves are written widened to f32 (numpy has no bf16 without
``ml_dtypes``), which restores exactly into a bf16 template.

Fault-tolerance contract (as in the JAX package):
  * restore(save(state)) is bit-exact, optimizer moments included,
  * the plan cursor (:func:`plan_cursor_extra` / :func:`resume_cursor`)
    resumes the exact global batch sequence, and a recorded plan config hash
    lets the trainer refuse to resume against a different plan.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.convert import surrogate_leaf_from_jax, surrogate_leaf_to_jax
from repro_torch.optim.adamw import OptState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "AsyncCheckpointer", "plan_cursor_extra", "resume_cursor",
           "state_to_host"]

_COMMIT = "COMMITTED"


def plan_cursor_extra(
    global_step: int, epoch: int, step: int, plan_hash: str | None = None
) -> dict:
    """The checkpoint ``extra`` record for plan-cursor resume.

    ``epoch``/``step`` name the last *completed* plan position (epoch id +
    step within the epoch, i.e. ``StepBatch.epoch``/``StepBatch.step``);
    ``global_step`` is the next plan step to execute — what
    ``ScheduleExecutor.fast_forward`` takes.  ``plan_hash`` records the
    schedule's ``config_hash`` so restore can detect a changed plan.
    """
    extra = {
        "solar_step": int(global_step),  # legacy key, kept for old readers
        "plan_cursor": {
            "epoch": int(epoch),
            "step": int(step),
            "global_step": int(global_step),
        },
    }
    if plan_hash:
        extra["plan_hash"] = str(plan_hash)
    return extra


def resume_cursor(meta: dict) -> tuple[int, dict | None]:
    """Read ``(resume_step, plan_cursor | None)`` out of checkpoint meta,
    falling back through the legacy ``solar_step`` key and the bare step."""
    extra = meta.get("extra", {})
    cursor = extra.get("plan_cursor")
    if cursor is not None:
        return int(cursor["global_step"]), cursor
    return int(extra.get("solar_step", meta["step"])), None


def _jax_sort_key(name: str):
    # JAX sorts dict keys; list indices keep their order.
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split("."))


def _map_dict(d: dict, prefix: str, fn) -> dict:
    done = {n: fn(f"{prefix}__{n.replace('.', '__')}", n, d[n])
            for n in sorted(d, key=_jax_sort_key)}
    return {n: done[n] for n in d}


def _map_state(state, fn):
    """``fn(file name, flat param name or None, leaf)`` on every leaf of a
    train state, called in the JAX package's flatten order (dict keys
    sorted, ``OptState`` fields in order); returns the same structure.
    ``enc.0.w`` under ``params`` is the file ``params__enc__0__w``."""
    out = {}
    for top in sorted(state):
        sub = state[top]
        if isinstance(sub, OptState):
            out[top] = OptState(_map_dict(sub.mu, f"{top}__mu", fn),
                                _map_dict(sub.nu, f"{top}__nu", fn),
                                fn(f"{top}__step", None, sub.step))
        else:
            out[top] = _map_dict(sub, top, fn)
    return {top: out[top] for top in state}


def _leaf_to_host(name: str | None, t: torch.Tensor) -> np.ndarray:
    if name is None:  # the optimizer's step counter
        return np.asarray(t.detach().cpu().numpy(), np.int32)
    return surrogate_leaf_to_jax(name, t)


def state_to_host(state) -> list[tuple[str, np.ndarray]]:
    """The state's leaves as ``(file name, JAX-layout numpy array)``: the
    device-to-host snapshot a checkpoint writes."""
    leaves = []
    _map_state(state, lambda fname, name, t: leaves.append((fname, _leaf_to_host(name, t))))
    return leaves


def _write(directory: str, step: int, leaves, extra: dict | None) -> str:
    d = os.path.join(directory, f"step_{step:08d}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    names = []
    for fname, arr in leaves:
        if fname in names:
            raise ValueError(f"duplicate checkpoint leaf {fname}")
        names.append(fname)
        np.save(os.path.join(tmp, fname + ".npy"), arr)
    meta = {"step": step, "leaves": names, "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    return d


def save_checkpoint(directory: str, step: int, state, *, extra: dict | None = None) -> str:
    """Synchronous save of the port's train state."""
    return _write(directory, step, state_to_host(state), extra)


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, _COMMIT)):
            if best is None or int(m.group(1)) > best[0]:
                best = (int(m.group(1)), os.path.join(directory, name))
    return best[1] if best else None


def _load_leaf(path: str, fname: str, name: str | None, tmpl: torch.Tensor) -> torch.Tensor:
    arr = np.load(os.path.join(path, fname + ".npy"))
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bf16 leaf written by the JAX package (ml_dtypes) reads back as
        # 2-byte void: reinterpret the bits, widened exactly to f32
        bits = torch.from_numpy(arr.view(np.int16).copy())
        arr = bits.view(torch.bfloat16).float().numpy()
    if name is None:
        t = torch.from_numpy(np.asarray(arr, np.int32).copy())
    else:
        t = surrogate_leaf_from_jax(name, arr)
    if tuple(t.shape) != tuple(tmpl.shape):
        raise ValueError(
            f"checkpoint/template shape mismatch at {fname}: "
            f"{tuple(t.shape)} vs {tuple(tmpl.shape)}")
    return t.to(dtype=tmpl.dtype, device=tmpl.device)


def restore_checkpoint(path: str, template):
    """Restore into the structure, dtypes and devices of ``template`` (a
    train state).  Returns (state, meta)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state = _map_state(template, lambda fname, name, t: _load_leaf(path, fname, name, t))
    return state, meta


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training.

    The device-to-host snapshot happens synchronously (a consistent state);
    serialization runs on a background thread.  ``wait()`` joins the write
    in flight (call before exit / before depending on the file).
    """

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_path: str | None = None

    def save(self, step: int, state, *, extra: dict | None = None):
        host = state_to_host(state)
        self.wait()

        def work():
            try:
                self.last_path = _write(self.directory, step, host, extra)
            except BaseException as exc:  # surfaced by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
