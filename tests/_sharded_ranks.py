"""Rank side of ``tests/test_torch_sharded_train.py``: each spawned process
joins a gloo group of 4, runs the jobs it is handed on its meshes and puts
its local results (numpy) on a queue.  Imports torch and the port only, so
a rank starts without JAX."""
from __future__ import annotations

import traceback

import numpy as np

WORLD = 4
# AdamW's eps at 1e-3, not 1e-8: an element whose gradient is near eps
# takes a step of about g / (|g| + eps), which moves by up to a learning
# rate when the gradient changes in its last bits (a sum over ranks in
# another order): at 1e-8 the key bias of qwen2-0.5b and the embedding rows
# of rare tokens land 1e-4 of their leaf's max apart, at 1e-6 the embedding
# 4e-5.  At 1e-3 the step's sensitivity to the gradient is at most 1 / eps,
# and the params agree within 2e-7 of their max; a gradient that is wrong by
# a rank's share still moves them by ~lr.
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100, eps=1e-3)


def _numpy(t):
    from repro_torch.convert import tensor_to_numpy
    from repro_torch.distributed.fsdp import local

    return tensor_to_numpy(local(t).detach())


def _train(mesh, job):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_config(job["arch"]).reduced().replace(grad_accum=job["accum"])
    opt = AdamWConfig(**OPT)
    params = lm_params_from_jax(job["params"], "cpu")
    specs = {k: tuple(s.spec) for k, s in param_sharding(params, mesh).items()}
    state = init_train_state(params, opt, mesh=mesh)
    step = make_train_step(cfg, opt, lambda p, b: lm.train_loss(lm.nested_params(p), b, cfg),
                           mesh=mesh)
    metrics = []
    for batch in job["batches"]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "specs": specs,
            "params": {k: _numpy(v) for k, v in state["params"].items()},
            "mu": {k: _numpy(v) for k, v in state["opt"].mu.items()},
            "nu": {k: _numpy(v) for k, v in state["opt"].nu.items()}}


def _psum(mesh, job, rank):
    import torch

    from repro_torch.distributed.compression import compressed_psum

    x = torch.from_numpy(np.random.default_rng(job["seed"] + rank)
                         .standard_normal(job["shape"]).astype(np.float32))
    return {"world": compressed_psum(x).numpy(),
            "data": compressed_psum(x, mesh.get_group("data")).numpy()}


def _restore(mesh, job):
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state

    cfg = get_config(job["arch"]).reduced()
    template = init_train_state(lm.flat_params(lm.init_lm(cfg, seed=1, device="cpu")),
                                AdamWConfig(**OPT))
    shardings = param_sharding(template, mesh)
    state, meta = restore_checkpoint(job["path"], template, shardings=shardings)
    out = {"step": meta["step"], "specs": {}, "leaves": {}, "dtensor": True}
    for top, sub in (("params", state["params"]), ("mu", state["opt"].mu),
                     ("nu", state["opt"].nu)):
        sh = (shardings["params"] if top == "params"
              else getattr(shardings["opt"], top))
        for k, v in sub.items():
            out["dtensor"] &= type(v).__name__ == "DTensor"
            out["leaves"][f"{top}.{k}"] = _numpy(v)
            out["specs"][f"{top}.{k}"] = tuple(sh[k].spec)
    out["opt_step"] = int(_numpy(state["opt"].step))
    return out


def _save(mesh, job):
    """Save a sharded state synchronously and asynchronously, then both
    again into a directory rank 0 cannot make: each rank's paths and the
    errors it raised."""
    import os

    from repro_torch.checkpoint.checkpoint import AsyncCheckpointer, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state

    cfg = get_config(job["arch"]).reduced()
    state = init_train_state(lm.flat_params(lm.init_lm(cfg, seed=1, device="cpu")),
                             AdamWConfig(**OPT), mesh=mesh)
    out = {"sync": save_checkpoint(job["path"], 1, state)}
    ckpt = AsyncCheckpointer(job["path"])
    ckpt.save(2, state)
    ckpt.wait()
    out["async"] = ckpt.last_path
    for kind in ("sync", "async"):
        out[f"{kind}_committed"] = os.path.exists(os.path.join(out[kind], "COMMITTED"))
    for kind in ("sync_error", "async_error"):
        out[kind] = None
        try:
            if kind == "sync_error":
                save_checkpoint(job["bad"], 1, state)
            else:
                bad = AsyncCheckpointer(job["bad"])
                bad.save(1, state)
                bad.wait()
        except Exception as exc:  # noqa: BLE001 - the test reads which
            out[kind] = f"{type(exc).__name__}: {exc}"
    return out


def run_rank(rank: int, init_file: str, jobs: dict, queue) -> None:
    """Join the group, build the meshes, run ``jobs``; put ``(rank, result)``
    on ``queue`` (``(rank, traceback string)`` on a failure)."""
    try:
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                world_size=WORLD, rank=rank)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        pod = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
        out = {"coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
               "pod_coord": dict(zip(pod.mesh_dim_names, pod.get_coordinate()))}
        for name, job in jobs.items():
            if job["kind"] == "train":
                out[name] = _train(pod if job.get("pod") else mesh, job)
            elif job["kind"] == "psum":
                out[name] = _psum(mesh, job, rank)
            elif job["kind"] == "restore":
                out[name] = _restore(mesh, job)
            elif job["kind"] == "save":
                out[name] = _save(mesh, job)
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:  # the parent fails the test with it
        queue.put((rank, traceback.format_exc()))
