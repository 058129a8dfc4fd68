"""Rank side of ``tests/test_torch_sharded_train.py`` and the tests of the
split along ``model`` (``tests/test_torch_tensor_parallel.py``,
``test_torch_expert_parallel.py``, ``test_torch_encdec_parallel.py``), and
their shared checks: each spawned process joins a gloo
group of 4, runs the jobs it is handed on its meshes and puts its local
results (numpy) on a queue.  Imports torch and the port only, so a rank
starts without JAX.

The meshes: ``("data", "model")`` = (2, 2); ``("pod", "data", "model")`` =
(2, 2, 1); and ``("replica", "data", "model")`` = (2, 1, 2), on which each
pair of model ranks trains the whole batch on its own (the rule engine
knows no ``replica`` axis, so every leaf and the batch are replicated over
it): the same split arithmetic as (2, 2) with no data axis."""
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


def block_of(full, spec, coord):
    """A rank's block of ``full`` under ``spec`` on the (2, 2) mesh."""
    index = []
    for dim, entry in enumerate(tuple(spec) + (None,) * (full.ndim - len(spec))):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        i, parts = 0, 1
        for n in names:
            i, parts = i * 2 + coord[n], parts * 2
        n = full.shape[dim] // parts
        index.append(slice(i * n, (i + 1) * n))
    return full[tuple(index)]


def assert_shards(results, job, want, tol, names=("params", "mu", "nu")):
    """Every rank's shard of every leaf of ``want`` ({part: {leaf: whole
    array}}) within ``tol`` of its leaf's max |value|."""
    for rank, out in results.items():
        for name in names:
            for k, full in want[name].items():
                got = out[job][name][k].astype(np.float32)
                ref = block_of(full, out[job]["specs"][k], out["coord"])
                assert got.shape == ref.shape, (rank, name, k, got.shape, ref.shape)
                scale = max(float(np.abs(full).max()), 1e-30)
                err = float(np.abs(got - ref).max())
                assert err <= tol * scale, \
                    f"rank {rank} {name} {k}: {err:.3e} > {tol} * {scale:.3e}"


def _numpy(t):
    from repro_torch.convert import tensor_to_numpy
    from repro_torch.distributed.fsdp import local

    return tensor_to_numpy(local(t).detach())


def _config(job):
    from repro_torch.configs import get_config

    return get_config(job["arch"]).reduced().replace(**job.get("overrides", {}))


def _recording(seen: dict):
    """Patch the model's attention, selective scan, moe layer and router to
    record, per call, (query heads, kv heads), the scan's channels, the
    experts the moe layer's expert leaves hold and the router's expert
    choices; returns the undo."""
    from repro_torch.models import layers as L

    attention, scan, moe, route = L.attention, L._selective_scan, L.moe_layer, L.route

    def rec_attention(q, k, v, **kw):
        seen.setdefault("attention", []).append((int(q.shape[1]), int(k.shape[1])))
        return attention(q, k, v, **kw)

    def rec_scan(u, *a, **kw):
        seen.setdefault("scan", []).append(int(u.shape[-1]))
        return scan(u, *a, **kw)

    def rec_moe(x, router_w, we_gate, *a, **kw):
        seen.setdefault("experts", []).append(int(we_gate.shape[0]))
        return moe(x, router_w, we_gate, *a, **kw)

    def rec_route(x, router_w, **kw):
        out = route(x, router_w, **kw)
        seen.setdefault("routes", []).append(out[2].numpy().copy())
        return out

    L.attention, L._selective_scan, L.moe_layer, L.route = (rec_attention, rec_scan,
                                                            rec_moe, rec_route)

    def undo():
        L.attention, L._selective_scan, L.moe_layer, L.route = attention, scan, moe, route
    return undo


def _train(mesh, job):
    import torch

    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.models import encdec, lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = _config(job).replace(grad_accum=job["accum"])
    opt = AdamWConfig(**{**OPT, **job.get("opt", {})})
    params = lm_params_from_jax(job["params"], "cpu")
    specs = {k: tuple(s.spec) for k, s in param_sharding(params, mesh).items()}
    state = init_train_state(params, opt, mesh=mesh)
    loss = encdec.train_loss if cfg.family == "encdec" else lm.train_loss
    step = make_train_step(cfg, opt, lambda p, b: loss(lm.nested_params(p), b, cfg),
                           mesh=mesh)
    metrics, seen = [], {}
    undo = _recording(seen) if job.get("record") else None
    try:
        for batch in job["batches"]:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        if undo is not None:
            undo()
    from repro_torch.distributed.fsdp import whole

    return {"metrics": metrics, "specs": specs, "seen": seen,
            "whole": {k: _numpy(whole(state["params"][k])) for k in ("embed", "layers.wi_up")
                      if k in state["params"]},
            "params": {k: _numpy(v) for k, v in state["params"].items()},
            "mu": {k: _numpy(v) for k, v in state["opt"].mu.items()},
            "nu": {k: _numpy(v) for k, v in state["opt"].nu.items()}}


def _serve(mesh, job):
    """Prefill and ``gen`` greedy decode steps through a model rank's
    ``ServeEngine(mesh=)`` (the vlm family, which the engine refuses:
    ``lm.prefill(..., patches=)`` and ``lm.decode_step`` on the rank's
    ``local_view``; the encoder-decoder from the job's ``source``): the
    logits of each, the cache's kv heads (the cross-attention's too), slots
    and SSM channels, and what the model's attention, scan and router were
    called on."""
    import torch

    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = _config(job)
    params = lm.nested_params(lm_params_from_jax(job["params"], "cpu"))
    if cfg.family == "vlm":
        view = tp.local_view(params, tp.split_plan(cfg, lm.flat_params(params), mesh))
        spec = lm.CacheSpec.build(cfg, job["max_len"], mesh.size(
            tuple(mesh.mesh_dim_names).index("model")))
        patches = torch.from_numpy(job["patches"])

        def prefill(prompts):
            return lm.prefill(view, torch.as_tensor(prompts, dtype=torch.long), cfg, spec,
                              patches=patches)

        def step(cache, tokens):
            return lm.decode_step(view, cache, tokens, cfg, spec)
    else:
        eng = ServeEngine(cfg, params, max_len=job["max_len"], mesh=mesh, device="cpu")
        step = eng.step

        def prefill(prompts):
            return eng.prefill(prompts, job.get("source"))
    seen = {}
    undo = _recording(seen)
    try:
        with torch.no_grad():
            logits, cache = prefill(job["prompts"])
            steps = [logits.numpy()]
            for _ in range(job["gen"]):
                logits, cache = step(cache, torch.argmax(logits, dim=-1))
                steps.append(logits.numpy())
    finally:
        undo()
    return {"logits": steps, "seen": seen,
            "kv_heads": int(cache["k"].shape[2]) if "k" in cache else 0,
            "cross_kv_heads": int(cache["ck"].shape[2]) if "ck" in cache else 0,
            "slots": int(cache["k"].shape[3]) if "k" in cache else 0,
            "scale_slots": int(cache["k_scale"].shape[3]) if "k_scale" in cache else 0,
            "int8": "k" in cache and cache["k"].dtype == torch.int8,
            "ssm_channels": int(cache["ssm_h"].shape[2]) if "ssm_h" in cache else 0}


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
        replica = init_device_mesh("cpu", (2, 1, 2),
                                   mesh_dim_names=("replica", "data", "model"))
        meshes = {"pod": pod, "replica": replica}
        out = {"coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
               "pod_coord": dict(zip(pod.mesh_dim_names, pod.get_coordinate())),
               "replica_coord": dict(zip(replica.mesh_dim_names, replica.get_coordinate()))}
        for name, job in jobs.items():
            on = meshes.get(job.get("mesh") or ("pod" if job.get("pod") else ""), mesh)
            if job["kind"] == "train":
                out[name] = _train(on, job)
            elif job["kind"] == "serve":
                out[name] = _serve(on, job)
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
