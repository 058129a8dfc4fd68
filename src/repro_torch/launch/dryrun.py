"""Multi-pod dry run: reckon every (arch x shape) cell's per-device program on
the production mesh and derive roofline terms in an H100's constants.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
        --shape train_4k --multi-pod both --out results/dryrun.json

The port of ``repro.launch.dryrun``, which lowers and compiles each cell for
512 host devices.  Here one process owns PyTorch's fake process group of
256 (16x16) or 512 (2x16x16) ranks, the train state is meta DTensors in
``param_sharding``'s layout on ``make_production_mesh(device="cpu")``, and
rank 0's program runs on meta tensors under ``op_analysis.program_stats``:
the port's own sharded train step (``make_train_step(mesh=)``), or prefill
or one decode step over the FSDP-gathered params (``fsdp.gathered``) on the
data rank's rows.  Nothing is allocated and nothing is launched; the
default ``--attn-impl pallas`` reckons the program the card runs (the
hand-written kernels through their meta path, ``kernels/work.py``), ``ref``
the plain paths.  Nothing is set and no group is opened at import.

Executing a full-depth step of every microbatch on meta tensors costs as many
dispatched ops as on the card (hundreds of thousands for a large model).
The dry run reckons the counts (FLOPs, bytes, collectives, kernel work) of
one and two microbatches at three depths and scales them exactly: a step is
``accum`` equal microbatches plus the update, so each count is ``f(L, A) =
g(L) + (A - 1)·h(L)``, and ``g`` and ``h`` are quadratic in the depth ``L``
of a layer stack: each layer runs the same ops, and the backward of the
model's per-layer slice of a stacked leaf (``leaf[i]``) writes a zero
gradient of the whole stack for each layer, which autograd then sums (the
port's one cost of order L², a follow-up).  With a ``scan_block`` the depths
are 2, 3 and 4 times it, so the two-level remat keeps its shape; the first
depth is 2 because at one layer no layer's gathered weights outlive the
next gather.  The peak memory is a maximum over the program's course, not a
sum, and changes slope with depth, so it is taken from the program at the
config's depths with ``min(accum, 2)`` microbatches (after the first, every
microbatch leaves the same peak above the arguments); that program's counts
must equal the scaled ones, a check of the scaling on every cell.  The
eager counterpart of JAX's trip-count weighting;
``tests/test_torch_dryrun.py`` holds it equal to the full reckoning.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from fractions import Fraction

__all__ = ["analyze_cell", "fake_world", "clamp_accum", "cell_program", "reckon", "impls",
           "fmt_row", "main"]

#: per-device memory of an H100 80GB, in the 1e9 bytes the report uses
CARD_GB = 80.0


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks (this process rank 0, no
    communication) for the block; an already live fake group of that size
    is used as it is.  Refuses any other live default group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            yield
            return
        raise RuntimeError(
            f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is "
            f"live: the dry run needs its own fake group of {world} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def clamp_accum(cfg, shape, chips: int, model_axis: int) -> int:
    """``repro.launch.dryrun``'s clamp: microbatches must still cover every
    data-parallel shard, so grad_accum is cut until the global batch divides
    into ``accum`` microbatches of at least one row per data rank."""
    dp = chips // model_axis
    accum = max(1, min(cfg.grad_accum, shape.global_batch // dp))
    while shape.global_batch % (accum * dp) and accum > 1:
        accum -= 1
    return accum


def impls(attn_impl: str) -> dict:
    """The model's ``attn_impl``, ``ssm_impl`` and ``norm_impl`` for
    ``--attn-impl``: the kernels (``pallas``) or the plain paths (``ref``)."""
    if attn_impl not in ("pallas", "ref"):
        raise ValueError(f"--attn-impl is pallas (the kernels) or ref, not {attn_impl!r}")
    return {"attn_impl": attn_impl, "ssm_impl": attn_impl, "norm_impl": attn_impl}


def _opt_cfg(cfg):
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(state_dtype=cfg.opt_state_dtype)


def _depth_knobs(cfg) -> tuple:
    """The config fields that are layer-stack depths."""
    return ("encoder_layers", "num_layers") if cfg.family == "encdec" else ("num_layers",)


def _base_depth(cfg) -> int:
    k = cfg.scan_block
    return k if k and cfg.remat and cfg.num_layers % k == 0 else 1


def _train_program(cfg, shape, mesh, impls):
    """(fn, args) of rank 0's sharded train step on a meta state (the
    unsharded step where ``mesh`` is None)."""
    from repro_torch.launch import specs
    from repro_torch.models import encdec, lm
    from repro_torch.train.step import make_train_step

    ocfg = _opt_cfg(cfg)
    state = specs.state_specs(cfg, ocfg, mesh=mesh)
    batch = specs.train_specs(cfg, shape)
    if cfg.family == "encdec":
        def loss(p, b):
            return encdec.train_loss(lm.nested_params(p), b, cfg,
                                     attn_impl=impls["attn_impl"])
    else:
        def loss(p, b):
            return lm.train_loss(lm.nested_params(p), b, cfg, **impls)
    return make_train_step(cfg, ocfg, loss, mesh=mesh), (state, batch)


def _view(cfg, params, mesh, rows: int):
    """Rank 0's view of the DTensor params for a batch of ``rows`` global
    rows (``fsdp.gathered`` with the split plan), nested; plain params as
    they are where ``mesh`` is None."""
    from repro_torch.distributed import fsdp, tensor_parallel
    from repro_torch.models import lm

    if mesh is None:
        return lm.nested_params(params)
    dims = fsdp.batch_mesh_dims(rows, mesh)
    local = {k: fsdp.local(p) for k, p in params.items()}
    plan = tensor_parallel.split_plan(cfg, params, mesh)
    return lm.nested_params(fsdp.gathered(local, params, mesh, dims, plan))


def _local_shape(shape, mesh):
    """The data rank's part of ``shape``'s batch (the rows ``fsdp.local_rows``
    gives it; all of it where ``mesh`` is None)."""
    import dataclasses

    from repro_torch.distributed import fsdp

    if mesh is None:
        return shape
    parts = 1
    for d in fsdp.batch_mesh_dims(shape.global_batch, mesh):
        parts *= mesh.size(d)
    return dataclasses.replace(shape, global_batch=shape.global_batch // parts)


def _serve_program(cfg, shape, mesh, impls, model_axis=None):
    """(fn, args) of rank 0's prefill or decode step: its view of the
    params (split along ``model`` as the plan says), the data rank's rows
    and (decode) its cache, full to its last position, built for
    ``model_axis`` (the mesh's by default) and holding rank 0's kv heads
    (or its block of the slots, ``tensor_parallel.cache_block``) and
    channels where they split."""
    import torch

    from repro_torch.distributed import tensor_parallel
    from repro_torch.launch import specs
    from repro_torch.models import encdec, lm

    params = specs.state_specs(cfg, _opt_cfg(cfg), mesh=mesh)["params"]
    rows = shape.global_batch
    local = _local_shape(shape, mesh)
    if model_axis is None:
        model_axis = mesh.size(mesh.mesh_dim_names.index("model"))
    spec = lm.CacheSpec.build(cfg, shape.seq_len, model_axis)
    if shape.kind == "prefill":
        batch = specs.prefill_specs(cfg, local)

        def fn(params, batch):
            view = _view(cfg, params, mesh, rows)
            with torch.no_grad():
                if cfg.family == "encdec":
                    return encdec.prefill(view, batch["tokens"], batch["source"], cfg, spec,
                                          attn_impl=impls["attn_impl"])
                return lm.prefill(view, batch["tokens"], cfg, spec,
                                  patches=batch.get("patches"), **impls)
        return fn, (params, batch)

    plan = None if mesh is None else tensor_parallel.split_plan(cfg, params, mesh)
    cache, tokens, spec = specs.decode_specs(cfg, local, model_axis=model_axis, plan=plan)
    cache["pos"] = shape.seq_len - 1

    def fn(params, cache, tokens):
        view = _view(cfg, params, mesh, rows)
        with torch.no_grad():
            if cfg.family == "encdec":
                return encdec.decode_step(view, cache, tokens, cfg, spec)
            return lm.decode_step(view, cache, tokens, cfg, spec,
                                  norm_impl=impls["norm_impl"])
    return fn, (params, cache, tokens)


def cell_program(cfg, shape, mesh, impls: dict, *, model_axis=None):
    """(fn, meta args) of rank 0's program of a cell: the sharded train step
    on ``shape``'s global batch, or prefill or a decode step on the data
    rank's rows.  Where ``mesh`` is None, the one-card program: the plain
    step, or serving on the whole batch, its cache built for ``model_axis``
    (default 1).  ``impls`` gives ``attn_impl``, ``ssm_impl`` and
    ``norm_impl``."""
    if shape.kind == "train":
        return _train_program(cfg, shape, mesh, impls)
    if mesh is None and model_axis is None:
        model_axis = 1
    return _serve_program(cfg, shape, mesh, impls, model_axis)


def _stats(cfg, shape, mesh, impls, model_axis=None) -> dict:
    from repro_torch.launch.op_analysis import program_stats

    fn, args = cell_program(cfg, shape, mesh, impls, model_axis=model_axis)
    return program_stats(fn, *args)


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def _combine(points: list, weights: list) -> dict:
    """``sum(w * point)`` over the numeric leaves of stats dicts (a leaf
    missing from a point is 0), exact in rationals; a bool leaf is the
    ``and`` of the points'."""
    flats = [_flatten(p) for p in points]
    keys = list(dict.fromkeys(k for f in flats for k in f))
    out = {}
    for key in keys:
        vals = [f.get(key, 0) for f in flats]
        if all(v == {} for v in vals):
            out[key] = {}
            continue
        if all(isinstance(v, bool) for v in vals):
            out[key] = all(vals)
            continue
        total = sum((w * Fraction(v) for w, v in zip(weights, vals)), Fraction(0))
        out[key] = int(total) if total.denominator == 1 else float(total)
    return _unflatten(out)


def _lagrange(xs: list, x) -> list:
    """Weights ``w`` with ``sum(w[j] * f(xs[j])) == f(x)`` for every
    polynomial ``f`` of degree below ``len(xs)``."""
    out = []
    for j, xj in enumerate(xs):
        w = Fraction(1)
        for m, xm in enumerate(xs):
            if m != j:
                w *= Fraction(x - xm, xj - xm)
        out.append(w)
    return out


def reckon(cfg, shape, mesh, impls, *, scale: bool = True,
           model_axis=None) -> tuple[dict, dict]:
    """(per-device stats of ``cfg``'s cell, how they were reckoned).  With
    ``scale`` the counts come from programs at three depths (and, training,
    one and two microbatches of the cell's microbatch), scaled to the
    config's depths and ``grad_accum``, and the peak from the program at the
    config's depths and ``min(grad_accum, 2)`` microbatches, whose counts
    must equal the scaled ones at that many microbatches (module
    docstring); without ``scale`` the cell's program runs whole."""
    import dataclasses

    train = shape.kind == "train"
    accum = cfg.grad_accum if train else 1
    micro = dataclasses.replace(shape, global_batch=shape.global_batch // accum)

    def program(depths: dict, a: int) -> dict:
        pshape = dataclasses.replace(micro, global_batch=micro.global_batch * a)
        return _stats(cfg.replace(**depths, grad_accum=a), pshape, mesh, impls, model_axis)

    knobs = _depth_knobs(cfg)
    targets = {k: getattr(cfg, k) for k in knobs}
    if not scale:
        stats = program(targets, accum)
        return stats, {"scaled": False, "programs": 1, "ops": stats["ops"]}
    unit = _base_depth(cfg)
    xs = [2 * unit, 3 * unit, 4 * unit]
    # one knob where every stack is as deep (the counts are sums over the
    # stacks, so along the diagonal they are quadratic in the common depth)
    groups = [knobs] if len(set(targets.values())) == 1 else [(k,) for k in knobs]
    base = {k: xs[0] for k in knobs}
    depth_terms = {(): (base, Fraction(1))}
    for group in groups:
        ws = _lagrange(xs, targets[group[0]])
        depth_terms[()] = (base, depth_terms[()][1] - (1 - ws[0]))
        for x, w in zip(xs[1:], ws[1:]):
            depth_terms[group, x] = ({**base, **{k: x for k in group}}, w)
    planes = sorted({min(accum, 2), 1 if accum > 2 else min(accum, 2)})
    runs = {(key, a): program(depths, a) for key, (depths, _) in depth_terms.items()
            for a in planes}

    def at(a: int) -> dict:
        # each count is g(x) + (A - 1) h(x), g and h quadratic in each depth
        a_w = {1: Fraction(2 - a), 2: Fraction(a - 1)} if a > 1 else {1: Fraction(1)}
        keys = [(key, p) for key in depth_terms for p in a_w if a_w[p]]
        return _combine([runs[k] for k in keys],
                        [depth_terms[k[0]][1] * a_w[k[1]] for k in keys])

    out = at(accum)
    # the peak is a maximum over the program's course, not a sum: it is
    # taken at the config's depths (the part above the arguments is the same
    # for every microbatch after the first)
    peak_a = min(accum, 2)
    whole = program(targets, peak_a)
    want = _flatten(at(peak_a))
    got = _flatten(whole)
    bad = sorted(".".join(k) for k in set(want) | set(got)
                 if k != ("peak_bytes",) and want.get(k, 0) != got.get(k, 0))
    if bad:
        raise AssertionError(f"the scaled counts at {peak_a} microbatch(es) differ from "
                             f"the whole program's in {bad}")
    out["peak_bytes"] = out["argument_bytes"] + whole["peak_bytes"] - whole["argument_bytes"]
    return out, {"scaled": True, "depths": xs, "knobs": [list(g) for g in groups],
                 "accum": planes, "programs": len(runs) + 1,
                 "ops": sum(r["ops"] for r in runs.values()) + whole["ops"],
                 "checked_at_accum": peak_a}


def analyze_cell(arch: str, shape_name: str, *, multi_pod: bool,
                 overrides: dict | None = None, attn_impl: str = "pallas",
                 mesh=None, scale: bool = True) -> dict:
    """Reckon one cell; returns a result dict (or skip record).  ``mesh``
    is the production mesh (built here, in a fake group of its own, when
    None)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import specs as specs_mod

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    skip = specs_mod.cell_applicability(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": skip}
    if mesh is None:
        from repro_torch.launch.mesh import make_production_mesh

        with fake_world(512 if multi_pod else 256):
            return analyze_cell(arch, shape_name, multi_pod=multi_pod, overrides=overrides,
                                attn_impl=attn_impl, scale=scale,
                                mesh=make_production_mesh(multi_pod=multi_pod, device="cpu"))
    return _analyze(cfg, shape, mesh_name, mesh, attn_impl, scale)


def _analyze(cfg, shape, mesh_name, mesh, attn_impl, scale) -> dict:
    from repro_torch.launch.roofline import HBM_BW, analyze, link_bw, model_flops

    chips = mesh.size()
    names = tuple(mesh.mesh_dim_names)
    model_axis = mesh.size(names.index("model"))
    if shape.kind == "train":
        accum = clamp_accum(cfg, shape, chips, model_axis)
        if accum != cfg.grad_accum:
            cfg = cfg.replace(grad_accum=accum)
    t0 = time.time()
    stats, how = reckon(cfg, shape, mesh, impls(attn_impl), scale=scale)
    mshape = tuple(mesh.shape)
    bw = min(link_bw(mshape, d) for d in range(len(mshape)) if mshape[d] > 1)
    report = analyze(cfg.name, shape.name, mesh_name, chips, stats, model_flops(cfg, shape),
                     collective_bw=bw)
    gb = 1e9
    peak = stats["peak_bytes"]
    arg, out, alias = stats["argument_bytes"], stats["output_bytes"], stats["alias_bytes"]
    op_stats = {"ops": how["ops"], "dot_flops": stats["dot_flops"],
                "dot_flops_by_dtype": stats["dot_flops_by_dtype"],
                "traffic_bytes": stats["traffic_bytes"],
                "traffic_by_tag": stats["traffic_by_tag"]}
    if attn_impl == "ref":
        # the kernels keep the attention and scan interiors on chip: the
        # plain paths' round trips of those tensors vanish on the card
        by_tag = stats["traffic_by_tag"]
        interior = by_tag.get("attn_interior", 0) + by_tag.get("ssm_interior", 0)
        adj = max(stats["traffic_bytes"] - interior, 0)
        op_stats.update(kernel_adjusted_bytes=adj, kernel_adjusted_memory_s=adj / HBM_BW)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name,
        "status": "ok",
        "attn_impl": attn_impl,
        "grad_accum": cfg.grad_accum if shape.kind == "train" else None,
        "reckon_s": round(time.time() - t0, 2),
        "reckoning": how,
        "memory": {
            "argument_gb": arg / gb,
            "temp_gb": (peak - arg - out + alias) / gb,
            "output_gb": out / gb,
            "alias_gb": alias / gb,
            "per_device_gb": peak / gb,
            "fits_80gb": peak / gb <= CARD_GB,
        },
        "op_stats": op_stats,
        "kernels": stats["kernels"],
        "collectives": stats["collectives"],
        "roofline": report.row(),
    }


def fmt_row(r: dict) -> str:
    if r["status"] != "ok":
        return (f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:8s} SKIP "
                f"({r['reason']})")
    rf = r["roofline"]
    m = r["memory"]
    return (
        f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:8s} "
        f"mem={m['per_device_gb']:7.2f}GB fit={str(m['fits_80gb'])[0]} "
        f"C={rf['compute_s']*1e3:10.3f}ms M={rf['memory_s']*1e3:10.3f}ms "
        f"X={rf['collective_s']*1e3:10.3f}ms bound={rf['bottleneck']:10s} "
        f"useful={rf['useful_ratio']:.3f} mfu<={rf['mfu_bound']:.3f} "
        f"[{r['reckon_s']}s]"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="both")
    ap.add_argument("--attn-impl", choices=["pallas", "ref"], default="pallas",
                    help="pallas: the hand-written kernels (the card's program); "
                         "ref: the plain paths")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides (perf iteration)")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, list_configs
    from repro_torch.launch.mesh import make_production_mesh

    archs = list_configs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]
    overrides = json.loads(args.override) if args.override else None

    results = {}
    for mp in pods:  # one fake group and mesh a topology
        with fake_world(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp, device="cpu")
            for arch in archs:
                for shape in shapes:
                    try:
                        r = analyze_cell(arch, shape, multi_pod=mp, overrides=overrides,
                                         attn_impl=args.attn_impl, mesh=mesh)
                    except Exception as e:  # a failure here is a bug in our system
                        r = {"arch": arch, "shape": shape,
                             "mesh": "2x16x16" if mp else "16x16",
                             "status": "error", "error": f"{type(e).__name__}: {e}",
                             "trace": traceback.format_exc()[-2000:]}
                    results[arch, shape, mp] = r
                    print(fmt_row(r) if r["status"] != "error"
                          else f"{arch:24s} {shape:12s} ERROR {r['error']}", flush=True)
    ordered = [results[a, s, mp] for a in archs for s in shapes for mp in pods]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(ordered, f, indent=1)
    n_err = sum(r["status"] == "error" for r in ordered)
    print(f"\n{len(ordered)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
