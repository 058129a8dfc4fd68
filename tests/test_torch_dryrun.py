"""``repro_torch.launch.dryrun`` on the CPU, on the fake process group of both
production meshes: cell status and skip records against the JAX dry run's,
the grad_accum clamp on every cell, the roofline row's keys, the scaled
reckoning against the whole program, and a sharded train step's collectives
against a hand count from ``param_sharding``."""
import dataclasses
import json
import math
import os

import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro_torch.configs import SHAPES, get_config, list_configs
from torch.distributed.tensor import Replicate

from repro_torch.distributed import fsdp, tensor_parallel
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig

torch.set_num_threads(1)

MESHES = {"16x16": False, "2x16x16": True}


@pytest.fixture(scope="module")
def jax_dryrun():
    """``repro.launch.dryrun``, imported with the ``XLA_FLAGS`` it sets on
    import put back (the JAX package here already runs on one CPU device)."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jd
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jd


def _reduced_overrides(arch: str) -> dict:
    cfg = get_config(arch)
    red = cfg.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
            if getattr(red, f.name) != getattr(cfg, f.name)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_status_and_skip_records_equal_jax(mesh_name, jax_dryrun):
    multi_pod = MESHES[mesh_name]
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh.size() == (512 if multi_pod else 256)
        for arch in list_configs():
            for shape in SHAPES:
                got = dryrun.analyze_cell(arch, shape, multi_pod=multi_pod, mesh=mesh,
                                          overrides=_reduced_overrides(arch), scale=False)
                reason = jspecs.cell_applicability(jax_config(arch), SHAPES[shape])
                if reason:  # the JAX dry run returns before it builds a mesh
                    assert got == jax_dryrun.lower_cell(arch, shape, multi_pod=multi_pod)
                    continue
                assert got["status"] == "ok", got
                assert (got["arch"], got["shape"], got["mesh"]) == (arch, shape, mesh_name)
                assert got["roofline"]["chips"] == mesh.size()
                assert got["collectives"]["ok"] and got["collectives"]["total"] > 0
                assert got["memory"]["per_device_gb"] > 0
    assert not dist.is_initialized()


def _jax_clamp(cfg, shape, chips, model_axis):
    """``src/repro/launch/dryrun.py:61-67``, as it stands there."""
    dp = chips // model_axis
    accum = cfg.grad_accum
    if shape.kind == "train":
        accum = max(1, min(cfg.grad_accum, shape.global_batch // dp))
        while shape.global_batch % (accum * dp) and accum > 1:
            accum -= 1
    return accum


@pytest.mark.parametrize("chips", [256, 512])
def test_grad_accum_clamp_equals_jax_on_every_cell(chips):
    for arch in list_configs():
        for name, shape in SHAPES.items():
            if shape.kind != "train":
                continue
            want = _jax_clamp(jax_config(arch), shape, chips, 16)
            assert dryrun.clamp_accum(get_config(arch), shape, chips, 16) == want
    # the clamp bites where the data ranks outnumber the microbatch rows
    assert dryrun.clamp_accum(get_config("llama3-405b"), SHAPES["train_4k"], 512, 16) == 8


def test_roofline_row_keys_equal_jax():
    stats = {"dot_flops_by_dtype": {"bfloat16": 2e15, "float32": 1e13},
             "dot_flops": 2.01e15, "traffic_bytes": 1e12,
             "collectives": {"total": 1e9, "ok": True}}
    row = roofline.analyze("a", "s", "16x16", 256, stats, 1e17).row()
    jrow = jroofline.analyze("a", "s", "16x16", 256, stats, 1e17).row()
    assert list(row) == list(jrow)
    for k in ("arch", "shape", "mesh", "chips", "model_flops", "device_flops",
              "useful_ratio", "coll_parse_ok"):
        assert row[k] == jrow[k], k
    # the H100's constants: f32 dots at the CUDA-core peak, the collective
    # over one 400 Gb/s port a card
    assert row["compute_s"] == pytest.approx(2e15 / 989e12 + 1e13 / 67e12)
    assert row["memory_s"] == pytest.approx(1e12 / 3.35e12)
    assert row["collective_s"] == pytest.approx(1e9 / 50e9)
    assert roofline.link_bw((16, 16), 0) == roofline.link_bw((16, 16), 1) == roofline.NET_BW
    assert roofline.link_bw((32, 8), 1) == roofline.link_bw((64, 4), 1) == roofline.NVLINK_BW


@pytest.mark.parametrize("arch,layers,accum,mesh_name", [
    ("qwen2-0.5b", 4, 2, "16x16"), ("hymba-1.5b", 4, 2, "16x16"),
    ("qwen2-moe-a2.7b", 4, 2, "16x16"), ("qwen2-0.5b", 7, 3, "2x16x16"),
    ("hymba-1.5b", 6, 3, "16x16"), ("qwen2-moe-a2.7b", 7, 3, "2x16x16")])
def test_scaled_reckoning_equals_the_whole_program(arch, layers, accum, mesh_name):
    """Counts scaled from three depths and one and two microbatches, and the
    peak from the program at the config's depth, against the whole step."""
    multi_pod = MESHES[mesh_name]
    cfg = get_config(arch).reduced().replace(num_layers=layers, grad_accum=accum)
    dp = 32 if multi_pod else 16
    shape = dataclasses.replace(SHAPES["train_4k"].reduced(), global_batch=dp * accum)
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        impls = dryrun.impls("pallas")
        scaled, how = dryrun.reckon(cfg, shape, mesh, impls)
        whole, _ = dryrun.reckon(cfg, shape, mesh, impls, scale=False)
    assert how["scaled"] and how["depths"] == [2, 3, 4]
    scaled.pop("ops"), whole.pop("ops")
    assert scaled == whole
    assert whole["kernels"]["flash_attention"]["calls"] > 0


#: reduced configs with 16 heads, which split over the 16 model ranks
SIXTEEN_HEADS = {"whisper-medium 16 heads": ("whisper-medium", dict(num_heads=16,
                                                                     num_kv_heads=16))}


@pytest.mark.parametrize("arch,shape_name", [("hymba-1.5b", "prefill_32k"),
                                             ("whisper-medium", "decode_32k"),
                                             ("whisper-medium", "train_4k"),
                                             ("hymba-1.5b", "decode_32k"),
                                             ("whisper-medium 16 heads", "decode_32k"),
                                             ("whisper-medium 16 heads", "train_4k")])
def test_scaled_serving_and_encdec_equal_the_whole_program(arch, shape_name):
    """Among them reduced hymba's prefill and decode caches (4 heads, 2 kv
    heads: its ring of 32 slots splits into 2 a rank at 16) and a whisper
    whose heads split at 16, in both stacks and both caches."""
    arch, over = SIXTEEN_HEADS.get(arch, (arch, {}))
    base = get_config(arch).reduced().replace(**over)
    cfg = base.replace(num_layers=6, grad_accum=3 if shape_name == "train_4k" else 1,
                       **({"encoder_layers": 5} if base.encoder_layers else {}))
    rows = 16 * cfg.grad_accum
    shape = dataclasses.replace(SHAPES[shape_name].reduced(), global_batch=rows)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        scaled, how = dryrun.reckon(cfg, shape, mesh, dryrun.impls("pallas"))
        whole, _ = dryrun.reckon(cfg, shape, mesh, dryrun.impls("pallas"), scale=False)
        plan = tensor_parallel.split_plan(cfg, specs.state_specs(cfg, AdamWConfig())["params"],
                                          mesh)
    scaled.pop("ops"), whole.pop("ops")
    assert scaled == whole
    assert len(how["knobs"]) == (2 if base.encoder_layers else 1)
    assert plan.attention == bool(over)
    if base.family != "encdec":   # which keeps a cache of unsplit heads whole
        spec = lm.CacheSpec.build(cfg, shape.seq_len, 16)
        assert tensor_parallel.cache_block(plan, spec) is not None   # prefill's too


def _gather_bytes(shape, placements, mesh, itemsize):
    """All-gather result bytes of ``fsdp._gather`` of a shard: innermost
    sharded mesh dim first, each result the shard grown by that dim."""
    x, total = list(shape), 0
    for d in reversed(range(mesh.ndim)):
        p = placements[d]
        if mesh.size(d) > 1 and p.is_shard():
            x[p.dim] *= mesh.size(d)
            total += math.prod(x) * itemsize
    return total


def _reduce_bytes(shape, placements, mesh, reduce_dims, itemsize):
    """(reduce-scatter, all-reduce) result bytes of ``fsdp._reduce_to_shard``
    of a whole gradient: outermost mesh dim first."""
    x, rs, ar = list(shape), 0, 0
    for d in range(mesh.ndim):
        p, n = placements[d], mesh.size(d)
        if n == 1:
            continue
        if p.is_shard():
            x[p.dim] //= n
            if d in reduce_dims:
                rs += math.prod(x) * itemsize
        elif d in reduce_dims:
            ar += math.prod(x) * itemsize
    return rs, ar


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_train_cell_collectives_equal_a_hand_count(mesh_name):
    """Per microbatch each stacked leaf is gathered a layer at a time in the
    forward and again in remat's recompute and reduced once in the backward,
    every other leaf gathered and reduced once; the step all-reduces Σw and
    the loss over the data dims and each leaf's squared norm over every mesh
    dim.  Reduced qwen2-0.5b's MLP hidden (128) and vocabulary (256) split
    over the 16 model ranks, its 4 heads do not: the split leaves are
    gathered and reduced over the data dims only, as their model blocks, and
    each microbatch all-reduces over ``model`` the embedding rows, each
    layer's MLP output and its input's gradient (remat's recompute stops
    before the MLP's all-reduce: the backward keeps nothing computed after
    it), the final hidden state's gradient, and each CE chunk's row max,
    Σexp and target logit (forward and recompute)."""
    multi_pod = MESHES[mesh_name]
    arch, accum = "qwen2-0.5b", 2
    cfg = get_config(arch).reduced().replace(num_layers=3, grad_accum=accum)
    assert cfg.remat and not cfg.scan_block
    rows = (32 if multi_pod else 16) * accum
    shape = dataclasses.replace(SHAPES["train_4k"].reduced(), global_batch=rows)
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        stats, _ = dryrun.reckon(cfg, shape, mesh, dryrun.impls("pallas"))
        state = specs.state_specs(cfg, AdamWConfig(state_dtype=cfg.opt_state_dtype),
                                  mesh=mesh)
        reduce_dims = fsdp.batch_mesh_dims(rows, mesh)
        plan = tensor_parallel.split_plan(cfg, state["params"], mesh)
        assert (plan.attention, plan.mlp, plan.mamba, plan.vocab) == (False, True, False, True)
        md = mesh.mesh_dim_names.index("model")
        gather = rs = ar = 0
        for name, p in state["params"].items():
            it = p.element_size()
            placements, whole = tuple(p.placements), list(p.shape)
            if name in plan.leaves:  # the model block, as if replicated over model
                assert plan.leaves[name][1] == tensor_parallel.LOCAL
                whole[placements[md].dim] //= mesh.size(md)
                placements = placements[:md] + (Replicate(),) + placements[md + 1:]
            if fsdp._per_layer(name, p):
                placements = fsdp._drop_leading(placements)
                uses, gathers = cfg.num_layers, 2 * cfg.num_layers
                local, whole = fsdp.local(p).shape[1:], whole[1:]
            else:
                uses = gathers = 1
                local = fsdp.local(p).shape
            gather += gathers * _gather_bytes(local, placements, mesh, it)
            r, a = _reduce_bytes(whole, placements, mesh, reduce_dims, it)
            rs, ar = rs + uses * r, ar + uses * a
        live = [d for d in range(mesh.ndim) if mesh.size(d) > 1]
        n_leaves = len(state["params"])
        step_ar = 8 * len([d for d in reduce_dims if mesh.size(d) > 1]) \
            + 4 * n_leaves * len(live)
        # f32 activations of one row a data rank a microbatch; one CE chunk
        b, s = rows // accum // math.prod(mesh.size(d) for d in reduce_dims), shape.seq_len
        assert cfg.ce_chunk >= s and cfg.compute_dtype == "float32"
        model_ar = 4 * b * s * cfg.d_model * (1 + 2 * cfg.num_layers + 1) + 4 * b * s * 6
    coll = stats["collectives"]
    assert coll["all-gather"] == accum * gather
    assert coll["reduce-scatter"] == accum * rs
    assert coll["all-reduce"] == accum * (ar + model_ar) + step_ar
    assert coll["all-to-all"] == coll["collective-permute"] == 0


def test_cli_writes_a_row_a_cell(tmp_path, capsys):
    out = tmp_path / "dry.json"
    override = json.dumps(_reduced_overrides("hymba-1.5b"))
    assert dryrun.main(["--arch", "hymba-1.5b,qwen2-0.5b", "--shape", "decode_32k,long_500k",
                        "--multi-pod", "off", "--override", override, "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["shape"], r["status"]) for r in rows] == [
        ("hymba-1.5b", "decode_32k", "ok"), ("hymba-1.5b", "long_500k", "ok"),
        ("qwen2-0.5b", "decode_32k", "ok"), ("qwen2-0.5b", "long_500k", "skipped")]
    ok = rows[0]
    assert set(ok) >= {"memory", "op_stats", "collectives", "kernels", "roofline", "reckoning"}
    assert set(ok["memory"]) == {"argument_gb", "temp_gb", "output_gb", "alias_gb",
                                 "per_device_gb", "fits_80gb"}
    assert "kernel_adjusted_bytes" not in ok["op_stats"]  # only under --attn-impl ref
    assert "4 cells, 0 errors" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_ref_reckons_the_plain_paths_and_their_kernel_adjusted_bytes(monkeypatch):
    import repro_torch.configs

    monkeypatch.setitem(repro_torch.configs.SHAPES, "prefill_32k", dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=512))
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        ov = _reduced_overrides("hymba-1.5b")
        ref = dryrun.analyze_cell("hymba-1.5b", "prefill_32k", multi_pod=False, mesh=mesh,
                                  overrides=ov, attn_impl="ref")
        ker = dryrun.analyze_cell("hymba-1.5b", "prefill_32k", multi_pod=False, mesh=mesh,
                                  overrides=ov)
    assert ref["kernels"] == {} and set(ker["kernels"]) == {
        "flash_attention", "selective_scan", "rms_norm"}
    tags = ref["op_stats"]["traffic_by_tag"]
    assert tags["attn_interior"] > 0 and tags["ssm_interior"] > 0
    assert ref["op_stats"]["kernel_adjusted_bytes"] == \
        ref["op_stats"]["traffic_bytes"] - tags["attn_interior"] - tags["ssm_interior"]


def test_another_live_group_is_refused():
    with dryrun.fake_world(8):
        with pytest.raises(RuntimeError, match="its own fake group of 256"):
            dryrun.analyze_cell("qwen2-0.5b", "decode_32k", multi_pod=False)
    assert not dist.is_initialized()
