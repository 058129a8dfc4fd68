"""The port's sharding rule engine against the JAX package's, in one
process: the 8 tests of ``tests/test_sharding.py`` on the same faked 16x16
and 2x16x16 meshes (the rules read only axis names and sizes), then every
leaf of all ten archs at full size, the ``train_specs``-shaped batches and
each arch's decode cache at ``model_axis`` 16, spec for spec; DTensor
placements against numpy blocks, and the production meshes on the fake
process group.

Shapes come from ``jax.eval_shape`` (nothing is allocated) and the port's
caches from ``init_cache`` on the meta device.  The JAX package's
``NamedSharding`` needs a real mesh, so its ``param_sharding``,
``batch_sharding`` and ``cache_sharding`` run here with it patched to
return the bare ``PartitionSpec``.
"""
import functools
import math
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import list_configs
from repro.configs.base import SHAPES
from repro.configs import get_config as jax_config
from repro.distributed import sharding as JS
from repro.launch import specs as jspecs
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm

torch.set_num_threads(1)


def fake_mesh(shape, names):
    return types.SimpleNamespace(
        axis_names=names, devices=np.empty(shape), shape=dict(zip(names, shape))
    )


POD = fake_mesh((2, 16, 16), ("pod", "data", "model"))
SINGLE = fake_mesh((16, 16), ("data", "model"))
MESHES = {"16x16": SINGLE, "2x16x16": POD}
P = S.PartitionSpec


def spec_for(path, shape, mesh=SINGLE):
    return S._spec_for(path, shape, mesh)


# -- tests/test_sharding.py, leaf names as the port writes them ----------------------


def test_llama_attention_rules():
    assert spec_for("layers.wq", (126, 16384, 128, 128)) == P(None, "data", "model", None)
    assert spec_for("layers.wq", (126, 16384, 128, 128), POD) == P(
        None, ("pod", "data"), "model", None)
    # wk with K=8 (not divisible by 16): TP axis dropped, FSDP kept
    assert spec_for("layers.wk", (126, 16384, 8, 128)) == P(None, "data", None, None)
    assert spec_for("layers.wo", (126, 128, 128, 16384)) == P(None, "model", None, "data")


def test_awkward_head_counts_degrade_gracefully():
    assert spec_for("layers.wq", (32, 1600, 25, 64)) == P(None, "data", None, None)
    assert spec_for("layers.wk", (24, 896, 2, 64)) == P(None, "data", None, None)


def test_embedding_rules_single_axis():
    assert spec_for("embed", (128256, 16384)) == P("model", None)
    assert spec_for("unembed", (16384, 128256)) == P(None, "model")
    assert spec_for("embed", (51865, 1024))[0] is None  # odd vocab: unsharded


def test_moe_expert_parallel():
    assert spec_for("layers.we_gate", (32, 16, 4096, 6400)) == P(None, "model", "data", None)
    assert spec_for("layers.we_down", (24, 64, 1408, 2048)) == P(None, "model", None, "data")


def test_ssm_rules():
    assert spec_for("layers.ssm.in_proj", (64, 4096, 16384)) == P(None, "data", "model")
    assert spec_for("layers.ssm.out_proj", (64, 8192, 4096)) == P(None, "model", "data")
    assert spec_for("layers.ssm.a_log", (64, 8192, 16)) == P(None, "model", None)


def test_norms_replicated():
    assert spec_for("layers.ln1", (126, 16384)) == P(None, None)
    assert spec_for("final_norm", (16384,)) == P(None)


def test_choose_spec_drops_missing_axes():
    assert S.choose_spec((128, 64), [(("pod", "data"), "model")], SINGLE) == P("data", "model")


def test_choose_spec_divisibility():
    assert S.choose_spec((100, 64), [("data", "model")], SINGLE) == P(None, "model")


# -- every leaf of every arch against the JAX engine ---------------------------------


@pytest.fixture()
def jax_bare_specs(monkeypatch):
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    cfg = jax_config(arch)
    init = jencdec.init_encdec if cfg.family == "encdec" else jlm.init_lm
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))


def _jax_specs(tree):
    """{dotted leaf name: spec tuple} of a JAX tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {JS._path_str(p).replace("/", "."): tuple(s) for p, s in flat}


def _port_specs(tree):
    return {k: tuple(v.spec) for k, v in tree.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_param_specs_equal_jax_for_every_leaf(arch, mesh, jax_bare_specs):
    shapes = _param_shapes(arch)
    want = _jax_specs(JS.param_sharding(shapes, MESHES[mesh]))
    got = _port_specs(S.param_sharding(lm.flat_params(shapes), MESHES[mesh]))
    assert got == want
    # ...and the stacked leaves' layer axis is never split
    assert all(s[0] is None for k, s in got.items() if k.split(".")[0].endswith("layers"))


@pytest.mark.parametrize("rows", [256, 24, 3])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_batch_specs_equal_jax(arch, mesh, rows, jax_bare_specs):
    cfg = jax_config(arch)
    shape = SHAPES["train_4k"]
    batch = jspecs.train_specs(cfg, type(shape)(shape.name, shape.seq_len, rows, shape.kind))
    want = _jax_specs(JS.batch_sharding(batch, MESHES[mesh]))
    assert _port_specs(S.batch_sharding(batch, MESHES[mesh])) == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_cache_specs_equal_jax_at_model_axis_16(arch, mesh, jax_bare_specs):
    jcfg, cfg = jax_config(arch), get_config(arch)
    shape = SHAPES["decode_32k"]
    jcache, _, jspec = jspecs.decode_specs(jcfg, shape, model_axis=16)
    want = _jax_specs(JS.cache_sharding(jcache, MESHES[mesh], kv_heads=jspec.kv_heads))
    if cfg.family == "encdec":  # the port builds its cache in prefill
        cache = dict(jcache)
    else:
        spec = lm.CacheSpec.build(cfg, shape.seq_len, 16)
        assert spec.kv_heads == jspec.kv_heads
        cache = lm.init_cache(cfg, spec, shape.global_batch, device="meta")
        assert {k: tuple(v.shape) for k, v in cache.items() if k != "pos"} == \
            {k: tuple(v.shape) for k, v in jcache.items() if k != "pos"}
    got = _port_specs(S.cache_sharding(cache, MESHES[mesh], kv_heads=jspec.kv_heads))
    assert got == want


# -- placements and meshes on the fake process group --------------------------------


@pytest.fixture()
def fake_world():
    """``fake_world(world, rank)``: a fake process group of ``world`` ranks
    seen as ``rank`` (no communication), torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world, rank=0):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _numpy_block(full, spec, sizes, coord):
    index = []
    for dim, entry in enumerate(spec):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        i, parts = 0, 1
        for n in names:
            i, parts = i * sizes[n] + coord[n], parts * sizes[n]
        n = full.shape[dim] // parts
        index.append(slice(i * n, (i + 1) * n))
    return full[tuple(index)]


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data", "model"))])
def test_to_placements_gives_pod_major_blocks(fake_world, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    full = np.arange(8 * 4 * 8).reshape(8, 4, 8)
    fsdp = tuple(n for n in ("pod", "data") if n in names)
    specs = [P(fsdp, "model", None), P(None, fsdp, "model"), P("model", None, fsdp)]
    sizes = dict(zip(names, shape))
    for rank in range(math.prod(shape)):
        fake_world(math.prod(shape), rank)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        coord = dict(zip(names, mesh.get_coordinate()))
        for spec in specs:
            placements = S.to_placements(spec, mesh)
            lshape, offset = compute_local_shape_and_global_offset(full.shape, mesh,
                                                                   placements)
            got = full[tuple(slice(o, o + n) for o, n in zip(offset, lshape))]
            np.testing.assert_array_equal(got, _numpy_block(full, spec, sizes, coord))


def test_to_placements_refuses_what_dtensor_cannot_order(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    assert S.to_placements(P(("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="order"):
        S.to_placements(P(("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="two dims"):
        S.to_placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="not on the mesh"):
        S.to_placements(P("expert"), mesh)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_the_fake_process_group(fake_world, multi_pod):
    world = 512 if multi_pod else 256
    fake_world(world)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert mesh.mesh_dim_names == names
    assert mesh.shape == ((2, 16, 16) if multi_pod else (16, 16))
    assert S._axes(mesh) == dict(zip(names, mesh.shape))
    # the rules give the same specs on the real mesh as on the fake one
    assert S._spec_for("layers.wq", (126, 16384, 128, 128), mesh) == \
        S._spec_for("layers.wq", (126, 16384, 128, 128), MESHES["2x16x16" if multi_pod
                                                                 else "16x16"])
    with pytest.raises(ValueError, match="ranks"):
        make_production_mesh(multi_pod=not multi_pod, device="cpu")


def test_production_mesh_needs_a_process_group_and_a_card(monkeypatch):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()


@pytest.mark.parametrize("model_axis", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", list_configs())
def test_cache_spec_kv_heads_equal_jax(arch, model_axis):
    for reduce in (False, True):
        cfg, jcfg = get_config(arch), jax_config(arch)
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        got = lm.CacheSpec.build(cfg, 64, model_axis)
        want = jlm.CacheSpec.build(jcfg, 64, model_axis)
        assert (got.kv_heads, got.cache_len, got.ring, got.quantized) == \
            (want.kv_heads, want.cache_len, want.ring, want.quantized)
