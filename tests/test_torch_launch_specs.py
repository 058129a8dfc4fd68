"""The port's dry-run specs against the JAX package's (``tests/test_launch_specs.py``
mirrored): cell applicability, every cell's input specs (meta tensors
against ``ShapeDtypeStruct``s, shape and dtype), the train state leaf for
leaf, ``model_flops`` and the shape cells, in one process on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import list_configs as jax_list
from repro.launch import specs as JS
from repro.launch.roofline import model_flops as jax_model_flops
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.launch import specs as S
from repro_torch.launch.roofline import model_flops
from repro_torch.models.lm import padded_experts
from repro_torch.optim.adamw import AdamWConfig

torch.set_num_threads(1)

CELLS = [(a, s) for a in list_configs() for s in SHAPES]


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _same(port: dict, jax_tree: dict, skip=()) -> None:
    assert set(port) == set(jax_tree)
    for k, v in port.items():
        if k in skip:
            continue
        assert v.device.type == "meta", k
        assert (tuple(v.shape), _dtype(v)) == (tuple(jax_tree[k].shape),
                                               str(jax_tree[k].dtype)), k


def test_registries_shapes_and_properties_equal_jax():
    assert list_configs() == jax_list()
    assert SHAPES.keys() == JSHAPES.keys()
    for name, shape in SHAPES.items():
        j = JSHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
        r, jr = shape.reduced(), j.reduced()
        assert (r.seq_len, r.global_batch) == (jr.seq_len, jr.global_batch)
    for arch in list_configs():
        cfg, jcfg = get_config(arch), jax_config(arch)
        for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
            assert (c.attention_free, c.sub_quadratic) == (jc.attention_free, jc.sub_quadratic)


@pytest.mark.parametrize("arch", list_configs())
def test_cell_applicability_and_model_flops_equal_jax(arch):
    for name in SHAPES:
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert S.cell_applicability(cfg, SHAPES[name]) == \
            JS.cell_applicability(jcfg, JSHAPES[name])
        assert model_flops(cfg, SHAPES[name]) == jax_model_flops(jcfg, JSHAPES[name])


def test_skip_logic_matches_design():
    skips = {(a, s): S.cell_applicability(get_config(a), SHAPES[s]) for a, s in CELLS}
    skipped = {k for k, v in skips.items() if v}
    assert all(s == "long_500k" for _, s in skipped)
    sub_quadratic = {"hymba-1.5b", "falcon-mamba-7b"}
    assert {a for a, _ in skipped} == set(list_configs()) - sub_quadratic


@pytest.mark.parametrize("arch", list_configs())
def test_input_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in SHAPES.items():
        if shape.kind == "train":
            _same(S.train_specs(cfg, shape), JS.train_specs(jcfg, JSHAPES[name]))
        _same(S.prefill_specs(cfg, shape), JS.prefill_specs(jcfg, JSHAPES[name]))
        for model_axis in (16, 1):
            cache, tok, spec = S.decode_specs(cfg, shape, model_axis=model_axis)
            jcache, jtok, jspec = JS.decode_specs(jcfg, JSHAPES[name], model_axis=model_axis)
            assert dataclasses.astuple(spec) == dataclasses.astuple(jspec)
            _same({"t": tok}, {"t": jtok})
            # the port's cache counts positions on the host: pos is an int,
            # where JAX's is an int32 scalar
            assert cache["pos"] == 0 and isinstance(cache["pos"], int)
            assert jcache["pos"].shape == () and jcache["pos"].dtype == jnp.int32
            _same(cache, jcache, skip=("pos",))


@pytest.mark.parametrize("arch", ["llama3-405b", "falcon-mamba-7b", "hymba-1.5b",
                                  "whisper-medium"])
def test_decode_specs_no_allocation(arch):
    cfg = get_config(arch)
    shape = SHAPES["decode_32k"]
    cache, tok, spec = S.decode_specs(cfg, shape, model_axis=16)
    for k, leaf in cache.items():
        if k != "pos":
            assert leaf.device.type == "meta"
    assert tok.shape == (shape.global_batch,)
    if cfg.family == "ssm":
        assert "k" not in cache
    elif arch == "hymba-1.5b":
        assert spec.ring and spec.cache_len == cfg.sliding_window
    else:
        assert cache["k"].shape[3] == shape.seq_len


def _flat_jax(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_jax(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _padded(name: str, shape: tuple, cfg) -> tuple:
    """A JAX leaf's shape with the moe experts padded as the port pads them
    (``lm.padded_experts``)."""
    if cfg.family != "moe" or not name.startswith(("layers.router", "layers.we_")):
        return shape
    axis = 2 if name == "layers.router" else 1
    return shape[:axis] + (padded_experts(cfg),) + shape[axis + 1:]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b", "qwen2-moe-a2.7b",
                                  "whisper-medium"])
def test_state_specs_equal_jax_leaf_for_leaf(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    st = S.state_specs(cfg, AdamWConfig(state_dtype="bfloat16"))
    jst = JS.state_specs(jcfg, JaxAdamW(state_dtype="bfloat16"))
    assert set(st) == set(jst) == {"params", "opt"}
    for tree, jtree in ((st["params"], jst["params"]), (st["opt"].mu, jst["opt"].mu),
                        (st["opt"].nu, jst["opt"].nu)):
        jflat = _flat_jax(jtree)
        assert sorted(tree) == sorted(jflat)  # JAX trees sort their keys
        for name, leaf in tree.items():
            want = jflat[name]
            assert leaf.device.type == "meta"
            assert (tuple(leaf.shape), _dtype(leaf)) == \
                (_padded(name, tuple(want.shape), cfg), str(want.dtype)), name
    assert all(m.dtype == torch.bfloat16 for m in st["opt"].mu.values())
    step, jstep = st["opt"].step, jst["opt"].step
    assert (tuple(step.shape), _dtype(step)) == (tuple(jstep.shape), str(jstep.dtype))


def test_train_specs_shapes():
    shape = SHAPES["train_4k"]
    for arch in list_configs():
        cfg = get_config(arch)
        specs = S.train_specs(cfg, shape)
        assert specs["weights"].shape == (shape.global_batch,)
        total = specs["tokens"].shape[1] + (cfg.num_patches if cfg.family == "vlm" else 0)
        assert total == shape.seq_len
        assert specs["tokens"].dtype == torch.int32


def test_model_flops_scaling():
    cfg = get_config("deepseek-7b")
    tr = model_flops(cfg, SHAPES["train_4k"])
    pf = model_flops(cfg, SHAPES["prefill_32k"])
    dc = model_flops(cfg, SHAPES["decode_32k"])
    assert tr / pf == pytest.approx(3.0, rel=1e-6)
    assert dc == pytest.approx(2.0 * cfg.num_active_params() * 128, rel=1e-6)
    moe = get_config("phi3.5-moe-42b-a6.6b")
    assert model_flops(moe, SHAPES["train_4k"]) < 6.0 * moe.num_params() * (256 * 4096)


def test_state_specs_are_jax_eval_shape_free():
    """The port's state of the largest arch is meta tensors throughout (no
    storage with data), where JAX's comes from ``jax.eval_shape``."""
    st = S.state_specs(get_config("llama3-405b"), AdamWConfig(state_dtype="bfloat16"))
    leaves = list(st["params"].values()) + list(st["opt"].mu.values())
    assert all(t.device.type == "meta" for t in leaves)
    jst = JS.state_specs(jax_config("llama3-405b"), JaxAdamW(state_dtype="bfloat16"))
    assert all(isinstance(x, jax.ShapeDtypeStruct)
               for x in jax.tree_util.tree_leaves(jst["params"]))
