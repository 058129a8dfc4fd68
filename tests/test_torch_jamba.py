"""The port's interleaved family (AI21-Jamba2-3B, ``configs/jamba2_3b.py``)
on the CPU in float32: the published layer order, a layer's leaves being
those of its kind only, the parameter count, the dt/B/C norms, attention
without positions, the block spans, and the paths that refuse the family.
The family is the port's own: ``list_configs`` stays the JAX package's list.
Its loss and gradients against the plain reference are in
``bench/test_bench_jamba.py``."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.configs import list_configs as jax_list
from repro_torch.configs import (InterleavedConfig, ModelConfig, get_config, list_configs,
                                 port_only_configs)
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import lm
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(1)

ARCH = "jamba2-3b"
B, S = 2, 16


@pytest.fixture(autouse=True)
def _no_tracer():
    obs_trace.disable()
    yield
    obs_trace.disable()


def _noisy_params(cfg, seed=0, noise=0.05):
    """``init_lm``'s params with seeded noise on every leaf, so that a zero
    norm scale or bias hides nothing."""
    params = lm.init_lm(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for leaf in lm.flat_params(params).values():
        leaf.add_(noise * torch.randn(leaf.shape, generator=g, dtype=leaf.dtype))
    return params


def _batch(cfg, seed=0, rows=B):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (rows, S + 1), generator=g)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def test_the_published_configuration_puts_attention_at_layers_7_and_21():
    cfg = get_config(ARCH)
    assert isinstance(cfg, InterleavedConfig) and cfg.family == "interleaved"
    assert [i for i, k in enumerate(cfg.layer_kinds) if k == "attention"] == [7, 21]
    assert cfg.layer_kinds.count("mamba") == 26
    assert cfg.layer_slot(7) == ("attention", 0) and cfg.layer_slot(21) == ("attention", 1)
    assert cfg.layer_slot(22) == ("mamba", 20)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.ssm_d_inner, cfg.resolved_dt_rank, cfg.ssm_state,
            cfg.ssm_conv, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) == (
        28, 2560, 20, 1, 128, 5120, 160, 16, 4, 8192, 65536, True)


def test_the_reduced_cut_keeps_an_attention_layer_between_mamba_layers():
    kinds = get_config(ARCH).reduced().layer_kinds
    assert kinds == ("mamba", "attention", "mamba", "attention")


def test_list_configs_stays_the_jax_packages_and_jamba_resolves():
    assert list_configs() == jax_list()
    assert ARCH not in list_configs() and port_only_configs() == [ARCH]
    assert get_config(ARCH).name == ARCH
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("jamba2-3b-nope")
    # the shared configurations carry no field of the subclass
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert all(set(dataclasses.asdict(get_config(a))) == fields for a in list_configs())


@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
def test_num_params_is_the_sum_of_init_lms_leaves(reduced):
    cfg = get_config(ARCH).reduced() if reduced else get_config(ARCH)
    leaves = lm.flat_params(lm.init_lm(cfg, device="meta"))
    assert sum(t.numel() for t in leaves.values()) == cfg.num_params()
    if not reduced:
        assert cfg.num_params() == 3_029_337_472


def test_the_roofline_counts_the_familys_own_parameters():
    from repro_torch.configs import SHAPES
    from repro_torch.launch import roofline

    cfg, shape = get_config(ARCH), SHAPES["train_4k"]
    assert roofline.model_flops(cfg, shape) == 6.0 * cfg.num_params() * 256 * 4096


def test_a_layer_carries_only_the_leaves_of_its_kind():
    cfg = get_config(ARCH)
    leaves = lm.flat_params(lm.init_lm(cfg, device="meta"))
    for name, t in leaves.items():
        if name.startswith("layers.attn."):
            assert t.shape[0] == 2, name
        elif name.startswith("layers.ssm."):
            assert t.shape[0] == 26, name
        elif name.startswith("layers."):
            assert t.shape[0] == 28, name
    assert leaves["layers.attn.wq"].shape == (2, 2560, 20, 128)
    assert leaves["layers.attn.wk"].shape == (2, 2560, 1, 128)
    assert leaves["layers.ssm.dt_norm"].shape == (26, 160)
    assert leaves["layers.ssm.b_norm"].shape == leaves["layers.ssm.c_norm"].shape == (26, 16)
    assert "unembed" not in leaves and "layers.wq" not in leaves
    assert "layers.ln_ssm" not in leaves


@pytest.mark.parametrize("leaf", ["dt_norm", "b_norm", "c_norm"])
def test_each_ssm_norm_changes_the_loss_when_its_scale_moves(leaf):
    cfg = get_config(ARCH).reduced()
    params = _noisy_params(cfg)
    batch = _batch(cfg)
    base = float(lm.train_loss(params, batch, cfg)[0])
    with torch.no_grad():
        params["layers"]["ssm"][leaf].add_(0.5)
    moved = float(lm.train_loss(params, batch, cfg)[0])
    assert abs(moved - base) > 1e-4 * abs(base), (base, moved)


def test_attention_takes_no_positions():
    """Without positions, q and k are the plain projections; a dense
    configuration with ``rope_theta <= 0`` still raises."""
    cfg = get_config(ARCH).reduced()
    params = _noisy_params(cfg)
    lp = lm._interleaved_layer(params["layers"], cfg, 1)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(3))
    q, k, _ = lm._qkv(x, lp, cfg, torch.arange(S))
    torch.testing.assert_close(q, torch.einsum("bsd,dhk->bhsk", x, lp["wq"]), rtol=0, atol=0)
    torch.testing.assert_close(k, torch.einsum("bsd,dhk->bhsk", x, lp["wk"]), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="sinusoidal"):
        lm.check_supported(get_config("qwen2-0.5b").replace(rope_theta=0.0))


def test_serving_refuses_the_family_by_name():
    cfg = get_config(ARCH).reduced()
    params = _noisy_params(cfg)
    tokens = _batch(cfg)["tokens"]
    with pytest.raises(NotImplementedError, match="interleaved"):
        lm.CacheSpec.build(cfg, 32)
    spec = lm.CacheSpec(1, 32)
    with pytest.raises(NotImplementedError, match="interleaved"):
        lm.init_cache(cfg, spec, B)
    with pytest.raises(NotImplementedError, match="interleaved"):
        lm.prefill(params, tokens, cfg, spec)
    with pytest.raises(NotImplementedError, match="interleaved"):
        lm.decode_step(params, {"pos": 0}, tokens[:, 0], cfg, spec)


class _Mesh:
    mesh_dim_names = ("data", "model")

    def __init__(self, model: int):
        self._sizes = (1, model)

    def size(self, dim: int) -> int:
        return self._sizes[dim]


def test_the_tensor_parallel_split_refuses_the_family_by_name():
    cfg = get_config(ARCH).reduced()
    flat = lm.flat_params(lm.init_lm(cfg, device="meta"))
    with pytest.raises(NotImplementedError, match="interleaved"):
        tp.split_plan(cfg, flat, _Mesh(2))
    assert tp.split_plan(cfg, flat, _Mesh(1)) is None


def _traced_step(cfg):
    """One train step of the reduced model (remat, grad_accum 2) with the
    tracer on; its records as (kind name, a, b, t0, t1, thread)."""
    cfg = cfg.replace(grad_accum=2)
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt, lambda p, b: lm.train_loss(lm.nested_params(p), b, cfg))
    state = init_train_state(lm.flat_params(_noisy_params(cfg)), opt)
    tracer = obs_trace.enable()
    try:
        step(state, _batch(cfg, rows=4))
    finally:
        obs_trace.disable()
    recs, threads, _ = tracer.records()
    names = obs_trace.kind_names()
    return [(names[int(r["kind"])], int(r["a"]), int(r["b"]), float(r["t0"]), float(r["t1"]),
             t) for r, t in zip(recs, threads)]


def test_block_spans_open_around_each_forward_and_its_recompute():
    """Under remat every block's forward runs twice a microbatch: once in
    ``step.forward`` and again inside ``step.backward``; each is a span of
    its kind with a = the layer, b = the microbatch's tokens."""
    assert obs_trace.kind_names()[28:30] == ["block.attention", "block.mamba"]
    cfg = get_config(ARCH).reduced()
    assert cfg.remat
    recs = _traced_step(cfg)
    blocks = [r for r in recs if r[0].startswith("block.")]
    assert len(blocks) == 2 * 2 * cfg.num_layers  # 2 microbatches x (forward + recompute)
    for phase in ("step.forward", "step.backward"):
        spans = [r for r in recs if r[0] == phase]
        assert len(spans) == 2
        for _, _, _, t0, t1, _ in spans:
            inside = [r for r in blocks if t0 <= r[3] <= r[4] <= t1]
            assert sorted((r[0], r[1]) for r in inside) == sorted(
                (f"block.{k}", i) for i, k in enumerate(cfg.layer_kinds))
            assert {r[2] for r in inside} == {2 * S}


def test_the_tracer_off_records_nothing():
    tracer = obs_trace.enable()
    obs_trace.disable()
    cfg = get_config(ARCH).reduced().replace(grad_accum=2)
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt, lambda p, b: lm.train_loss(lm.nested_params(p), b, cfg))
    step(init_train_state(lm.flat_params(_noisy_params(cfg)), opt), _batch(cfg, rows=4))
    assert len(tracer.records()[0]) == 0
