"""The port's serving slice against the JAX package on the CPU: qwen2-0.5b at
``reduced()`` in f32, from the same weights; and the nine decoder-only archs
with their kv heads repeated for a model axis (``model_axis``).

The JAX init leaves biases and norm scales at zero, which would hide a bias
or ``1 + scale`` bug, so every leaf gets seeded numpy noise before it is
handed to both sides (through ``convert.params_from_jax`` for the port).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import list_configs
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

ARCH = "qwen2-0.5b"
B, S, GEN = 3, 12, 8
MAX_LEN = S + GEN + 1
# f32 through two layers and an f32 unembedding: the two frameworks sum in
# different orders, so agreement is to a few f32 ulps of O(1) values.
TOL = 1e-5


def _cfgs(kv="bfloat16"):
    return (get_config(ARCH).reduced().replace(kv_cache_dtype=kv),
            jax_config(ARCH).reduced().replace(kv_cache_dtype=kv))


@pytest.fixture(scope="module")
def weights():
    """(numpy tree, JAX tree) with noise on every leaf."""
    _, jcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    noisy = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    return noisy, jax.tree.map(jnp.asarray, noisy)


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(2).integers(0, 256, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches_jax(reduce):
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    if reduce:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim


@pytest.mark.parametrize("tied", [True, False])
def test_init_matches_jax_layout(tied):
    cfg, jcfg = _cfgs()
    cfg, jcfg = cfg.replace(tie_embeddings=tied), jcfg.replace(tie_embeddings=tied)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    params = lm.init_lm(cfg, seed=0, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                       params)
    assert got == want
    again = lm.init_lm(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params),
                                                  jax.tree.leaves(again)))


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("attn_impl", ["pallas", "ref"])
def test_prefill_and_decode_match_jax(weights, prompts, attn_impl, kv):
    cfg, jcfg = _cfgs(kv)
    tree, jparams = weights
    params = params_from_jax(tree, "cpu")
    spec, jspec = lm.CacheSpec.build(cfg, MAX_LEN), jlm.CacheSpec.build(jcfg, MAX_LEN)

    logits, cache = lm.prefill(params, torch.from_numpy(prompts).long(), cfg,
                               spec, attn_impl=attn_impl)
    jlogits, jcache = jlm.prefill(jparams, jnp.asarray(prompts), jcfg, jspec,
                                  attn_impl=attn_impl)
    _close(logits, jlogits)
    assert cache["pos"] == int(jcache["pos"]) == S
    for key in jcache:
        if key == "pos":
            continue
        if key in ("k", "v") and kv == "int8":
            np.testing.assert_array_equal(cache[key].numpy(), np.asarray(jcache[key]))
        else:
            _close(cache[key], jcache[key])

    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for _ in range(GEN):
        logits, cache = lm.decode_step(params, cache, torch.from_numpy(tok).long(),
                                       cfg, spec)
        jlogits, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(tok), jcfg, jspec)
        _close(logits, jlogits)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    assert cache["pos"] == int(jcache["pos"]) == S + GEN


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_generate_matches_jax_engine(weights, prompts, kv):
    cfg, jcfg = _cfgs(kv)
    tree, jparams = weights
    eng = ServeEngine(cfg, params_from_jax(tree, "cpu"), max_len=MAX_LEN,
                      attn_impl="pallas", device="cpu")
    out = eng.generate(prompts, GEN)
    want = JaxEngine(jcfg, jparams, max_len=MAX_LEN, attn_impl="pallas").generate(
        prompts, GEN)
    assert out.shape == (B, GEN) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(eng.generate(prompts, GEN), out)  # repeat


def test_sampled_generation_is_seeded(weights, prompts):
    cfg, _ = _cfgs()
    eng = ServeEngine(cfg, params_from_jax(weights[0], "cpu"), max_len=MAX_LEN,
                      device="cpu")

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return eng.generate(prompts, GEN, greedy=False, generator=gen)

    a = sample(3)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    np.testing.assert_array_equal(a, sample(3))
    assert not np.array_equal(a, sample(4))


def test_convert_bf16_round_trip():
    import ml_dtypes

    leaf = np.asarray(jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32)
                                  .reshape(4, 6)).astype(jnp.bfloat16))
    assert leaf.dtype == ml_dtypes.bfloat16 and leaf.dtype.itemsize == 2
    t = params_from_jax({"w": leaf}, "cpu")["w"]
    assert t.dtype == torch.bfloat16 and t.shape == (4, 6)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), leaf.view(np.int16))
    back = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back.view(np.int16), leaf.view(np.int16))
    # non-contiguous leaves and a cast on the way in
    assert tensor_from_numpy(leaf.T).shape == (6, 4)
    assert params_from_jax({"w": leaf}, "cpu", torch.float32)["w"].dtype == torch.float32


# -- kv heads repeated for a model axis ------------------------------------------------

DECODER_ARCHS = [a for a in list_configs() if jax_config(a).family != "encdec"]
AXIS_GEN = 5


@functools.lru_cache(maxsize=None)
def _noisy_tree(arch):
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0),
                                                jax_config(arch).reduced()))
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)


@pytest.mark.parametrize("model_axis", [1, 4])
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_repeated_kv_heads_serve_like_jax(arch, model_axis):
    """``model_axis`` 4 repeats the reduced GQA archs' 2 kv heads to 4 in the
    cache: prefill and 5 decode steps match the JAX package at the same
    ``model_axis``, through ``ServeEngine`` (the vlm family, which neither
    engine serves, through ``lm.prefill``/``lm.decode_step``)."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    tree = _noisy_tree(arch)
    params, jparams = params_from_jax(tree, "cpu"), jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    max_len = S + AXIS_GEN + 1
    kw = {}
    if cfg.family == "vlm":
        max_len += cfg.num_patches
        patches = rng.standard_normal((2, cfg.num_patches, cfg.d_model)).astype(np.float32)
        kw = {"patches": patches}
        spec = lm.CacheSpec.build(cfg, max_len, model_axis)
        jspec = jlm.CacheSpec.build(jcfg, max_len, model_axis)

        def prefill(p):
            return lm.prefill(params, torch.from_numpy(p).long(), cfg, spec,
                              patches=torch.from_numpy(patches))

        def step(cache, tok):
            return lm.decode_step(params, cache, tok, cfg, spec)

        jprefill = jax.jit(functools.partial(jlm.prefill, cfg=jcfg, spec=jspec))
        jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg, spec=jspec))
    else:
        eng = ServeEngine(cfg, params, max_len=max_len, model_axis=model_axis, device="cpu")
        jeng = JaxEngine(jcfg, jparams, max_len=max_len, model_axis=model_axis)
        spec, jspec = eng.spec, jeng.spec
        prefill, step = eng.prefill, eng.step
        jprefill, jstep = jeng._prefill, jeng._step
    assert spec == lm.CacheSpec(jspec.kv_heads, jspec.cache_len, jspec.ring, jspec.quantized)
    if cfg.family != "ssm" and model_axis == 4:
        assert spec.kv_heads == 4 != cfg.num_kv_heads  # each kv head twice

    logits, cache = prefill(prompts)
    jlogits, jcache = jprefill(jparams, jnp.asarray(prompts),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    _close(logits, jlogits)
    for key in ("k", "v"):
        if key in jcache:
            assert cache[key].shape[2] == spec.kv_heads
            _close(cache[key], jcache[key])
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for _ in range(AXIS_GEN):
        logits, cache = step(cache, torch.from_numpy(tok).long())
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        _close(logits, jlogits)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
