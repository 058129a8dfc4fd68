"""The port's ssm and hybrid serving paths against the JAX package on the CPU:
falcon-mamba-7b and hymba-1.5b at ``reduced()`` in f32, from the same
weights.

The JAX init leaves norm scales and biases at zero, which would hide a
``1 + scale`` or bias bug, so every leaf gets seeded numpy noise before it
is handed to both sides (through ``convert.params_from_jax`` for the port).
The JAX model never reaches the Pallas scan or norm kernels, so the port's
switches are held against the JAX model's plain path: on the CPU
'pallas' runs each kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

ARCHS = ["hymba-1.5b", "falcon-mamba-7b"]
B, S, GEN = 2, 12, 8
MAX_LEN = S + GEN + 1
# f32 through two layers, a selective scan (associative in JAX, log-step in
# the port, sequential in the kernel's plain version) and an f32
# unembedding: the sums run in different orders, so agreement is to a few
# f32 ulps of O(1) values.
TOL = 1e-5
# An int8 KV payload that sits on a rounding boundary may land one step
# apart on the two sides (its f32 projection summed in another order).  Once
# a payload differs, logits are held to the JAX package's own decode
# tolerance (test_models.py::test_decode_matches_full_forward) instead.
INT8_STEP_TOL = 5e-3


# The JAX side jitted, as its engine runs it: eager, every call would trace
# its layer scan again.
_jprefill = jax.jit(jlm.prefill, static_argnames=("cfg", "spec", "attn_impl"))
_jdecode = jax.jit(jlm.decode_step, static_argnames=("cfg", "spec"))


def _cfgs(arch, **kw):
    return (get_config(arch).reduced().replace(**kw),
            jax_config(arch).reduced().replace(**kw))


def _noisy_weights(jcfg, seed=1):
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)


@pytest.fixture(scope="module")
def weights():
    """{arch: numpy tree with noise on every leaf}."""
    return {arch: _noisy_weights(_cfgs(arch)[1]) for arch in ARCHS}


def _prompts(cfg, s=S, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_caches(cache, jcache, quantized) -> bool:
    """Compare two caches; returns whether an int8 payload differs (by at
    most one step, in at most 0.1% of the values)."""
    assert set(cache) == set(jcache)
    stepped = False
    for key in jcache:
        if key == "pos":
            assert cache[key] == int(jcache[key])
        elif key in ("k", "v") and quantized:
            diff = np.abs(cache[key].numpy().astype(np.int32)
                          - np.asarray(jcache[key]).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            stepped |= bool(diff.any())
        else:
            _close(cache[key], jcache[key])
    return stepped


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, reduce):
    cfg, jcfg = get_config(arch), jax_config(arch)
    if reduce:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.ssm_d_inner == jcfg.ssm_d_inner
    assert cfg.resolved_dt_rank == jcfg.resolved_dt_rank


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_layout(arch):
    cfg, jcfg = _cfgs(arch)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    params = lm.init_lm(cfg, seed=0, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                       params)
    assert got == want
    again = lm.init_lm(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params),
                                                  jax.tree.leaves(again)))
    # the deterministic leaves equal the JAX init's (log to an f32 ulp)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    for name in ("a_log", "d_skip", "dt_bias", "conv_b"):
        _close(params["layers"]["ssm"][name], jparams["layers"]["ssm"][name], 1e-6)


def test_bf16_init_keeps_scan_params_in_f32():
    cfg = get_config("falcon-mamba-7b").reduced().replace(param_dtype="bfloat16",
                                                          compute_dtype="bfloat16")
    ssm = lm.init_lm(cfg, seed=0, device="cpu")["layers"]["ssm"]
    assert ssm["a_log"].dtype == ssm["d_skip"].dtype == torch.float32
    assert ssm["in_proj"].dtype == ssm["dt_bias"].dtype == torch.bfloat16


def test_convert_carries_the_nested_ssm_dict(weights):
    tree = weights["hymba-1.5b"]
    params = params_from_jax(tree, "cpu")
    assert set(params["layers"]["ssm"]) == set(tree["layers"]["ssm"])
    for name, leaf in tree["layers"]["ssm"].items():
        np.testing.assert_array_equal(params["layers"]["ssm"][name].numpy(), leaf)


@pytest.mark.parametrize("arch,kv,impl", [
    ("hymba-1.5b", "bfloat16", "pallas"),
    ("hymba-1.5b", "bfloat16", "ref"),
    ("hymba-1.5b", "int8", "pallas"),
    ("falcon-mamba-7b", "bfloat16", "pallas"),
    ("falcon-mamba-7b", "bfloat16", "ref"),
])
def test_prefill_and_decode_match_jax(weights, arch, kv, impl):
    cfg, jcfg = _cfgs(arch, kv_cache_dtype=kv)
    tree = weights[arch]
    params, jparams = params_from_jax(tree, "cpu"), jax.tree.map(jnp.asarray, tree)
    spec, jspec = lm.CacheSpec.build(cfg, MAX_LEN), jlm.CacheSpec.build(jcfg, MAX_LEN)
    assert (spec.kv_heads, spec.cache_len, spec.ring, spec.quantized) == \
        (jspec.kv_heads, jspec.cache_len, jspec.ring, jspec.quantized)
    prompts = _prompts(cfg)

    logits, cache = lm.prefill(params, torch.from_numpy(prompts).long(), cfg, spec,
                               attn_impl=impl, ssm_impl=impl, norm_impl=impl)
    jlogits, jcache = _jprefill(jparams, jnp.asarray(prompts), jcfg, jspec,
                                  attn_impl=impl)
    _close(logits, jlogits)
    stepped = _close_caches(cache, jcache, spec.quantized)

    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for _ in range(GEN):
        logits, cache = lm.decode_step(params, cache, torch.from_numpy(tok).long(),
                                       cfg, spec, norm_impl=impl)
        jlogits, jcache = _jdecode(jparams, jcache, jnp.asarray(tok), jcfg, jspec)
        stepped |= _close_caches(cache, jcache, spec.quantized)
        _close(logits, jlogits, INT8_STEP_TOL if stepped else TOL)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    assert cache["pos"] == S + GEN


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_ring_cache_wraps_like_jax(kv):
    """The setting of ``test_models.py::test_sliding_window_ring_cache``:
    window 8, prompt 30 (roll shift 6), 10 decode steps past the window."""
    cfg, jcfg = _cfgs("hymba-1.5b", sliding_window=8, kv_cache_dtype=kv)
    tree = _noisy_weights(jcfg, seed=3)
    params, jparams = params_from_jax(tree, "cpu"), jax.tree.map(jnp.asarray, tree)
    spec, jspec = lm.CacheSpec.build(cfg, 16), jlm.CacheSpec.build(jcfg, 16)
    assert spec.ring and spec.cache_len == 8 and jspec.ring
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)

    logits, cache = lm.prefill(params, torch.from_numpy(tokens[:, :30]).long(), cfg, spec)
    jlogits, jcache = _jprefill(jparams, jnp.asarray(tokens[:, :30]), jcfg, jspec)
    _close(logits, jlogits)
    stepped = _close_caches(cache, jcache, spec.quantized)
    for t in range(30, 40):
        logits, cache = lm.decode_step(params, cache, torch.from_numpy(tokens[:, t]).long(),
                                       cfg, spec)
        jlogits, jcache = _jdecode(jparams, jcache, jnp.asarray(tokens[:, t]),
                                          jcfg, jspec)
        stepped |= _close_caches(cache, jcache, spec.quantized)
        _close(logits, jlogits, INT8_STEP_TOL if stepped else TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_engine(weights, arch):
    cfg, jcfg = _cfgs(arch)
    tree = weights[arch]
    prompts = _prompts(cfg, s=40)  # past hymba's reduced window of 32
    eng = ServeEngine(cfg, params_from_jax(tree, "cpu"), max_len=40 + GEN + 1,
                      attn_impl="pallas", ssm_impl="pallas", norm_impl="pallas",
                      device="cpu")
    ss_before, rn_before = ss.launches, rn.launches
    out = eng.generate(prompts, GEN)
    assert (ss.launches, rn.launches) == (ss_before, rn_before)  # plain versions
    want = JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree), max_len=40 + GEN + 1,
                     attn_impl="pallas").generate(prompts, GEN)
    assert out.shape == (B, GEN) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(eng.generate(prompts, GEN), out)  # repeat
