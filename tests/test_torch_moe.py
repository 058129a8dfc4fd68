"""The port's moe family against the JAX package on the CPU: ``moe_layer``
and its router alone, then qwen2-moe-a2.7b and phi3.5-moe-42b-a6.6b at
``reduced()`` in f32 from the same weights (serving, the training loss and
every gradient, the train step, checkpoints).

Routes first.  ``torch.topk`` and ``lax.top_k`` agree only on distinct
values, and a flipped route moves a token's output by a whole expert: each
test asserts the expert choices equal before it compares any value, so a
flipped route fails by name rather than hiding under a loose tolerance.

The JAX init leaves biases and norm scales at zero, which would hide a bias
or ``1 + scale`` bug, so every leaf gets seeded numpy noise before it is
handed to both sides (through ``convert``).  Tolerances as in
``test_torch_lm_train.py``: logits and caches 1e-5, the loss 1e-5 relative,
each gradient leaf 1e-4 of its max |value| (the same f32 products summed in
another order).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config, list_configs
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]
TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)

_jprefill = jax.jit(jlm.prefill, static_argnames=("cfg", "spec", "attn_impl"))
_jdecode = jax.jit(jlm.decode_step, static_argnames=("cfg", "spec"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _leaf_close(got, want, tol=GRAD_TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{k}: max |diff| {err:.3e} > {tol} * {scale:.3e}"


# -- the layer: route and moe_layer ------------------------------------------------

# (b, s, d, real experts, padded experts, f, top_k, capacity factor, group, shared)
LAYER_CASES = {
    "padded, no drops": (2, 32, 16, 12, 16, 24, 2, 4.0, 256, True),
    "cf 1.0, tokens dropped": (2, 32, 16, 12, 16, 24, 2, 1.0, 8, False),
    "three groups, top 4": (2, 48, 16, 16, 16, 24, 4, 1.25, 16, True),
    "decode: groups of 1": (3, 1, 16, 60, 64, 8, 4, 2.0, 1, True),
}


def _layer_inputs(case, seed=0):
    b, s, d, _, e, f, _, _, _, shared = case
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    arrays = [randn(b, s, d), randn(d, e, scale=0.5), randn(e, d, f, scale=0.25),
              randn(e, d, f, scale=0.25), randn(e, f, d, scale=0.2)]
    if shared:
        arrays += [randn(d, 8, scale=0.25), randn(d, 8, scale=0.25), randn(8, d, scale=0.3)]
    return arrays


def _layer_kw(case):
    _, _, _, e_real, _, _, k, cf, group, _ = case
    return dict(top_k=k, num_real_experts=e_real, capacity_factor=cf, group_size=group)


def _jax_route(x, router_w, top_k, num_real):
    """The router lines of the JAX package's ``moe_layer`` (layers.py:408-416)."""
    logits = jnp.einsum("...d,de->...e", x.astype(jnp.float32), router_w.astype(jnp.float32))
    e_pad = router_w.shape[1]
    if e_pad > num_real:
        logits = jnp.where(jnp.arange(e_pad) >= num_real, JL._NEG_INF, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    gates, idx = lax.top_k(probs, top_k)
    return probs, gates / jnp.maximum(gates.sum(axis=-1, keepdims=True), 1e-9), idx


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_route_matches_jax(name):
    case = LAYER_CASES[name]
    x, router_w = _layer_inputs(case)[:2]
    kw = _layer_kw(case)
    probs, gates, idx = L.route(torch.from_numpy(x), torch.from_numpy(router_w),
                                top_k=kw["top_k"], num_real_experts=kw["num_real_experts"])
    jprobs, jgates, jidx = _jax_route(jnp.asarray(x), jnp.asarray(router_w), kw["top_k"],
                                      kw["num_real_experts"])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))  # routes first
    assert (idx < kw["num_real_experts"]).all()  # no pad expert is ever chosen
    _close(probs, jprobs, 1e-6)
    _close(gates, jgates, 1e-6)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_moe_layer_and_its_gradient_match_jax(name):
    case = LAYER_CASES[name]
    arrays = _layer_inputs(case)
    kw = _layer_kw(case)
    ct = np.random.default_rng(1).standard_normal(arrays[0].shape).astype(np.float32)

    def jfn(x, rw, wg, wu, wd, *shared):
        return JL.moe_layer(x, rw, wg, wu, wd, shared=shared or None, **kw)

    def jloss(*a):
        y, aux = jfn(*a)
        return (y * ct).sum() + aux

    jargs = [jnp.asarray(a) for a in arrays]
    jy, jaux = jax.jit(jfn)(*jargs)
    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(len(arrays)))))(*jargs)

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    _, _, idx = L.route(leaves[0].detach(), leaves[1].detach(), top_k=kw["top_k"],
                        num_real_experts=kw["num_real_experts"])
    _, _, jidx = _jax_route(jargs[0], jargs[1], kw["top_k"], kw["num_real_experts"])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))  # routes first
    y, aux = L.moe_layer(*leaves[:5], shared=tuple(leaves[5:]) or None, **kw)
    _close(y.detach(), jy)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum() + aux, leaves)
    _leaf_close({str(i): g.numpy() for i, g in enumerate(grads)},
                {str(i): np.asarray(g) for i, g in enumerate(jgrads)})


def test_capacity_one_drops_choices_as_jax_does():
    """At capacity factor 1.0 some choices drop (the output moves against a
    capacity that keeps every choice), and the port drops the same ones."""
    case = LAYER_CASES["cf 1.0, tokens dropped"]
    arrays = [torch.from_numpy(a) for a in _layer_inputs(case)]
    kw = _layer_kw(case)
    dropped, _ = L.moe_layer(*arrays, **kw)
    kept, _ = L.moe_layer(*arrays, **{**kw, "capacity_factor": 64.0})
    assert float((dropped - kept).abs().max()) > 1e-2
    jkept, _ = jax.jit(lambda *a: JL.moe_layer(*a, **{**kw, "capacity_factor": 64.0}))(
        *[jnp.asarray(a.numpy()) for a in arrays])
    _close(kept, jkept)


def test_pad_experts_are_masked_with_the_finite_neg_inf():
    """Pad experts get probability 0 through the JAX package's finite mask
    value (-0.7 x the f32 max), so logits stay finite and no NaN appears."""
    assert L.NEG_INF == JL._NEG_INF
    x, router_w = (torch.from_numpy(a) for a in _layer_inputs(LAYER_CASES["padded, no drops"])[:2])
    probs, _, _ = L.route(x, router_w, top_k=2, num_real_experts=12)
    assert float(probs[..., 12:].abs().max()) == 0.0 and torch.isfinite(probs).all()


@pytest.mark.parametrize("arch", list_configs())
def test_padded_experts_match_jax(arch):
    for reduce in (False, True):
        cfg, jcfg = get_config(arch), jax_config(arch)
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        assert lm.padded_experts(cfg) == jlm.padded_experts(jcfg)
    if arch == "qwen2-moe-a2.7b":
        assert lm.padded_experts(get_config(arch)) == 64  # 60 real experts


@pytest.mark.parametrize("arch", list_configs())
def test_param_counts_match_jax(arch):
    """Counterpart of the JAX package's test_models.py:139 for every
    architecture: the analytic counts (active ones too) equal the JAX
    package's, and the moe, vlm and encdec rows lie in their ranges."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.num_active_params() == jcfg.num_active_params()
    ranges = {"phi3.5-moe-42b-a6.6b": (38e9, 46e9), "qwen2-moe-a2.7b": (13e9, 16e9),
              "llava-next-mistral-7b": (6.5e9, 8e9), "whisper-medium": (0.6e9, 0.9e9)}
    if arch in ranges:
        lo, hi = ranges[arch]
        assert lo < cfg.num_params() < hi, cfg.num_params()
    if arch == "phi3.5-moe-42b-a6.6b":
        assert 5e9 < cfg.num_active_params() < 8e9


# -- the models ------------------------------------------------------------------

def _noisy_tree(arch, seed=0, noise=0.05):
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed),
                                                jax_config(arch).reduced()))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)


@pytest.fixture(scope="module")
def weights():
    return {arch: _noisy_tree(arch) for arch in ARCHS}


def _prompts(cfg, b=2, s=12, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_matches_jax_layout(arch, param_dtype):
    """The same leaves, shapes and dtypes as the JAX init: the router f32
    whatever the param dtype, experts padded (the reduced configs' 4 to 16)."""
    cfg = get_config(arch).reduced().replace(param_dtype=param_dtype)
    jcfg = jax_config(arch).reduced().replace(param_dtype=param_dtype)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jcfg)))
    params = lm.init_lm(cfg, seed=0, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                       params)
    assert got == want
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["we_gate"].shape[1] == lm.padded_experts(cfg) == 16


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(weights, arch):
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    params = convert.params_from_jax(weights[arch], "cpu")
    jparams = jax.tree.map(jnp.asarray, weights[arch])
    prompts, gen = _prompts(cfg), 8
    spec, jspec = lm.CacheSpec.build(cfg, 21), jlm.CacheSpec.build(jcfg, 21)
    logits, cache = lm.prefill(params, torch.from_numpy(prompts).long(), cfg, spec)
    jlogits, jcache = _jprefill(jparams, jnp.asarray(prompts), cfg=jcfg, spec=jspec)
    _close(logits, jlogits)
    for key in ("k", "v"):
        _close(cache[key], jcache[key])
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for _ in range(gen):
        logits, cache = lm.decode_step(params, cache, torch.from_numpy(tok).long(), cfg, spec)
        jlogits, jcache = _jdecode(jparams, jcache, jnp.asarray(tok), cfg=jcfg, spec=jspec)
        _close(logits, jlogits)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    assert cache["pos"] == int(jcache["pos"]) == prompts.shape[1] + gen


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(weights, arch):
    """Counterpart of test_models.py:49: prefill then decode steps land on
    the full forward's last logits (decode routes each token alone, at a
    capacity factor of at least 2; reduced() keeps every choice)."""
    cfg = get_config(arch).reduced()
    params = convert.params_from_jax(weights[arch], "cpu")
    tokens = torch.from_numpy(_prompts(cfg, s=24)).long()
    spec = lm.CacheSpec.build(cfg, 28)
    logits, cache = lm.prefill(params, tokens[:, :21], cfg, spec)
    for t in range(21, 24):
        logits, cache = lm.decode_step(params, cache, tokens[:, t], cfg, spec)
    hidden, _ = lm.forward_hidden(params, tokens, cfg)
    want = lm._logits(params, hidden, cfg)[:, -1]
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=5e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_engine(weights, arch):
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    prompts = _prompts(cfg, b=3)
    eng = ServeEngine(cfg, convert.params_from_jax(weights[arch], "cpu"), max_len=21,
                      device="cpu")
    out = eng.generate(prompts, 8)
    want = JaxEngine(jcfg, jax.tree.map(jnp.asarray, weights[arch]), max_len=21).generate(
        prompts, 8)
    assert out.shape == (3, 8) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want)


def _batch(cfg, b=4, s=32, seed=2, pad_rows=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1
    weights = np.ones((b,), np.float32)
    if pad_rows:
        weights[-pad_rows:] = 0.0
    return {"tokens": tokens, "labels": labels, "weights": weights}


def _to(batch, fn):
    return {k: fn(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_aux_and_every_gradient_match_jax(weights, arch):
    tree = weights[arch]
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    batch = _batch(cfg, pad_rows=1)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(p, _to(batch, jnp.asarray), jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, tree))
    flat = convert.lm_params_from_jax(tree, "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, metrics = lm.train_loss(lm.nested_params(leaves), _to(batch, torch.from_numpy), cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert float(metrics["aux"].detach()) > 0
    np.testing.assert_allclose(float(metrics["aux"].detach()), float(jm["aux"]), rtol=LOSS_RTOL)
    assert float(metrics["tokens"]) == float(jm["tokens"])
    _leaf_close({k: g.numpy() for k, g in zip(leaves, grads)},
                lm.flat_params(jax.tree.map(np.asarray, jgrads)))


def test_aux_loss_sums_through_remat_and_the_two_level_scan():
    """forward_hidden sums the layers' aux losses in order; rematerialising
    each block, or each group of blocks, leaves loss and gradient as they are."""
    cfg = get_config("qwen2-moe-a2.7b").reduced().replace(num_layers=4)
    flat = lm.flat_params(lm.init_lm(cfg, seed=0, device="cpu"))
    batch = _to(_batch(cfg, b=2, s=32), torch.from_numpy)
    runs = []
    for variant in (cfg.replace(remat=False), cfg, cfg.replace(scan_block=2)):
        leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
        loss, m = lm.train_loss(lm.nested_params(leaves), batch, variant)
        runs.append((loss.detach(), m["aux"].detach(),
                     torch.autograd.grad(loss, list(leaves.values()))))
    for loss, aux, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0]) and torch.equal(aux, runs[0][1])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][2]))


@pytest.mark.parametrize("arch", ARCHS)
def test_per_step_loss_follows_the_jax_step(weights, arch):
    """5 steps (grad_accum 2, a padding row) from the same params and
    batches: the port's loss, aux included, follows the JAX step's."""
    cfg = get_config(arch).reduced().replace(grad_accum=2)
    jcfg = jax_config(arch).reduced().replace(grad_accum=2)
    opt, jopt = tadamw.AdamWConfig(**OPT), jadamw.AdamWConfig(**OPT)
    step = tstep.make_train_step(cfg, opt, lambda p, b: lm.train_loss(lm.nested_params(p),
                                                                      b, cfg))
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    js = jstep.init_train_state(jax.tree.map(jnp.asarray, weights[arch]), jopt)
    ts = tstep.init_train_state(convert.lm_params_from_jax(weights[arch], "cpu"), opt)
    for i in range(5):
        batch = _batch(cfg, b=4, s=32, seed=10 + i, pad_rows=1)
        js, jm = jfn(js, _to(batch, jnp.asarray))
        ts, tm = step(ts, _to(batch, torch.from_numpy))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(tm["tokens"]) == float(jm["tokens"])


def test_moe_checkpoint_cross_loads_bit_exact_both_ways(weights, tmp_path):
    arch = "qwen2-moe-a2.7b"
    jcfg = jax_config(arch).reduced()
    jopt = jadamw.AdamWConfig(**OPT)
    fn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    js, _ = fn(jstep.init_train_state(jax.tree.map(jnp.asarray, weights[arch]), jopt),
               _to(_batch(jcfg, b=2), jnp.asarray))
    jsn = jax.tree.map(np.asarray, js)
    ts = {"params": convert.lm_params_from_jax(jsn["params"], "cpu"),
          "opt": tadamw.OptState(convert.lm_params_from_jax(jsn["opt"].mu, "cpu"),
                                 convert.lm_params_from_jax(jsn["opt"].nu, "cpu"),
                                 torch.tensor(int(jsn["opt"].step), dtype=torch.int32))}
    path = tckpt.save_checkpoint(str(tmp_path / "port"), 1, ts)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 1, js)
    names = {f[:-4] for f in os.listdir(path) if f.endswith(".npy")}
    assert names == {f[:-4] for f in os.listdir(jpath) if f.endswith(".npy")}
    assert {"params__layers__router", "opt__mu__layers__ws_gate"} <= names
    with open(os.path.join(path, "meta.json")) as f, open(os.path.join(jpath, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    jtemplate = jstep.init_train_state(jlm.init_lm(jax.random.PRNGKey(9), jcfg), jopt)
    restored, _ = jckpt.restore_checkpoint(path, jtemplate)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(js)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    template = tstep.init_train_state(
        lm.flat_params(lm.init_lm(get_config(arch).reduced(), seed=9, device="cpu")),
        tadamw.AdamWConfig(**OPT))
    back, _ = tckpt.restore_checkpoint(jpath, template)
    for got, want in ((back["params"], ts["params"]), (back["opt"].mu, ts["opt"].mu),
                      (back["opt"].nu, ts["opt"].nu)):
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ARCHS + ["llava-next-mistral-7b", "whisper-medium"])
def test_convert_round_trips_the_new_trees_bit_for_bit(arch):
    """JAX params -> the port's flat dict -> JAX: the moe leaves (the router
    f32 beside bf16 experts), ``mm_proj`` and the encoder-decoder's nested
    tree come back with the same names, structure and bits."""
    from repro.models import encdec as jed

    jcfg = jax_config(arch).reduced().replace(param_dtype="bfloat16")
    init = jed.init_encdec if jcfg.family == "encdec" else jlm.init_lm
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), jcfg))
    flat = convert.lm_params_from_jax(tree, "cpu")
    assert list(lm.flat_params(lm.nested_params(flat))) == list(flat)
    want = {"moe": {"layers.router", "layers.we_gate"}, "vlm": {"mm_proj"},
            "encdec": {"enc_layers.attn.wq", "dec_layers.cross.wk", "enc_final.scale"}}
    assert want[jcfg.family] <= set(flat)
    if jcfg.family == "moe":
        assert flat["layers.router"].dtype == torch.float32
        assert flat["layers.we_gate"].dtype == torch.bfloat16
    back = convert.lm_params_to_jax(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, np.asarray(b, np.float32))
