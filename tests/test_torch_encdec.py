"""The port's encoder-decoder (whisper-medium) against the JAX package on the
CPU: its building blocks (LayerNorm, sinusoidal positions, the tanh GELU
MLP), then the model at ``reduced()`` in f32 from the same weights: init
layout, prefill and decode, the engine, the training loss and every
gradient, the train step, checkpoints and the launchers.

Two traps are held here by name.  The encoder-decoder's LayerNorm takes
``cfg.norm_eps``, which whisper-medium leaves at the config default 1e-6,
not the function's default 1e-5; and ``jax.nn.gelu(approximate=True)`` is
the tanh form, not torch's default erf form.

The JAX init leaves biases at zero and LayerNorm scales at one, which would
hide a bias or scale bug, so every leaf gets seeded numpy noise before it is
handed to both sides (through ``convert``).  Tolerances as in
``test_torch_lm_train.py``: logits and caches 1e-5, the loss 1e-5 relative,
each gradient leaf 1e-4 of its max |value|.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.models import encdec as jed
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

ARCH = "whisper-medium"
TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
B, S, GEN = 2, 12, 6
MAX_LEN = S + GEN + 1

_jprefill = jax.jit(jed.prefill, static_argnames=("cfg", "spec"))
_jdecode = jax.jit(jed.decode_step, static_argnames=("cfg", "spec"))


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


def _cfgs():
    return get_config(ARCH).reduced(), jax_config(ARCH).reduced()


# -- building blocks ------------------------------------------------------------

@pytest.mark.parametrize("eps", [None, 1e-6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(eps, dtype):
    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal((3, 7, 48))).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32), \
        (0.1 * rng.standard_normal(48)).astype(np.float32)
    kw = {} if eps is None else {"eps": eps}
    got = L.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale),
                       torch.from_numpy(bias), **kw)
    want = JL.layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(scale), jnp.asarray(bias),
                         **kw)
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got.float(), np.asarray(want, np.float32), 1e-6 if dtype == "float32" else 1e-2)


def test_the_eps_trap_whisper_takes_norm_eps_1e_6():
    """whisper-medium does not set norm_eps: the model's LayerNorm runs at
    the config default 1e-6, not layer_norm's default 1e-5, which moves a
    row of small variance visibly."""
    cfg, jcfg = _cfgs()
    assert cfg.norm_eps == jcfg.norm_eps == 1e-6
    x = torch.from_numpy(
        3e-3 * np.random.default_rng(1).standard_normal((2, cfg.d_model)).astype(np.float32))
    ln = {"scale": torch.ones(cfg.d_model), "bias": torch.zeros(cfg.d_model)}
    got = encdec._ln(x, ln, cfg)
    assert torch.equal(got, L.layer_norm(x, ln["scale"], ln["bias"], 1e-6))
    assert float((got - L.layer_norm(x, ln["scale"], ln["bias"])).abs().max()) > 1e-2


@pytest.mark.parametrize("length,dim", [(16, 64), (100, 32), (7, 1024)])
def test_sinusoidal_positions_match_jax(length, dim):
    got = L.sinusoidal_positions(length, dim)
    want = JL.sinusoidal_positions(length, dim)
    assert got.shape == (length, dim)
    _close(got, want, 1e-6)
    assert L.sinusoidal_positions(length, dim, torch.bfloat16).dtype == torch.bfloat16


def test_gelu_mlp_is_the_tanh_form():
    rng = np.random.default_rng(2)
    x, wi, bi, wo, bo = (rng.standard_normal(s).astype(np.float32)
                         for s in ((4, 16), (16, 32), (32,), (32, 16), (16,)))
    got = L.gelu_mlp(*map(torch.from_numpy, (x, wi, bi, wo, bo)))
    _close(got, JL.gelu_mlp(*map(jnp.asarray, (x, wi, bi, wo, bo))), 1e-5)
    erf = torch.nn.functional.gelu(torch.from_numpy(x @ wi + bi)) @ torch.from_numpy(wo) \
        + torch.from_numpy(bo)
    assert float((erf - got).abs().max()) > 1e-4  # the erf form is another function


# -- the model ------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """(numpy tree with noise on every leaf, its JAX copy)."""
    tree = jax.tree.map(np.asarray, jed.init_encdec(jax.random.PRNGKey(0), _cfgs()[1]))
    rng = np.random.default_rng(1)
    noisy = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
                         tree)
    return noisy, jax.tree.map(jnp.asarray, noisy)


def _inputs(cfg, b=B, s=S, seed=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    source = rng.standard_normal((b, cfg.source_len, cfg.d_model)).astype(np.float32)
    return tokens, source


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_matches_jax_layout(param_dtype):
    cfg, jcfg = (c.replace(param_dtype=param_dtype) for c in _cfgs())
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax.eval_shape(lambda: jed.init_encdec(jax.random.PRNGKey(0), jcfg)))
    params = encdec.init_encdec(cfg, seed=0, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                       params)
    assert got == want
    # LayerNorm scales start at one, biases at zero, as in the JAX init
    assert bool((params["enc_layers"]["ln1"]["scale"] == 1).all())
    assert not params["dec_layers"]["mlp"]["bi"].any() and not params["dec_final"]["bias"].any()
    flat = lm.flat_params(params)
    assert {"enc_layers.attn.wq", "dec_layers.cross.wk", "enc_final.scale"} <= set(flat)
    assert list(lm.flat_params(lm.nested_params(flat))) == list(flat)


def test_lm_module_refuses_the_encoder_decoder():
    cfg, _ = _cfgs()
    with pytest.raises(NotImplementedError, match="models.encdec"):
        lm.init_lm(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not an encoder-decoder"):
        encdec.init_encdec(get_config("qwen2-0.5b").reduced(), device="cpu")


def test_prefill_and_decode_match_jax(weights):
    cfg, jcfg = _cfgs()
    tree, jparams = weights
    params = convert.params_from_jax(tree, "cpu")
    tokens, source = _inputs(cfg)
    spec, jspec = lm.CacheSpec.build(cfg, MAX_LEN), jlm.CacheSpec.build(jcfg, MAX_LEN)
    logits, cache = encdec.prefill(params, torch.from_numpy(tokens).long(),
                                   torch.from_numpy(source), cfg, spec)
    jlogits, jcache = _jprefill(jparams, jnp.asarray(tokens), jnp.asarray(source),
                                cfg=jcfg, spec=jspec)
    _close(logits, jlogits)
    for key in ("k", "v", "ck", "cv"):
        assert cache[key].shape == jcache[key].shape
        _close(cache[key], jcache[key])
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for _ in range(GEN):
        logits, cache = encdec.decode_step(params, cache, torch.from_numpy(tok).long(), cfg,
                                           spec)
        jlogits, jcache = _jdecode(jparams, jcache, jnp.asarray(tok), cfg=jcfg, spec=jspec)
        _close(logits, jlogits)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    assert cache["pos"] == int(jcache["pos"]) == S + GEN
    for key in ("k", "v"):
        _close(cache[key], jcache[key])


def test_decode_matches_full_forward(weights):
    """Counterpart of test_models.py:49 for the encoder-decoder."""
    cfg, _ = _cfgs()
    params = convert.params_from_jax(weights[0], "cpu")
    tokens, source = (torch.from_numpy(a) for a in _inputs(cfg, s=24))
    tokens = tokens.long()
    spec = lm.CacheSpec.build(cfg, 28)
    logits, cache = encdec.prefill(params, tokens[:, :21], source, cfg, spec)
    for t in range(21, 24):
        logits, cache = encdec.decode_step(params, cache, tokens[:, t], cfg, spec)
    hidden = encdec._decoder_hidden(params, tokens, encdec.encode(params, source, cfg), cfg)
    want = hidden[:, -1].float() @ params["embed"].float().T
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=5e-3, rtol=1e-3)


def test_generate_encdec_matches_jax_engine(weights):
    """Counterpart of test_serve.py:44, held token for token against the JAX
    engine; the cache is full after MAX_LEN - 1 positions."""
    cfg, jcfg = _cfgs()
    tokens, source = _inputs(cfg)
    eng = ServeEngine(cfg, convert.params_from_jax(weights[0], "cpu"), max_len=MAX_LEN,
                      device="cpu")
    out = eng.generate(tokens, GEN, source=source)
    want = JaxEngine(jcfg, weights[1], max_len=MAX_LEN).generate(tokens, GEN, source=source)
    assert out.shape == (B, GEN) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError, match="source"):
        eng.generate(tokens, GEN)
    with pytest.raises(ValueError, match="cache is full"):
        eng.generate(tokens, MAX_LEN - S + 1, source=source)


def test_serve_launcher_runs_the_encoder_decoder(capsys):
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "first sequence" in out


def _batch(cfg, b=4, s=16, seed=2, pad_rows=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1
    weights = np.ones((b,), np.float32)
    if pad_rows:
        weights[-pad_rows:] = 0.0
    source = rng.standard_normal((b, cfg.source_len, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "weights": weights, "source": source}


def _to(batch, fn):
    return {k: fn(v) for k, v in batch.items()}


def test_train_loss_and_every_gradient_match_jax(weights):
    cfg, jcfg = _cfgs()
    tree, jparams = weights
    batch = _batch(cfg, pad_rows=1)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jed.train_loss(p, _to(batch, jnp.asarray), jcfg), has_aux=True))(jparams)
    flat = convert.lm_params_from_jax(tree, "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, metrics = encdec.train_loss(lm.nested_params(leaves), _to(batch, torch.from_numpy),
                                      cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert float(metrics["tokens"]) == float(jm["tokens"])
    _leaf_close({k: g.numpy() for k, g in zip(leaves, grads)},
                lm.flat_params(jax.tree.map(np.asarray, jgrads)))


def test_remat_leaves_the_gradient_unchanged():
    cfg, _ = _cfgs()
    flat = lm.flat_params(encdec.init_encdec(cfg, seed=0, device="cpu"))
    batch = _to(_batch(cfg, b=2), torch.from_numpy)
    grads = []
    for variant in (cfg.replace(remat=False), cfg):
        leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
        loss, _ = encdec.train_loss(lm.nested_params(leaves), batch, variant)
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_per_step_loss_follows_the_jax_step(weights):
    """5 steps (grad_accum 2: the microbatch split carries ``source``, a
    padding row) from the same params and batches."""
    cfg, jcfg = (c.replace(grad_accum=2) for c in _cfgs())
    opt, jopt = tadamw.AdamWConfig(**OPT), jadamw.AdamWConfig(**OPT)
    step = tstep.make_train_step(cfg, opt, lambda p, b: encdec.train_loss(
        lm.nested_params(p), b, cfg))
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jed.train_loss(p, b, jcfg)))
    js = jstep.init_train_state(weights[1], jopt)
    ts = tstep.init_train_state(convert.lm_params_from_jax(weights[0], "cpu"), opt)
    for i in range(5):
        batch = _batch(cfg, seed=10 + i, pad_rows=1)
        js, jm = jfn(js, _to(batch, jnp.asarray))
        ts, tm = step(ts, _to(batch, torch.from_numpy))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(tm["tokens"]) == float(jm["tokens"])


def test_encdec_checkpoint_cross_loads_bit_exact_both_ways(weights, tmp_path):
    cfg, jcfg = _cfgs()
    jopt = jadamw.AdamWConfig(**OPT)
    fn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jed.train_loss(p, b, jcfg)))
    js, _ = fn(jstep.init_train_state(weights[1], jopt), _to(_batch(jcfg, b=2), jnp.asarray))
    jsn = jax.tree.map(np.asarray, js)
    ts = {"params": convert.lm_params_from_jax(jsn["params"], "cpu"),
          "opt": tadamw.OptState(convert.lm_params_from_jax(jsn["opt"].mu, "cpu"),
                                 convert.lm_params_from_jax(jsn["opt"].nu, "cpu"),
                                 torch.tensor(int(jsn["opt"].step), dtype=torch.int32))}
    assert not convert.is_surrogate_params(ts["params"])
    path = tckpt.save_checkpoint(str(tmp_path / "port"), 1, ts)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 1, js)
    names = {f[:-4] for f in os.listdir(path) if f.endswith(".npy")}
    assert names == {f[:-4] for f in os.listdir(jpath) if f.endswith(".npy")}
    assert {"params__enc_layers__attn__wq", "opt__nu__dec_layers__cross__wk",
            "params__enc_final__scale"} <= names
    with open(os.path.join(path, "meta.json")) as f, open(os.path.join(jpath, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    jtemplate = jstep.init_train_state(jed.init_encdec(jax.random.PRNGKey(9), jcfg), jopt)
    restored, _ = jckpt.restore_checkpoint(path, jtemplate)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(js)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    template = tstep.init_train_state(
        lm.flat_params(encdec.init_encdec(cfg, seed=9, device="cpu")),
        tadamw.AdamWConfig(**OPT))
    back, _ = tckpt.restore_checkpoint(jpath, template)
    for got, want in ((back["params"], ts["params"]), (back["opt"].mu, ts["opt"].mu),
                      (back["opt"].nu, ts["opt"].nu)):
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_train_launcher_trains_on_planned_batches_with_zero_source(tmp_path):
    args = ttrain.build_parser().parse_args([
        "train", "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--num-samples", "128", "--seq-len", "16", "--nodes", "2", "--local-batch", "2",
        "--buffer", "32", "--epochs", "1", "--num-workers", "2",
        "--data", str(tmp_path / "tokens.bin")])
    trainer = ttrain.train(args)
    losses = [m["loss"] for m in trainer.metrics_history]
    assert len(losses) == 2 and all(np.isfinite(losses))


class _StepBatch:
    def to_global(self, capacity):
        return np.arange(3 * 17).reshape(3, 17), np.array([1, 1, 0], np.float32)


def test_make_batch_adds_zero_source_frames():
    cfg, _ = _cfgs()
    batch = ttrain.make_batch_fn(cfg, 3)(_StepBatch())
    assert batch["source"].shape == (3, cfg.source_len, cfg.d_model)
    assert batch["source"].dtype == np.float32 and not batch["source"].any()
    assert batch["tokens"].shape == batch["labels"].shape == (3, 16)
    assert "patches" not in batch
