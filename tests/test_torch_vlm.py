"""The port's vlm stub (llava-next-mistral-7b) against the JAX package on the
CPU at ``reduced()`` in f32, from the same weights: the ``mm_proj`` patch
prefix in prefill and decode, the training loss (patch positions carry no
loss) and every gradient, the train step and the launcher's zero patches.

Like the JAX engine, the port's ``ServeEngine`` takes no patch embeddings
and so refuses the family; vlm serving runs through ``lm.prefill(...,
patches=)`` and ``lm.decode_step``, as the JAX package's own
test_models.py:49 drives it.

The JAX init leaves norm scales at zero, which would hide a ``1 + scale``
bug, so every leaf gets seeded numpy noise before it is handed to both
sides.  Tolerances as in ``test_torch_lm_train.py``: logits and caches 1e-5,
the loss 1e-5 relative, each gradient leaf 1e-4 of its max |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

ARCH = "llava-next-mistral-7b"
TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)

_jprefill = jax.jit(jlm.prefill, static_argnames=("cfg", "spec", "attn_impl"))
_jdecode = jax.jit(jlm.decode_step, static_argnames=("cfg", "spec"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfgs():
    return get_config(ARCH).reduced(), jax_config(ARCH).reduced()


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), _cfgs()[1]))
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)


def _inputs(cfg, b=2, s=12, seed=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    patches = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return tokens, patches


def test_init_matches_jax_layout():
    cfg, jcfg = _cfgs()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jcfg)))
    params = lm.init_lm(cfg, seed=0, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                       params)
    assert got == want and params["mm_proj"].shape == (cfg.d_model, cfg.d_model)


def test_prefill_and_decode_match_jax(weights):
    """The cache counts the patch prefix: positions (rope too) run over
    patches and tokens together."""
    cfg, jcfg = _cfgs()
    params = convert.params_from_jax(weights, "cpu")
    jparams = jax.tree.map(jnp.asarray, weights)
    tokens, patches = _inputs(cfg)
    max_len = cfg.num_patches + tokens.shape[1] + 9
    spec, jspec = lm.CacheSpec.build(cfg, max_len), jlm.CacheSpec.build(jcfg, max_len)
    logits, cache = lm.prefill(params, torch.from_numpy(tokens).long(), cfg, spec,
                               patches=torch.from_numpy(patches))
    jlogits, jcache = _jprefill(jparams, jnp.asarray(tokens), cfg=jcfg, spec=jspec,
                                patches=jnp.asarray(patches))
    _close(logits, jlogits)
    assert cache["pos"] == int(jcache["pos"]) == cfg.num_patches + tokens.shape[1]
    for key in ("k", "v"):
        _close(cache[key], jcache[key])
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for _ in range(8):
        logits, cache = lm.decode_step(params, cache, torch.from_numpy(tok).long(), cfg, spec)
        jlogits, jcache = _jdecode(jparams, jcache, jnp.asarray(tok), cfg=jcfg, spec=jspec)
        _close(logits, jlogits)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)


def test_decode_matches_full_forward(weights):
    """Counterpart of test_models.py:49 for the vlm family."""
    cfg, _ = _cfgs()
    params = convert.params_from_jax(weights, "cpu")
    tokens, patches = (torch.from_numpy(a) for a in _inputs(cfg, s=24))
    tokens = tokens.long()
    spec = lm.CacheSpec.build(cfg, 24 + cfg.num_patches + 4)
    logits, cache = lm.prefill(params, tokens[:, :21], cfg, spec, patches=patches)
    for t in range(21, 24):
        logits, cache = lm.decode_step(params, cache, tokens[:, t], cfg, spec)
    hidden, _ = lm.forward_hidden(params, tokens, cfg, patches=patches)
    want = lm._logits(params, hidden[:, -tokens.shape[1]:], cfg)[:, -1]
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=5e-3, rtol=1e-3)


def test_the_cache_must_hold_the_patch_prefix(weights):
    cfg, _ = _cfgs()
    params = convert.params_from_jax(weights, "cpu")
    tokens, patches = (torch.from_numpy(a) for a in _inputs(cfg))
    spec = lm.CacheSpec.build(cfg, tokens.shape[1] + 4)  # room for the tokens only
    with pytest.raises(ValueError, match="patch prefix"):
        lm.prefill(params, tokens.long(), cfg, spec, patches=patches)
    with pytest.raises(ValueError, match="patch embeddings"):
        lm.forward_hidden(params, tokens.long(), cfg)


def test_the_engine_refuses_the_vlm_family_as_jax_does(weights):
    cfg, _ = _cfgs()
    with pytest.raises(NotImplementedError, match=r"lm\.prefill\(\.\.\., patches=\)"):
        ServeEngine(cfg, convert.params_from_jax(weights, "cpu"), max_len=32, device="cpu")


def _batch(cfg, b=4, s=16, seed=2, pad_rows=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1
    weights = np.ones((b,), np.float32)
    if pad_rows:
        weights[-pad_rows:] = 0.0
    patches = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "weights": weights, "patches": patches}


def _to(batch, fn):
    return {k: fn(v) for k, v in batch.items()}


def test_train_loss_and_every_gradient_match_jax(weights):
    cfg, jcfg = _cfgs()
    batch = _batch(cfg, pad_rows=1)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(p, _to(batch, jnp.asarray), jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, weights))
    flat = convert.lm_params_from_jax(weights, "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, metrics = lm.train_loss(lm.nested_params(leaves), _to(batch, torch.from_numpy), cfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert float(metrics["tokens"]) == float(jm["tokens"])
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    want = lm.flat_params(jax.tree.map(np.asarray, jgrads))
    assert sorted(grads) == sorted(want) and "mm_proj" in grads
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(grads[k].numpy() - w).max())
        assert err <= GRAD_TOL * scale, f"{k}: max |diff| {err:.3e}"


def test_per_step_loss_follows_the_jax_step(weights):
    """5 steps (grad_accum 2: the microbatch split carries ``patches``, a
    padding row) from the same params and batches."""
    cfg, jcfg = (c.replace(grad_accum=2) for c in _cfgs())
    opt, jopt = tadamw.AdamWConfig(**OPT), jadamw.AdamWConfig(**OPT)
    step = tstep.make_train_step(cfg, opt, lambda p, b: lm.train_loss(lm.nested_params(p),
                                                                      b, cfg))
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    js = jstep.init_train_state(jax.tree.map(jnp.asarray, weights), jopt)
    ts = tstep.init_train_state(convert.lm_params_from_jax(weights, "cpu"), opt)
    for i in range(5):
        batch = _batch(cfg, seed=10 + i, pad_rows=1)
        js, jm = jfn(js, _to(batch, jnp.asarray))
        ts, tm = step(ts, _to(batch, torch.from_numpy))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(tm["tokens"]) == float(jm["tokens"])


class _StepBatch:
    def to_global(self, capacity):
        return np.arange(3 * 17).reshape(3, 17), np.array([1, 1, 0], np.float32)


def test_make_batch_adds_zero_patches():
    cfg, _ = _cfgs()
    batch = ttrain.make_batch_fn(cfg, 3)(_StepBatch())
    assert batch["patches"].shape == (3, cfg.num_patches, cfg.d_model)
    assert batch["patches"].dtype == np.float32 and not batch["patches"].any()
    assert "source" not in batch


def test_train_launcher_trains_the_vlm_family(tmp_path):
    args = ttrain.build_parser().parse_args([
        "train", "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--num-samples", "128", "--seq-len", "16", "--nodes", "2", "--local-batch", "2",
        "--buffer", "32", "--epochs", "1", "--num-workers", "2",
        "--data", str(tmp_path / "tokens.bin")])
    losses = [m["loss"] for m in ttrain.train(args).metrics_history]
    assert len(losses) == 2 and all(np.isfinite(losses))
