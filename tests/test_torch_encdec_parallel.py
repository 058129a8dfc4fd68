"""The encoder-decoder split along ``model`` (``tensor_parallel.split_plan``'s
encdec plan, ``models/encdec.py``'s split paths) on 4 gloo ranks of this
CPU, against the port's unsharded step and engine and against the JAX
package.

One spawn of 4 ranks (``tests/_sharded_ranks.py``, one torch thread each,
joined under a time limit) on a ``("data", "model")`` = (2, 2) mesh trains
two steps (grad_accum 2 a data rank, clipping on) and serves a prefill and
4 greedy decode steps, in f32 at ``reduced()``, of whisper-medium (4 heads,
2 kv heads, a GELU hidden of 128: each rank computes 2 query heads and 1
kv head of every attention, the encoder's self-attention and the decoder's
self- and cross-attention, and 64 hidden units of both MLP stacks) with its
vocabulary of 256, which splits, and with one of 257, which stays whole as
whisper-medium's 51865 does at full size.

Tolerances, those of ``tests/test_torch_tensor_parallel.py``: against the
port's unsharded step at grad_accum A·D the loss within 1e-5 relative and
every rank's shard of every param and AdamW moment (the encoder's leaves
included) within 1e-4 of its leaf's max |value|; against the JAX step the
loss within 1e-5 relative and each param within 1e-4 of its max; serving,
every logit of the prefill and of each decode step within 1e-5 of the max
|logit| of the unsharded engine and of the JAX ``prefill`` and
``decode_step``, fed the same tokens.  Leaves that do not split (``bo``,
the LayerNorms) train alike on both model ranks, bit for bit.
"""
import multiprocessing as mp
import queue as queue_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sharded_ranks as ranks
from repro.configs import get_config as jax_config
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import encdec, lm
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep

torch.set_num_threads(1)

pytestmark = pytest.mark.dist

CONFIGS = {"whisper-medium": {}, "whisper-medium vocab 257": {"vocab_size": 257}}
ACCUM, DATA = 2, 2
B, S = 8, 32
WEIGHTS = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32)
CLIP = 0.25                 # below every step's gradient norm: clipping is on
PROMPT, GEN = 12, 4
MAX_LEN = PROMPT + GEN + 1
SPAWN_TIMEOUT_S = 240
TOL_STEP, TOL_JAX, TOL_SERVE = 1e-4, 1e-4, 1e-5

_jprefill = jax.jit(jed.prefill, static_argnames=("cfg", "spec"))
_jdecode = jax.jit(jed.decode_step, static_argnames=("cfg", "spec"))


def _cfgs(name):
    over = CONFIGS[name]
    return (get_config("whisper-medium").reduced().replace(**over),
            jax_config("whisper-medium").reduced().replace(**over))


def _jax_tree(name, seed=0, noise=0.05):
    """The JAX init with seeded noise on every leaf (its zero biases and unit
    LayerNorm scales would hide a misplaced bias)."""
    tree = jax.tree.map(np.asarray, jed.init_encdec(jax.random.PRNGKey(seed), _cfgs(name)[1]))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)


def _batch(name, seed):
    cfg = _cfgs(name)[0]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, :5] = -1
    source = rng.standard_normal((B, cfg.source_len, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "weights": WEIGHTS.copy(), "source": source}


def _batches(name):
    return [_batch(name, 50), _batch(name, 51)]


PROMPTS = np.random.default_rng(52).integers(0, 256, (2, PROMPT))
SOURCE = np.random.default_rng(53).standard_normal(
    (2, _cfgs("whisper-medium")[0].source_len, _cfgs("whisper-medium")[0].d_model)
).astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the 4 ranks once: {rank: results}."""
    tmp = tmp_path_factory.mktemp("encdec_parallel")
    jobs = {}
    for name, over in CONFIGS.items():
        jobs[f"train {name}"] = dict(kind="train", arch="whisper-medium", overrides=over,
                                     accum=ACCUM, params=_jax_tree(name),
                                     batches=_batches(name), opt={"clip_norm": CLIP},
                                     record=True)
        jobs[f"serve {name}"] = dict(kind="serve", arch="whisper-medium", overrides=over,
                                     params=_jax_tree(name), prompts=PROMPTS, source=SOURCE,
                                     gen=GEN, max_len=MAX_LEN)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=ranks.run_rank, args=(r, str(tmp / "pg"), jobs, q))
             for r in range(ranks.WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, out = q.get(timeout=SPAWN_TIMEOUT_S)
            if isinstance(out, str):
                pytest.fail(f"rank {rank} failed:\n{out}")
            results[rank] = out
    except queue_mod.Empty:
        pytest.fail(f"ranks {sorted(set(range(ranks.WORLD)) - set(results))} "
                    f"gave no result in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return results


def _port_steps(name):
    cfg = _cfgs(name)[0].replace(grad_accum=ACCUM * DATA)
    opt = tadamw.AdamWConfig(**{**ranks.OPT, "clip_norm": CLIP})
    step = tstep.make_train_step(cfg, opt, lambda p, b: encdec.train_loss(
        lm.nested_params(p), b, cfg))
    state = tstep.init_train_state(convert.lm_params_from_jax(_jax_tree(name), "cpu"), opt)
    metrics = []
    for b in _batches(name):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    host = {n: {k: convert.tensor_to_numpy(v).astype(np.float32) for k, v in d.items()}
            for n, d in (("params", state["params"]), ("mu", state["opt"].mu),
                         ("nu", state["opt"].nu))}
    return metrics, host


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_encdec_step_matches_the_unsharded_step(run, name):
    metrics, want = _port_steps(name)
    assert any(k.startswith("enc_layers.") for k in want["params"])
    for out in run.values():
        got = out[f"train {name}"]["metrics"]
        for g, ref in zip(got, metrics):
            assert abs(g["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
            assert g["tokens"] == ref["tokens"]
            assert abs(g["grad_norm"] - ref["grad_norm"]) <= 1e-5 * ref["grad_norm"]
            assert ref["grad_norm"] > CLIP
    ranks.assert_shards(run, f"train {name}", want, TOL_STEP)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_encdec_step_matches_the_jax_step(run, name):
    jcfg = _cfgs(name)[1].replace(grad_accum=ACCUM * DATA)
    jopt = jadamw.AdamWConfig(**{**ranks.OPT, "clip_norm": CLIP})
    fn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jed.train_loss(p, b, jcfg)))
    js = jstep.init_train_state(jax.tree.map(jnp.asarray, _jax_tree(name)), jopt)
    losses = []
    for b in _batches(name):
        js, m = fn(js, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    for out in run.values():
        np.testing.assert_allclose([m["loss"] for m in out[f"train {name}"]["metrics"]],
                                   losses, rtol=1e-5)
    want = {"params": lm.flat_params(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                  js["params"]))}
    ranks.assert_shards(run, f"train {name}", want, TOL_JAX, names=("params",))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encdec_leaves_that_do_not_split_train_alike_on_the_model_ranks(run, name):
    """``bo``, the LayerNorms and (vocabulary 257) the embedding get the same
    gradient on both model ranks: params and moments agree bit for bit."""
    job = f"train {name}"
    pairs = {}
    for out in run.values():
        pairs.setdefault(out["coord"]["data"], {})[out["coord"]["model"]] = out[job]
    whole = [k for k, spec in run[0][job]["specs"].items()
             if not any(e == "model" or (isinstance(e, tuple) and "model" in e) for e in spec)]
    assert {"enc_layers.mlp.bo", "dec_layers.ln_x.scale", "enc_final.bias"} <= set(whole)
    assert ("embed" in whole) == (_cfgs(name)[0].vocab_size % 2 == 1)
    for pair in pairs.values():
        for part in ("params", "mu", "nu"):
            for k in whole:
                assert np.array_equal(pair[0][part][k], pair[1][part][k]), (part, k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rank_0_attends_on_its_heads_and_caches_its_kv_heads(run, name):
    """Every attention rank 0 runs (K2's plain stand-in on the CPU) in
    training and serving takes 2 of 4 query heads and 1 of 2 kv heads; the
    self- and cross-attention caches hold each rank's kv head."""
    cfg = _cfgs(name)[0]
    want = (cfg.num_heads // 2, cfg.num_kv_heads // 2)
    for kind in ("train", "serve"):
        seen = run[0][f"{kind} {name}"]["seen"]
        # a prefill: the encoder's layers and the decoder's two a layer
        assert len(seen["attention"]) >= cfg.encoder_layers + 2 * cfg.num_layers
        assert set(seen["attention"]) == {want}
    for out in run.values():
        serve = out[f"serve {name}"]
        assert serve["kv_heads"] == serve["cross_kv_heads"] == cfg.num_kv_heads // 2
        assert serve["slots"] == MAX_LEN


def _unsharded_serve(name, tokens):
    """The unsharded engine's and the JAX package's prefill logits and the
    logits of decode steps fed ``tokens`` (the split run's choices)."""
    cfg, jcfg = _cfgs(name)
    tree = _jax_tree(name)
    eng = ServeEngine(cfg, lm.nested_params(convert.lm_params_from_jax(tree, "cpu")),
                      max_len=MAX_LEN, device="cpu")
    logits, cache = eng.prefill(PROMPTS, SOURCE)
    jspec, jparams = jlm.CacheSpec.build(jcfg, MAX_LEN), jax.tree.map(jnp.asarray, tree)
    jlogits, jcache = _jprefill(jparams, jnp.asarray(PROMPTS, jnp.int32), jnp.asarray(SOURCE),
                                cfg=jcfg, spec=jspec)
    port, ref = [logits.numpy()], [np.asarray(jlogits)]
    for tok in tokens:
        logits, cache = eng.step(cache, torch.from_numpy(tok))
        jlogits, jcache = _jdecode(jparams, jcache, jnp.asarray(tok, jnp.int32), cfg=jcfg,
                                   spec=jspec)
        port.append(logits.numpy())
        ref.append(np.asarray(jlogits))
    return port, ref


@pytest.mark.parametrize("reference", ["port", "jax"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_encdec_serving_matches_the_unsharded_engine_and_jax(run, name, reference):
    cfg = _cfgs(name)[0]
    got0 = run[0][f"serve {name}"]["logits"]
    tokens = [np.argmax(x, axis=-1) for x in got0[:-1]]
    want = _unsharded_serve(name, tokens)[reference == "jax"]
    for rank, out in run.items():
        got = out[f"serve {name}"]["logits"]
        assert len(got) == GEN + 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape == (PROMPTS.shape[0], cfg.vocab_size)
            err = float(np.abs(g - w).max())
            assert err <= TOL_SERVE * float(np.abs(w).max()), (rank, i, err)
