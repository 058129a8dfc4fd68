"""Tensor parallelism along ``model`` (``repro_torch.distributed.
tensor_parallel``) on 4 gloo ranks of this CPU, against the port's
unsharded step and engine and against the JAX package.

One spawn of 4 ranks (``tests/_sharded_ranks.py``, one torch thread each,
joined under a time limit) on a ``("data", "model")`` = (2, 2) mesh trains
two steps (grad_accum 2 a data rank, clipping on) and serves a prefill and
4 greedy decode steps of reduced qwen2-0.5b (dense), hymba-1.5b (hybrid)
and falcon-mamba-7b (ssm) in f32, where heads, kv heads, MLP hidden, DI and
vocabulary all divide 2, and of a hymba with 3 heads, 1 kv head and a
vocabulary of 257, where attention and the vocabulary do not split (the
degraded path: they are computed whole on both model ranks).  Training adds
qwen2-0.5b and falcon-mamba-7b at 4 layers with a two-level ``scan_block``
of 2, hymba-1.5b with remat off and a ``ce_chunk`` of 8, and qwen2-0.5b
untied.  Serving adds qwen2 with 1 kv head, repeated to 2 in the cache
(``CacheSpec``'s repeat case: each rank computes and caches the kv head
its query heads read), and qwen2-0.5b and hymba-1.5b at an int8 and an f32
cache.  The moe and vlm families' split has its own file,
``tests/test_torch_expert_parallel.py``, the encoder-decoder's
``tests/test_torch_encdec_parallel.py``.

Flash-decoding: where attention does not split and the kv heads do not
divide the axis, each rank's cache holds its half of the slots and decode
attention all-reduces the partial softmax.  Served so: the hymba with 3
heads (its ring of 32 slots, 16 a rank, wrapped by the prompt of 40) at
the compute dtype's and an int8 cache; a qwen2-0.5b with 3 heads and 1 kv head
(a cache of 46 slots, 23 a rank), from the prompt of 40 and from one of 8,
shorter than a rank's block, so that rank 1 holds no valid slot in any
step; the same qwen2 with 45 slots, which do not divide 2, so its cache
stays whole; and a qwen2 where nothing but the cache splits (3 heads, an
MLP of 129, a vocabulary of 257), whose plan exists for the model group.

Tolerances.  Against the port's unsharded step at grad_accum A·D (the
sharded step's reference, ``tests/test_torch_sharded_train.py``): the loss
within 1e-5 relative, every rank's shard of every param and AdamW moment
within 1e-4 of its leaf's max |value|: a row-parallel product sums its
halves on two ranks, and reduced hymba-1.5b's gradients move by 4e-6 of
their max when one leaf moves by an ulp.  The first moment after the first
step is the clipped gradient, so the moments hold every leaf's gradient
(``x_proj`` and ``in_proj`` included) to the reference.  Against the JAX
step: the loss within 1e-5 relative and each param within 1e-4 of its max,
the bounds of ``tests/test_torch_lm_train.py``.  Serving: every logit of
the prefill and of each decode step within 1e-5 of the max |logit| of the
unsharded engine fed the same tokens; hymba-1.5b's int8 cache within
1.2e-4, the unsharded engine's own sensitivity there (``SERVE_TOL``).  Leaves that do not split are
trained alike on both model ranks, bit for bit.
"""
import multiprocessing as mp
import queue as queue_mod
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sharded_ranks as ranks
from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep

torch.set_num_threads(1)

pytestmark = pytest.mark.dist

DEGRADED = dict(num_heads=3, num_kv_heads=1, vocab_size=257)
FLASH = dict(num_heads=3, num_kv_heads=1)
CONFIGS = {"qwen2-0.5b": ("qwen2-0.5b", {}), "hymba-1.5b": ("hymba-1.5b", {}),
           "falcon-mamba-7b": ("falcon-mamba-7b", {}),
           "hymba-1.5b 3 heads": ("hymba-1.5b", DEGRADED),
           "qwen2-0.5b scan_block 2": ("qwen2-0.5b", {"num_layers": 4, "scan_block": 2}),
           "falcon-mamba-7b scan_block 2": ("falcon-mamba-7b",
                                            {"num_layers": 4, "scan_block": 2}),
           "hymba-1.5b no remat ce_chunk 8": ("hymba-1.5b", {"remat": False, "ce_chunk": 8}),
           "qwen2-0.5b untied": ("qwen2-0.5b", {"tie_embeddings": False})}
SERVE = {**{k: CONFIGS[k] for k in list(CONFIGS)[:4]},
         "qwen2-0.5b 1 kv head": ("qwen2-0.5b", {"num_kv_heads": 1}),
         "qwen2-0.5b int8 cache": ("qwen2-0.5b", {"kv_cache_dtype": "int8"}),
         "qwen2-0.5b f32 cache": ("qwen2-0.5b", {"kv_cache_dtype": "float32"}),
         "hymba-1.5b int8 cache": ("hymba-1.5b", {"kv_cache_dtype": "int8"}),
         "hymba-1.5b f32 cache": ("hymba-1.5b", {"kv_cache_dtype": "float32"}),
         "hymba-1.5b 3 heads int8 cache": ("hymba-1.5b", {**DEGRADED, "kv_cache_dtype": "int8"}),
         "qwen2-0.5b 3 heads": ("qwen2-0.5b", FLASH),
         "qwen2-0.5b 3 heads short prompt": ("qwen2-0.5b", FLASH),
         "qwen2-0.5b 3 heads odd cache": ("qwen2-0.5b", FLASH),
         "qwen2-0.5b only the cache splits": ("qwen2-0.5b", {**DEGRADED, "d_ff": 129})}
#: (attention, mlp, mamba, vocab) that split at (data 2, model 2)
SPLITS = {"qwen2-0.5b": (True, True, False, True), "hymba-1.5b": (True, True, True, True),
          "falcon-mamba-7b": (False, False, True, True),
          "hymba-1.5b 3 heads": (False, True, True, False),
          "hymba-1.5b 3 heads int8 cache": (False, True, True, False),
          "qwen2-0.5b 3 heads": (False, True, False, True),
          "qwen2-0.5b only the cache splits": (False, False, False, False)}
SPLITS.update({name: SPLITS[arch] for name, (arch, over) in {**CONFIGS, **SERVE}.items()
               if name not in SPLITS and "num_kv_heads" not in over})
SPLITS["qwen2-0.5b 1 kv head"] = SPLITS["qwen2-0.5b"]
SPLITS["qwen2-0.5b 3 heads short prompt"] = SPLITS["qwen2-0.5b 3 heads odd cache"] = \
    SPLITS["qwen2-0.5b 3 heads"]
ACCUM, DATA = 2, 2
B, S = 8, 32
WEIGHTS = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32)
CLIP = 0.25                 # below every step's gradient norm: clipping is on
PROMPT, GEN = 40, 4         # 40 > hymba's reduced window of 32: its ring wraps
#: (prompt, max_len) of the serving cases that differ from (PROMPT, PROMPT + GEN + 1)
SERVE_SHAPE = {"qwen2-0.5b 3 heads": (PROMPT, 46), "qwen2-0.5b 3 heads short prompt": (8, 46),
               "qwen2-0.5b only the cache splits": (PROMPT, 46)}
#: the cache slots a rank holds where the sequence splits (the rest: all)
SLOTS = {"hymba-1.5b 3 heads": 16, "hymba-1.5b 3 heads int8 cache": 16,
         "qwen2-0.5b 3 heads": 23, "qwen2-0.5b 3 heads short prompt": 23,
         "qwen2-0.5b only the cache splits": 23}
SPAWN_TIMEOUT_S = 240
TOL_STEP, TOL_JAX, TOL_SERVE = 1e-4, 1e-4, 1e-5
#: hymba's int8 cache: the unsharded engine's own logits move by up to
#: 1.21e-4 of their max when every weight moves by 1e-7 relative (int8
#: rounding of K/V rows flips), at an f32 cache by at most 4.7e-6
SERVE_TOL = {"hymba-1.5b int8 cache": 1.2e-4, "hymba-1.5b 3 heads int8 cache": 1.2e-4}


def _cfgs(name):
    arch, over = {**CONFIGS, **SERVE}[name]
    return get_config(arch).reduced().replace(**over), jax_config(arch).reduced().replace(**over)


def _jax_tree(name, seed=0, noise=0.05):
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed), _cfgs(name)[1]))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)


def _batch(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, :5] = -1
    return {"tokens": tokens, "labels": labels, "weights": WEIGHTS.copy()}


BATCHES = [_batch(30), _batch(31)]
PROMPTS = np.random.default_rng(32).integers(0, 256, (2, PROMPT))


def _serve_shape(name):
    return SERVE_SHAPE.get(name, (PROMPT, PROMPT + GEN + 1))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the 4 ranks once: {rank: results}."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    jobs = {}
    for name, (arch, over) in CONFIGS.items():
        jobs[f"train {name}"] = dict(kind="train", arch=arch, overrides=over, accum=ACCUM,
                                     params=_jax_tree(name), batches=BATCHES,
                                     opt={"clip_norm": CLIP}, record=True)
    for name, (arch, over) in SERVE.items():
        prompt, max_len = _serve_shape(name)
        jobs[f"serve {name}"] = dict(kind="serve", arch=arch, overrides=over,
                                     params=_jax_tree(name), prompts=PROMPTS[:, :prompt],
                                     gen=GEN, max_len=max_len)
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
    step = tstep.make_train_step(cfg, opt, lambda p, b: lm.train_loss(
        lm.nested_params(p), b, cfg))
    state = tstep.init_train_state(convert.lm_params_from_jax(_jax_tree(name), "cpu"), opt)
    metrics = []
    for b in BATCHES:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    host = {n: {k: convert.tensor_to_numpy(v).astype(np.float32) for k, v in d.items()}
            for n, d in (("params", state["params"]), ("mu", state["opt"].mu),
                         ("nu", state["opt"].nu))}
    return metrics, host


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_step_matches_the_unsharded_step(run, name):
    metrics, want = _port_steps(name)
    for out in run.values():
        got = out[f"train {name}"]["metrics"]
        for g, ref in zip(got, metrics):
            assert abs(g["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
            assert g["tokens"] == ref["tokens"]
            # the global norm of split and replicated leaves, and clipping on
            assert abs(g["grad_norm"] - ref["grad_norm"]) <= 1e-5 * ref["grad_norm"]
            assert ref["grad_norm"] > CLIP
    ranks.assert_shards(run, f"train {name}", want, TOL_STEP)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_step_matches_the_jax_step(run, name):
    jcfg = _cfgs(name)[1].replace(grad_accum=ACCUM * DATA)
    jopt = jadamw.AdamWConfig(**{**ranks.OPT, "clip_norm": CLIP})
    fn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    js = jstep.init_train_state(jax.tree.map(jnp.asarray, _jax_tree(name)), jopt)
    losses = []
    for b in BATCHES:
        js, m = fn(js, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    for out in run.values():
        np.testing.assert_allclose([m["loss"] for m in out[f"train {name}"]["metrics"]],
                                   losses, rtol=1e-5)
    want = {"params": _flat_np(jax.tree.map(np.asarray, js["params"]))}
    ranks.assert_shards(run, f"train {name}", want, TOL_JAX, names=("params",))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_leaves_that_do_not_split_train_alike_on_the_model_ranks(run, name):
    """Norm scales (and, where they do not split, attention and the
    vocabulary) get the same gradient on both model ranks and no reduction
    along ``model``: their params and moments agree bit for bit."""
    job = f"train {name}"
    pairs = {}
    for out in run.values():
        pairs.setdefault(out["coord"]["data"], {})[out["coord"]["model"]] = out[job]
    whole = [k for k, spec in run[0][job]["specs"].items()
             if not any(e == "model" or (isinstance(e, tuple) and "model" in e) for e in spec)]
    assert {"layers.ln1", "final_norm"} <= set(whole)
    for pair in pairs.values():
        for part in ("params", "mu", "nu"):
            for k in whole:
                assert np.array_equal(pair[0][part][k], pair[1][part][k]), (part, k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rank_0_runs_attention_and_the_scan_on_its_heads_and_channels(run, name):
    """The plain paths of K2 and K3 (the kernels' stand-ins on the CPU) see
    rank 0's H/2 query heads and K/2 kv heads and DI/2 channels, or the
    whole where the part does not split."""
    cfg = _cfgs(name)[0]
    attention, _, mamba, _ = SPLITS[name]
    seen = run[0][f"train {name}"]["seen"]
    if cfg.family != "ssm":
        h, k = cfg.num_heads, cfg.num_kv_heads
        want = (h // 2, k // 2) if attention else (h, k)
        assert seen["attention"] and set(seen["attention"]) == {want}
    if cfg.family in ("ssm", "hybrid"):
        want = cfg.ssm_d_inner // 2 if mamba else cfg.ssm_d_inner
        assert seen["scan"] and set(seen["scan"]) == {want}


def _unsharded_serve(name, tokens):
    """The unsharded engine's prefill logits and the logits of decode steps
    fed ``tokens`` (the split run's choices)."""
    cfg = _cfgs(name)[0]
    prompt, max_len = _serve_shape(name)
    params = lm.nested_params(convert.lm_params_from_jax(_jax_tree(name), "cpu"))
    eng = ServeEngine(cfg, params, max_len=max_len, device="cpu")
    logits, cache = eng.prefill(PROMPTS[:, :prompt])
    out = [logits.numpy()]
    for tok in tokens:
        logits, cache = eng.step(cache, torch.from_numpy(tok))
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("name", list(SERVE))
def test_split_serving_matches_the_unsharded_engine(run, name):
    cfg = _cfgs(name)[0]
    got0 = run[0][f"serve {name}"]["logits"]
    tokens = [np.argmax(x, axis=-1) for x in got0[:-1]]
    want = _unsharded_serve(name, tokens)
    for rank, out in run.items():
        got = out[f"serve {name}"]["logits"]
        assert len(got) == GEN + 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape == (PROMPTS.shape[0], cfg.vocab_size)
            assert np.isfinite(g).all(), (rank, i)
            err = float(np.abs(g - w).max())
            assert err <= SERVE_TOL.get(name, TOL_SERVE) * float(np.abs(w).max()), \
                (rank, i, err)


@pytest.mark.parametrize("name", list(SERVE))
def test_split_cache_holds_the_ranks_heads_and_channels(run, name):
    """The cache holds each rank's kv heads (the repeated head in the
    repeat case; all of them where attention does not split), its block of
    the slots where the sequence splits (the int8 scales too), and its DI
    channels."""
    cfg = _cfgs(name)[0]
    attention, _, mamba, _ = SPLITS[name]
    for out in run.values():
        out = out[f"serve {name}"]
        if cfg.kv_cache_dtype == "int8":
            assert out["int8"]
        if cfg.family != "ssm":
            spec = lm.CacheSpec.build(cfg, _serve_shape(name)[1], 2)
            assert out["kv_heads"] == (spec.kv_heads // 2 if attention else spec.kv_heads)
            assert out["slots"] == SLOTS.get(name, spec.cache_len)
            assert out["scale_slots"] == (out["slots"] if spec.quantized else 0)
            assert out["slots"] * (2 if name in SLOTS else 1) == spec.cache_len
    out = run[0][f"serve {name}"]
    if cfg.family in ("ssm", "hybrid"):
        assert out["ssm_channels"] == cfg.ssm_d_inner // (2 if mamba else 1)
    if name == "qwen2-0.5b 1 kv head":
        assert out["kv_heads"] == 1 and set(out["seen"]["attention"]) == {(2, 1)}


@pytest.mark.parametrize("name", ["qwen2-0.5b", "hymba-1.5b 3 heads"])
def test_whole_gathers_a_dtensor_from_every_ranks_shard(run, name):
    """``fsdp.whole`` (the gather that avoids DTensor's functional
    collectives) gives each rank the leaf its four shards make."""
    job = f"train {name}"
    for k in run[0][job]["whole"]:
        spec = run[0][job]["specs"][k]
        full = run[0][job]["whole"][k]
        for out in run.values():
            assert np.array_equal(out[job]["whole"][k], full), k
            assert np.array_equal(ranks.block_of(full, spec, out["coord"]),
                                  out[job]["params"][k]), k


# -- the plan, on fake meshes -------------------------------------------------------


class _FakeMesh(SimpleNamespace):
    """What ``split_plan`` and ``param_sharding`` read of a DeviceMesh."""

    def size(self, d=None):
        return int(np.prod(self.shape)) if d is None else self.shape[d]

    def get_group(self, name):
        return f"group {name}"

    def get_local_rank(self, name):
        return self.rank


def _mesh(shape, names=("data", "model"), rank=0):
    return _FakeMesh(shape=shape, mesh_dim_names=names, rank=rank)


def _plan(cfg, mesh):
    return tp.split_plan(cfg, lm.flat_params(lm.init_lm(cfg, device="meta")), mesh)


@pytest.mark.parametrize("arch,shape,want", [
    ("qwen2-0.5b", (1, 2), (True, True, False, True, False)),
    ("qwen2-0.5b", (16, 16), (False, True, False, True, False)),  # 14 heads at 16
    ("hymba-1.5b", (1, 2), (False, True, True, False, False)),    # 25 heads, vocab 32001
    ("hymba-1.5b", (16, 16), (False, True, True, False, False)),
    ("falcon-mamba-7b", (16, 16), (False, False, True, True, False)),
    ("minitron-8b", (16, 16), (True, True, False, True, False)),  # 8 kv heads repeated
    ("qwen2-moe-a2.7b", (16, 16), (True, True, False, True, True)),  # mlp: shared expert
    ("qwen2-moe-a2.7b", (1, 2), (True, True, False, True, True)),
    ("phi3.5-moe-42b-a6.6b", (16, 16), (True, False, False, True, True)),  # no shared
    ("phi3.5-moe-42b-a6.6b", (1, 2), (True, False, False, True, True)),
    ("llava-next-mistral-7b", (16, 16), (True, True, False, True, False)),
    ("llava-next-mistral-7b", (1, 2), (True, True, False, True, False))])
def test_plan_splits_where_the_chosen_spec_puts_model_on_the_split_dim(arch, shape, want):
    cfg = get_config(arch)
    plan = _plan(cfg, _mesh(shape))
    assert (plan.attention, plan.mlp, plan.mamba, plan.vocab, plan.experts) == want
    assert plan.size == shape[1] and plan.group == "group model"
    specs = {k: s.spec for k, s in tsh.param_sharding(
        lm.flat_params(lm.init_lm(cfg, device="meta")), _mesh(shape)).items()}
    for name, (dim, mode) in plan.leaves.items():
        stored = tsh.names_axis(specs[name], dim)
        assert mode == (tp.HALVES if name.endswith("in_proj")
                        else tp.LOCAL if stored else tp.SLICE), name
    if plan.mamba:
        assert plan.leaves["layers.ssm.in_proj"] == (2, tp.HALVES)
    if arch == "minitron-8b":   # wk, wv stored whole: each rank slices its kv head
        assert plan.leaves["layers.wk"] == (2, tp.SLICE)
        assert plan.leaves["layers.wq"] == (2, tp.LOCAL)
    if plan.experts:            # the experts come as the rank's stored block
        for leaf in ("we_gate", "we_up", "we_down"):
            assert plan.leaves[f"layers.{leaf}"] == (1, tp.LOCAL), leaf
    if plan.mlp and cfg.family == "moe":
        assert plan.leaves["layers.ws_gate"] == (2, tp.LOCAL)
        assert plan.leaves["layers.ws_down"] == (1, tp.LOCAL)
    # computed whole on every rank: the router, and the vlm patch projection,
    # whose spec puts model on the output d
    assert "layers.router" not in plan.leaves and "mm_proj" not in plan.leaves


def _encdec_plan(cfg, mesh):
    from repro_torch.models.encdec import init_encdec

    return tp.split_plan(cfg, lm.flat_params(init_encdec(cfg, device="meta")), mesh)


@pytest.mark.parametrize("shape", [(16, 16), (1, 2)])
def test_encdec_plan_splits_heads_and_hidden_not_its_vocabulary(shape):
    """whisper-medium: 16 heads and a GELU hidden of 4096 split at 2 and
    16, its vocabulary of 51865 at neither; every attention (encoder self,
    decoder self and cross) and both MLP stacks are members, stored split
    (``LOCAL``); ``bo`` and the LayerNorms are not."""
    cfg = get_config("whisper-medium")
    plan = _encdec_plan(cfg, _mesh(shape))
    assert (plan.attention, plan.mlp, plan.mamba, plan.vocab, plan.experts) == \
        (True, True, False, False, False)
    attn = {f"{s}.{n}" for s in ("enc_layers.attn", "dec_layers.self", "dec_layers.cross")
            for n in ("wq", "wk", "wv", "wo")}
    mlp = {f"{s}.{n}" for s in ("enc_layers.mlp", "dec_layers.mlp") for n in ("wi", "bi", "wo")}
    assert set(plan.leaves) == attn | mlp
    assert all(mode == tp.LOCAL for _, mode in plan.leaves.values())
    assert plan.leaves["dec_layers.cross.wq"] == (2, tp.LOCAL)
    assert plan.leaves["dec_layers.self.wo"] == plan.leaves["enc_layers.mlp.wo"] == (1, tp.LOCAL)
    assert plan.leaves["enc_layers.mlp.wi"] == (2, tp.LOCAL)
    assert plan.leaves["dec_layers.mlp.bi"] == (1, tp.LOCAL)


@pytest.mark.parametrize("vocab,split", [(256, True), (257, False)])
def test_reduced_encdec_plan_splits_its_vocabulary_where_it_divides(vocab, split):
    """Reduced whisper (vocabulary 256) splits its tied embedding at 2, as
    the full size does not; one of 257 stays whole, as at full size."""
    cfg = get_config("whisper-medium").reduced().replace(vocab_size=vocab)
    plan = _encdec_plan(cfg, _mesh((2, 2)))
    assert plan.attention and plan.mlp and plan.vocab == split
    assert ("embed" in plan.leaves) == split


def test_a_plan_without_a_split_part_still_carries_the_model_group():
    """Nothing splits (3 heads, an MLP of 129, a vocabulary of 257), yet the
    plan exists: the cache's sequence split needs its group."""
    cfg = get_config("qwen2-0.5b").reduced().replace(num_heads=3, num_kv_heads=1,
                                                     vocab_size=257, d_ff=129)
    plan = _plan(cfg, _mesh((2, 2), rank=1))
    assert plan is not None and plan.group == "group model" and not plan.leaves
    assert not any((plan.attention, plan.mlp, plan.mamba, plan.vocab, plan.experts))
    assert tp.cache_block(plan, lm.CacheSpec.build(cfg, 46, 2)) == (23, 23)


@pytest.mark.parametrize("arch,over,shape,max_len,rank,want", [
    ("hymba-1.5b", {}, (1, 2), 1600, 1, (512, 512)),   # 5 kv heads: its ring of 1024
    ("hymba-1.5b", {}, (16, 16), 32768, 3, (192, 64)),
    ("qwen2-0.5b", {}, (16, 16), 32768, 15, (30720, 2048)),  # 14 heads: no repeat
    ("qwen2-0.5b", {}, (1, 2), 32768, 1, None),        # heads split
    ("minitron-8b", {}, (16, 16), 4096, 0, None),      # 8 kv heads repeated to 16
    ("hymba-1.5b", {}, (1, 2), 999, 0, None),          # 999 slots do not divide 2
    ("falcon-mamba-7b", {}, (1, 2), 4096, 0, None)])   # no kv cache
def test_cache_block_is_the_ranks_slots_where_the_heads_do_not_split(arch, over, shape,
                                                                     max_len, rank, want):
    cfg = get_config(arch).replace(**over)
    plan = _plan(cfg, _mesh(shape, rank=rank))
    assert tp.cache_block(plan, lm.CacheSpec.build(cfg, max_len, shape[1])) == want
    assert tp.cache_block(None, lm.CacheSpec.build(cfg, max_len, shape[1])) is None


@pytest.mark.parametrize("shape", [(2, 1), (1,)])
def test_no_model_axis_or_one_rank_on_it_is_no_plan(shape):
    names = ("data", "model")[:len(shape)]
    assert _plan(get_config("qwen2-0.5b"), _mesh(shape, names)) is None


@pytest.mark.parametrize("n,size,want", [
    (8, 2, [(0, 4), (4, 4)]), (2, 4, [(0, 1), (0, 1), (1, 1), (1, 1)]),
    (1, 2, [(0, 1), (0, 1)])])
def test_block_is_a_ranks_share_or_the_head_it_reads(n, size, want):
    assert [tp.block(n, size, r) for r in range(size)] == want


def test_block_refuses_a_dim_that_splits_neither_way():
    with pytest.raises(ValueError):
        tp.block(3, 2, 0)


@pytest.mark.parametrize("rank", [0, 1])
def test_local_view_takes_each_ranks_halves_of_in_proj(rank):
    """``in_proj``'s [xin | z] columns: rank r takes its DI block of each."""
    cfg = get_config("falcon-mamba-7b").reduced()
    plan = _plan(cfg, _mesh((1, 2), rank=rank))
    params = lm.init_lm(cfg, device="cpu")
    view = tp.local_view(params, plan)
    di = cfg.ssm_d_inner
    w = params["layers"]["ssm"]["in_proj"]
    half = slice(rank * di // 2, (rank + 1) * di // 2)
    want = torch.cat([w[..., half], w[..., di:][..., half]], dim=-1)
    assert torch.equal(view["layers"]["ssm"]["in_proj"], want)
    assert view[tp.KEY] is plan
    assert view["layers"]["ssm"]["x_proj"].shape[1] == di // 2
    assert view["final_norm"] is params["final_norm"]


def test_tp_split_dim_names_a_dim_for_every_rule():
    assert tsh.tp_split_dim("layers.wq") == 2 and tsh.tp_split_dim("layers.wo") == 1
    assert tsh.tp_split_dim("layers.ssm.in_proj") == 2 and tsh.tp_split_dim("mm_proj") == 1
    assert tsh.tp_split_dim("layers.we_down") == 1 and tsh.tp_split_dim("layers.bq") == 1
    for leaf in ("layers.router", "layers.bo", "final_norm", "layers.ln_ssm"):
        assert tsh.tp_split_dim(leaf) is None, leaf
    assert tsh.tp_split_dim("layers.wo_mlp") == 1 and tsh.tp_split_dim("embed") == 0
    assert tsh.tp_split_dim("unembed") == 1 and tsh.tp_split_dim("layers.ln1") is None
    assert tsh.tp_split_dim("layers.ssm.x_proj") == 1
    # the moe family: experts after the layer axis, the shared expert's hidden
    for leaf in ("layers.we_gate", "layers.we_up", "layers.we_down", "layers.ws_down"):
        assert tsh.tp_split_dim(leaf) == 1, leaf
    assert tsh.tp_split_dim("layers.ws_gate") == tsh.tp_split_dim("layers.ws_up") == 2


def test_tp_split_dim_names_the_encdec_leaves():
    """The dense rules name the encoder-decoder's split dims: heads of
    q/k/v [L, d, h, hd] and of wo [L, h, hd, d], the hidden of the MLP's wi
    [L, d, f], bi [L, f] and wo [L, f, d] (the ``wo$`` rule: ``model`` on
    dim 1); none of ``bo`` or a LayerNorm."""
    for stack in ("enc_layers.attn", "dec_layers.self", "dec_layers.cross"):
        for leaf in ("wq", "wk", "wv"):
            assert tsh.tp_split_dim(f"{stack}.{leaf}") == 2, (stack, leaf)
        assert tsh.tp_split_dim(f"{stack}.wo") == 1, stack
    for stack in ("enc_layers.mlp", "dec_layers.mlp"):
        assert tsh.tp_split_dim(f"{stack}.wi") == 2
        assert tsh.tp_split_dim(f"{stack}.bi") == tsh.tp_split_dim(f"{stack}.wo") == 1
        assert tsh.tp_split_dim(f"{stack}.bo") is None
    for leaf in ("enc_layers.ln1.scale", "dec_layers.ln_x.bias", "enc_final.scale",
                 "dec_final.bias"):
        assert tsh.tp_split_dim(leaf) is None, leaf
    assert tsh.tp_split_dim("embed") == 0
