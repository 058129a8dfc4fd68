"""Expert parallelism along ``model`` (the moe family's experts split by
``tensor_parallel.split_plan``, ``layers.moe_layer``'s split path) and the
vlm decoder's dense split, on 4 gloo ranks of this CPU, against the port's
unsharded step and engine and against the JAX package.

One spawn of 4 ranks (``tests/_sharded_ranks.py``, one torch thread each,
joined under a time limit) on a ``("data", "model")`` = (2, 2) mesh trains
two steps (grad_accum 2 a data rank, clipping on) and serves a prefill and
4 greedy decode steps, in f32 at ``reduced()``, of:

* qwen2-moe-a2.7b with 12 routed experts and 1 shared: padded to 16, so
  model rank 0 holds experts 0-7 and rank 1 holds 8-11 and the pad experts
  12-15; heads, the shared expert's hidden and the vocabulary split too;
* phi3.5-moe with 16 experts and no shared expert;
* the qwen2-moe case at ``expert_capacity_factor`` 1.0, where choices drop;
* llava-next-mistral-7b with its 8 patches: the decoder splits as dense,
  ``mm_proj`` is gathered whole, serving runs ``lm.prefill(...,
  patches=)`` and ``lm.decode_step`` on the rank's ``local_view``.

Routes before values.  Near-tied f32 router probabilities route by
rounding, and a split run sums the residual on two ranks, so every value
comparison first asserts that each rank's expert choices equal the
unsharded run's on its rows, and that both model ranks chose alike.

Tolerances, those of ``tests/test_torch_tensor_parallel.py``: against the
port's unsharded step at grad_accum A·D (a data rank's microbatches are
that step's, the moe aux loss included) the loss within 1e-5 relative and
every rank's shard of every param and AdamW moment within 1e-4 of its
leaf's max |value|; against the JAX step the loss within 1e-5 relative and
each param within 1e-4 of its max; serving, every logit within 1e-5 of
the unsharded run's max |logit|.  Leaves that do not split (the router,
norms) train alike on both model ranks, bit for bit.
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
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep

torch.set_num_threads(1)

pytestmark = pytest.mark.dist

CONFIGS = {"qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {"num_experts": 12}),
           "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {"num_experts": 16}),
           "qwen2-moe-a2.7b dropping": ("qwen2-moe-a2.7b", {"num_experts": 12,
                                                            "expert_capacity_factor": 1.0}),
           "llava-next-mistral-7b": ("llava-next-mistral-7b", {})}
MOE = [n for n in CONFIGS if "moe" in n]
ACCUM, DATA = 2, 2
B, S = 8, 32
WEIGHTS = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32)
CLIP = 0.25                 # below every step's gradient norm: clipping is on
PROMPT, GEN = 24, 4
SPAWN_TIMEOUT_S = 240
TOL_STEP, TOL_JAX, TOL_SERVE = 1e-4, 1e-4, 1e-5


def _cfgs(name):
    arch, over = CONFIGS[name]
    return get_config(arch).reduced().replace(**over), jax_config(arch).reduced().replace(**over)


def _jax_tree(name, seed=0, noise=0.05):
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed), _cfgs(name)[1]))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)


def _batch(name, seed):
    cfg = _cfgs(name)[0]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, :5] = -1
    out = {"tokens": tokens, "labels": labels, "weights": WEIGHTS.copy()}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    return out


def _batches(name):
    return [_batch(name, 40), _batch(name, 41)]


PROMPTS = np.random.default_rng(42).integers(0, 256, (2, PROMPT))


def _patches(name):
    cfg = _cfgs(name)[0]
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(43).standard_normal(
        (PROMPTS.shape[0], cfg.num_patches, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the 4 ranks once: {rank: results}."""
    tmp = tmp_path_factory.mktemp("expert_parallel")
    jobs = {}
    for name, (arch, over) in CONFIGS.items():
        jobs[f"train {name}"] = dict(kind="train", arch=arch, overrides=over, accum=ACCUM,
                                     params=_jax_tree(name), batches=_batches(name),
                                     opt={"clip_norm": CLIP}, record=True)
        jobs[f"serve {name}"] = dict(kind="serve", arch=arch, overrides=over,
                                     params=_jax_tree(name), prompts=PROMPTS, gen=GEN,
                                     max_len=PROMPT + GEN + 1 + _cfgs(name)[0].num_patches,
                                     patches=_patches(name))
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


_PORT = {}


def _port_steps(name):
    """The port's unsharded step at grad_accum A·D: (metrics, host state,
    the router's choices in call order)."""
    if name in _PORT:
        return _PORT[name]
    cfg = _cfgs(name)[0].replace(grad_accum=ACCUM * DATA)
    opt = tadamw.AdamWConfig(**{**ranks.OPT, "clip_norm": CLIP})
    step = tstep.make_train_step(cfg, opt, lambda p, b: lm.train_loss(
        lm.nested_params(p), b, cfg))
    state = tstep.init_train_state(convert.lm_params_from_jax(_jax_tree(name), "cpu"), opt)
    metrics, seen = [], {}
    undo = ranks._recording(seen)
    try:
        for b in _batches(name):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        undo()
    host = {n: {k: convert.tensor_to_numpy(v).astype(np.float32) for k, v in d.items()}
            for n, d in (("params", state["params"]), ("mu", state["opt"].mu),
                         ("nu", state["opt"].nu))}
    _PORT[name] = metrics, host, seen.get("routes", [])
    return _PORT[name]


def _assert_train_routes(run, name):
    """Each rank's expert choices equal the unsharded step's on its
    microbatches, and both model ranks of a data rank chose alike.  Data
    rank d's microbatch i is the unsharded step's microbatch d·A + i, and
    each microbatch routes the same number of times (remat recomputes)."""
    if name not in MOE:
        return
    want = _port_steps(name)[2]
    per_mb = len(want) // (2 * ACCUM * DATA)      # 2 steps
    assert per_mb > 0
    pairs = {}
    for rank, out in run.items():
        got = out[f"train {name}"]["seen"]["routes"]
        d = out["coord"]["data"]
        pairs.setdefault(d, []).append(got)
        assert len(got) == 2 * ACCUM * per_mb, (rank, len(got))
        for step in range(2):
            for i in range(ACCUM):
                mb = step * ACCUM * DATA + d * ACCUM + i
                for c in range(per_mb):
                    g = got[(step * ACCUM + i) * per_mb + c]
                    w = want[mb * per_mb + c]
                    assert np.array_equal(g, w), (rank, step, i, c)
    for got in pairs.values():
        assert all(np.array_equal(a, b) for a, b in zip(*got))


@pytest.mark.parametrize("name", MOE)
def test_split_routes_equal_the_unsharded_routes_on_every_rank(run, name):
    _assert_train_routes(run, name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_step_matches_the_unsharded_step(run, name):
    _assert_train_routes(run, name)
    metrics, want, _ = _port_steps(name)
    for out in run.values():
        got = out[f"train {name}"]["metrics"]
        for g, ref in zip(got, metrics):
            assert abs(g["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
            assert g["tokens"] == ref["tokens"]
            assert abs(g["grad_norm"] - ref["grad_norm"]) <= 1e-5 * ref["grad_norm"]
            assert ref["grad_norm"] > CLIP
    ranks.assert_shards(run, f"train {name}", want, TOL_STEP)


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_step_matches_the_jax_step(run, name):
    _assert_train_routes(run, name)
    jcfg = _cfgs(name)[1].replace(grad_accum=ACCUM * DATA)
    jopt = jadamw.AdamWConfig(**{**ranks.OPT, "clip_norm": CLIP})
    fn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    js = jstep.init_train_state(jax.tree.map(jnp.asarray, _jax_tree(name)), jopt)
    losses = []
    for b in _batches(name):
        js, m = fn(js, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    for out in run.values():
        np.testing.assert_allclose([m["loss"] for m in out[f"train {name}"]["metrics"]],
                                   losses, rtol=1e-5)
    want = {"params": _flat_np(jax.tree.map(np.asarray, js["params"]))}
    ranks.assert_shards(run, f"train {name}", want, TOL_JAX, names=("params",))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_router_and_norms_train_alike_on_the_model_ranks(run, name):
    """The router (computed whole: its gates' gradient summed by *f*, the
    aux loss's whole on every rank) and the norms get the same gradient on
    both model ranks: their params and moments agree bit for bit."""
    job = f"train {name}"
    pairs = {}
    for out in run.values():
        pairs.setdefault(out["coord"]["data"], {})[out["coord"]["model"]] = out[job]
    whole = [k for k, spec in run[0][job]["specs"].items()
             if not any(e == "model" or (isinstance(e, tuple) and "model" in e) for e in spec)]
    must = {"layers.ln1", "layers.ln2", "final_norm"}
    must |= {"layers.router"} if name in MOE else set()
    assert must <= set(whole)
    for pair in pairs.values():
        for part in ("params", "mu", "nu"):
            for k in whole:
                assert np.array_equal(pair[0][part][k], pair[1][part][k]), (part, k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rank_0_computes_its_experts_and_heads(run, name):
    """Rank 0's expert einsums see 8 of the 16 padded experts, and its
    attention (K2's plain stand-in on the CPU) 2 of 4 query heads and 1 of
    2 kv heads; in training and in serving."""
    cfg = _cfgs(name)[0]
    for kind in ("train", "serve"):
        seen = run[0][f"{kind} {name}"]["seen"]
        assert set(seen["attention"]) == {(cfg.num_heads // 2, cfg.num_kv_heads // 2)}
        if name in MOE:
            assert set(seen["experts"]) == {lm.padded_experts(cfg) // 2} == {8}


def test_the_capacity_case_drops_choices_and_pad_experts_get_none(run):
    """Within a group of 32 tokens an expert takes at most ``cap`` choices:
    at a capacity factor of 1.0 more choices drop past it than at 4.0; no
    choice goes to a pad expert (rank 1's 12-15)."""
    def dropped(name):
        cfg = _cfgs(name)[0]
        cap = int(np.ceil(S * cfg.top_k * cfg.expert_capacity_factor / cfg.num_experts))
        n = 0
        for r in run[0][f"train {name}"]["seen"]["routes"]:
            counts = np.stack([np.bincount(g.ravel(), minlength=16)
                               for g in r.reshape(-1, S * cfg.top_k)])
            n += int(np.clip(counts - cap, 0, None).sum())
            assert r.max() < cfg.num_experts
        return n

    assert dropped("qwen2-moe-a2.7b dropping") > dropped("qwen2-moe-a2.7b")


def _unsharded_serve(name, tokens):
    """The unsharded engine's (vlm: ``lm.prefill``'s and ``lm.decode_step``'s)
    prefill logits and the logits of decode steps fed ``tokens`` (the split
    run's choices), and the router's choices."""
    cfg = _cfgs(name)[0]
    params = lm.nested_params(convert.lm_params_from_jax(_jax_tree(name), "cpu"))
    max_len = PROMPT + GEN + 1 + cfg.num_patches
    seen = {}
    undo = ranks._recording(seen)
    try:
        with torch.no_grad():
            if cfg.family == "vlm":
                spec = lm.CacheSpec.build(cfg, max_len)
                logits, cache = lm.prefill(params, torch.from_numpy(PROMPTS), cfg, spec,
                                           patches=torch.from_numpy(_patches(name)))
            else:
                eng = ServeEngine(cfg, params, max_len=max_len, device="cpu")
                logits, cache = eng.prefill(PROMPTS)
            out = [logits.numpy()]
            for tok in tokens:
                tok = torch.from_numpy(tok)
                logits, cache = (lm.decode_step(params, cache, tok, cfg, spec)
                                 if cfg.family == "vlm" else eng.step(cache, tok))
                out.append(logits.numpy())
    finally:
        undo()
    return out, seen.get("routes", [])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_serving_matches_the_unsharded_run(run, name):
    cfg = _cfgs(name)[0]
    got0 = run[0][f"serve {name}"]["logits"]
    tokens = [np.argmax(x, axis=-1) for x in got0[:-1]]
    want, routes = _unsharded_serve(name, tokens)
    for rank, out in run.items():
        if name in MOE:          # routes first: every rank's equal the unsharded run's
            got = out[f"serve {name}"]["seen"]["routes"]
            assert len(got) == len(routes) > 0
            assert all(np.array_equal(g, w) for g, w in zip(got, routes)), rank
        got = out[f"serve {name}"]["logits"]
        assert len(got) == GEN + 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape == (PROMPTS.shape[0], cfg.vocab_size)
            err = float(np.abs(g - w).max())
            assert err <= TOL_SERVE * float(np.abs(w).max()), (rank, i, err)
